/* leptonc: native hot loops for the lepton_tpu host runtime.
 *
 * Implements the per-segment token codec (VPX bool coder + adaptive model +
 * neighbor contexts) and the JPEG Huffman scan decode / re-emit, operating
 * on flat arrays shared with Python via ctypes.  Semantics are the proven
 * bit-exact Python implementation in lepton_tpu/{codec,jpeg,model}; layout
 * contracts (model arena, raster planes, handoffs) are identical.
 *
 * Reference parity notes cite dropbox/lepton files (see SURVEY.md).
 *
 * Verbatim copy of lepton_tpu/_native/leptonc.c.  lepton_tpu_torch binds
 * only its JPEG Huffman scan decode (lepton_tpu_torch/_native/__init__.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* ---------------------------------------------------------------- tables */

static const uint8_t ZIGZAG_TO_RASTER[64] = {
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63};

static const uint8_t UNZIGZAG49[49] = {
    9, 10,
    17, 25, 18, 11,
    12, 19, 26, 33, 41, 34,
    27, 20, 13, 14, 21, 28,
    35, 42, 49, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63};

static const uint8_t NONZERO_TO_BIN[50] = {
    0, 1, 2, 3, 4, 4, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7,
    8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9,
    9, 9, 9, 9, 9, 9, 9, 9};

static uint8_t VPX_NORM[256];

__attribute__((constructor))
static void init_vpx_norm(void) {
    VPX_NORM[0] = 0;
    for (int v = 1; v < 256; ++v) {
        int n = 0, x = v;
        while (x < 128) { x <<= 1; ++n; }
        VPX_NORM[v] = (uint8_t)n;
    }
}

/* ------------------------------------------------------ model arena layout
 * Must match lepton_tpu/model/tables.py TABLE_SHAPES order. */
enum {
    MAX_EXPONENT = 11,
    COEF_BITS = 10,
    NNZ_BINS = 10,
    RESID_FLOOR = 7,
    NUMLEN = 12,

    OFF_NZ7x7 = 0,                         /* [2][26][6][32]   */
    OFF_NZ1x8 = OFF_NZ7x7 + 2*26*6*32,     /* [2][8][8][3][4]  */
    OFF_NZ8x1 = OFF_NZ1x8 + 2*8*8*3*4,
    OFF_RESID = OFF_NZ8x1 + 2*8*8*3*4,     /* [2][64][10][10]  */
    OFF_RESID_DC = OFF_RESID + 2*64*10*10, /* [12][10]         */
    OFF_THRESH = OFF_RESID_DC + 12*10,     /* [2][256][8][128] */
    OFF_EXP7 = OFF_THRESH + 2*256*8*128,   /* [2][10][49][12][11] */
    OFF_EXPX = OFF_EXP7 + 2*10*49*12*11,   /* [2][10][15][12][11] */
    OFF_EXPDC = OFF_EXPX + 2*10*15*12*11,  /* [12][17][11]     */
    OFF_SIGN = OFF_EXPDC + 12*17*11,       /* [2][4][12]       */
    ARENA_SIZE = OFF_SIGN + 2*4*12,
};

EXPORT int lepton_arena_size(void) { return ARENA_SIZE; }

/* ------------------------------------------------------------- bool coder */

typedef struct {
    uint32_t lowvalue, range;
    int32_t count;
    uint8_t *buf;
    size_t pos, cap;
    int overflow;
} VpxWriter;

static void vpxw_init(VpxWriter *w, uint8_t *buf, size_t cap) {
    w->lowvalue = 0; w->range = 255; w->count = -24;
    w->buf = buf; w->pos = 0; w->cap = cap; w->overflow = 0;
}

static inline void vpxw_put(VpxWriter *w, int bit, int probability) {
    /* boolwriter.hh:48-118 */
    uint32_t split = 1 + (((w->range - 1) * (uint32_t)probability) >> 8);
    uint32_t lowvalue = w->lowvalue;
    uint32_t range;
    if (bit) { lowvalue += split; range = w->range - split; }
    else range = split;
    int shift = VPX_NORM[range];
    range <<= shift;
    int count = w->count + shift;
    if (count >= 0) {
        int offset = shift - count;
        if ((lowvalue << (offset - 1)) & 0x80000000u) {
            size_t x = w->pos;
            while (x > 0 && w->buf[x - 1] == 0xFF) w->buf[--x] = 0;
            if (x > 0) w->buf[x - 1] += 1;
        }
        if (w->pos < w->cap) w->buf[w->pos++] = (uint8_t)(lowvalue >> (24 - offset));
        else w->overflow = 1;
        lowvalue = (lowvalue << offset) & 0xFFFFFF;
        shift = count;
        count -= 8;
    }
    w->lowvalue = lowvalue << shift;
    w->range = range;
    w->count = count;
}

static size_t vpxw_finish(VpxWriter *w) {
    for (int i = 0; i < 32; ++i) vpxw_put(w, 0, 128);
    if (w->pos && (w->buf[w->pos - 1] & 0xE0) == 0xC0 && w->pos < w->cap)
        w->buf[w->pos++] = 0;
    return w->pos;
}

typedef struct {
    uint64_t value;
    uint32_t range;
    int64_t count;
    const uint8_t *data;
    size_t pos, len;
} VpxReader;

static void vpxr_fill(VpxReader *r) {
    int64_t shift = 48 - r->count;
    if (shift >= 0 && r->pos + 8 <= r->len) {
        /* bulk refill: consume n = shift/8 + 1 bytes in one BE load
         * (same packing as the reference's vpx_reader_fill loop,
         * boolreader.hh:184-258) */
        uint64_t be;
        memcpy(&be, r->data + r->pos, 8);
        be = __builtin_bswap64(be);
        int n = (int)(shift >> 3) + 1;
        int rem = (int)(shift - 8 * (n - 1));
        r->value |= (be >> (64 - 8 * n)) << rem;
        r->pos += (size_t)n;
        r->count += 8 * n;
        return;
    }
    while (shift >= 0) {
        if (r->pos < r->len) {
            r->value |= (uint64_t)r->data[r->pos++] << shift;
            r->count += 8;
            shift -= 8;
        } else {
            r->count += 0x40000000;
            break;
        }
    }
}

static inline int vpxr_get(VpxReader *r, int prob) {
    if (r->count < 0) vpxr_fill(r);
    uint32_t split = (r->range * (uint32_t)prob + (256 - (uint32_t)prob)) >> 8;
    uint64_t bigsplit = (uint64_t)split << 56;
    int bit;
    uint32_t range;
    if (r->value >= bigsplit) { bit = 1; range = r->range - split; r->value -= bigsplit; }
    else { bit = 0; range = split; }
    int shift = VPX_NORM[range];
    r->range = range << shift;
    r->value <<= shift;
    r->count -= shift;
    return bit;
}

static void vpxr_init(VpxReader *r, const uint8_t *data, size_t len) {
    r->value = 0; r->count = -8; r->range = 255;
    r->data = data; r->pos = 0; r->len = len;
    vpxr_fill(r);
    vpxr_get(r, 128); /* marker bit */
}

/* ------------------------------------------------------------ branch model */

typedef struct {
    const uint8_t *data;
    size_t len, pos;      /* pos in 32-bit words */
    uint64_t r0, r1;
} AnsReader;

static inline uint32_t ans_word(AnsReader *r, size_t wpos) {
    size_t off = wpos * 4;
    if (off + 4 <= r->len) {
        uint32_t v;
        memcpy(&v, r->data + off, 4);
        return v;                          /* little-endian host */
    }
    uint32_t v = 0;
    for (size_t i = 0; i < 4 && off + i < r->len; ++i)
        v |= (uint32_t)r->data[off + i] << (8 * i);
    return v;
}

enum { ANS_SCALE_BITS = 8 };
#define RANS64_L (1ull << 31)

static void ans_reader_init(AnsReader *r, const uint8_t *data, size_t len) {
    r->data = data; r->len = len; r->pos = 0;
    r->r0 = (uint64_t)ans_word(r, 0) | ((uint64_t)ans_word(r, 1) << 32);
    r->r1 = (uint64_t)ans_word(r, 2) | ((uint64_t)ans_word(r, 3) << 32);
    r->pos = 4;
}

static inline int ans_get(AnsReader *r, uint32_t prob) {
    /* ans_bool_reader.hh: two interleaved rans64 states, forward decode */
    uint64_t x = r->r0;
    r->r0 = r->r1;
    uint32_t cum = (uint32_t)(x & ((1u << ANS_SCALE_BITS) - 1));
    int bit = cum >= prob;
    uint32_t start = bit ? prob : 0;
    uint32_t freq = bit ? 256 - prob : prob;
    x = freq * (x >> ANS_SCALE_BITS) + cum - start;
    if (x < RANS64_L)
        x = (x << 32) | ans_word(r, r->pos++);
    r->r1 = x;
    return bit;
}

typedef struct {
    uint8_t *arena;   /* [ARENA_SIZE][3] */
    VpxWriter *w;
    VpxReader *r;
    int32_t *sym_idx;   /* when set: record (idx,bit) instead of coding */
    uint8_t *sym_bit;
    int64_t sym_n, sym_cap;
    /* ANS (format v3) mode: buffer (prob,bit) pairs, adv update rule */
    int ans;
    uint16_t *ans_pairs;     /* packed prob | (bit << 8), one per decision */
    int64_t ans_n, ans_cap;
    AnsReader *ar;
} Coder;

static int ans_pairs_grow(Coder *c) {
    if (c->ans_cap < 0) return -1;    /* sticky error: a grow failed */
    int64_t ncap = c->ans_cap ? c->ans_cap * 2 : (1 << 20);
    uint16_t *p = (uint16_t *)realloc(c->ans_pairs, (size_t)ncap * 2);
    if (!p) {
        /* latch the failure: without the sentinel a LATER grow from
         * NULL would succeed and ans_finish would serialize ans_n
         * entries of uninitialized heap into the stream with no error */
        free(c->ans_pairs);
        c->ans_pairs = NULL;
        c->ans_cap = -1;
        return -1;
    }
    c->ans_pairs = p; c->ans_cap = ncap;
    return 0;
}

/* division-free update via a 256x256x2 transition LUT
 * (the reference precomputes the same table, numeric.cc:4-17) */
static uint32_t BRANCH_LUT[256 * 256 * 2];

static void branch_update_slow(uint8_t *b, int obs) {
    /* branch.hh:82-100 record_obs_and_update */
    unsigned fc = b[0], tc = b[1];
    if (obs) {
        if (tc == 0xFF) {
            if (fc == 1) { b[2] = 0; return; }
            unsigned nfc = (1 + fc) >> 1;
            b[0] = (uint8_t)nfc; b[1] = 129;
            b[2] = (uint8_t)((nfc << 8) / (nfc + 129));
        } else {
            b[1] = (uint8_t)(tc + 1);
            b[2] = (uint8_t)((fc << 8) / (fc + tc + 1));
        }
    } else {
        if (fc == 0xFF) {
            if (tc == 1) { b[2] = 255; return; }
            unsigned ntc = (1 + tc) >> 1;
            b[0] = 129; b[1] = (uint8_t)ntc;
            b[2] = (uint8_t)((129u << 8) / (129 + ntc));
        } else {
            b[0] = (uint8_t)(fc + 1);
            b[2] = (uint8_t)(((fc + 1) << 8) / (fc + tc + 1));
        }
    }
}

__attribute__((constructor))
static void init_branch_lut(void) {
    for (int fc = 0; fc < 256; ++fc) {
        for (int tc = 0; tc < 256; ++tc) {
            for (int obs = 0; obs < 2; ++obs) {
                uint8_t b[3] = {(uint8_t)fc, (uint8_t)tc, 0};
                branch_update_slow(b, obs);
                BRANCH_LUT[((fc << 8) | tc) * 2 + obs] =
                    (uint32_t)b[0] | ((uint32_t)b[1] << 8)
                    | ((uint32_t)b[2] << 16);
            }
        }
    }
}

/* adv_record_obs_and_update (branch.hh:66-80): the ANS-backend update
 * rule -- probability always ORed with 1 */
static uint32_t BRANCH_LUT_ADV[256 * 256 * 2];

__attribute__((constructor))
static void init_branch_lut_adv(void) {
    for (int fc = 0; fc < 256; ++fc) {
        for (int tc = 0; tc < 256; ++tc) {
            for (int obs = 0; obs < 2; ++obs) {
                unsigned nfc = fc, ntc = tc;
                if (obs) {
                    ++ntc;
                    if (tc == 0xFF) { nfc = (fc + 1) >> 1; ntc = 129; }
                } else {
                    ++nfc;
                    if (fc == 0xFF) { ntc = (tc + 1) >> 1; nfc = 129; }
                }
                unsigned denom = nfc + ntc;
                unsigned nprob = ((nfc << 8) / (denom ? denom : 1)) | 1;
                BRANCH_LUT_ADV[((fc << 8) | tc) * 2 + obs] =
                    nfc | (ntc << 8) | (nprob << 16);
            }
        }
    }
}

static inline void branch_update_adv(uint8_t *b, int obs) {
    uint32_t v = BRANCH_LUT_ADV[(((uint32_t)b[0] << 8) | b[1]) * 2 + obs];
    b[0] = (uint8_t)v;
    b[1] = (uint8_t)(v >> 8);
    b[2] = (uint8_t)(v >> 16);
}

static uint8_t identity_arena_template[ARENA_SIZE * 3];

/* mutable initial-model template: the LEPTON_COMPRESSION_MODEL hook
 * (load_probability_tables, model.cc:386-397) overwrites this with a
 * trained model; every segment codec memcpys its arena from here */
EXPORT uint8_t *lepton_arena_template(void) { return identity_arena_template; }

__attribute__((constructor))
static void init_identity_arena(void) {
    for (int i = 0; i < ARENA_SIZE; ++i) {
        identity_arena_template[i * 3] = 1;
        identity_arena_template[i * 3 + 1] = 1;
        identity_arena_template[i * 3 + 2] = 128;
    }
}

static inline void branch_update(uint8_t *b, int obs) {
    uint32_t v = BRANCH_LUT[(((uint32_t)b[0] << 8) | b[1]) * 2 + obs];
    b[0] = (uint8_t)v;
    b[1] = (uint8_t)(v >> 8);
    b[2] = (uint8_t)(v >> 16);
}

static inline void coder_put(Coder *c, int bit, int idx) {
    if (__builtin_expect(c->ans, 0)) {
        uint8_t *b = c->arena + idx * 3;
        if (c->ans_n >= c->ans_cap && ans_pairs_grow(c) != 0) return;
        c->ans_pairs[c->ans_n++] = (uint16_t)(b[2] | (bit << 8));
        branch_update_adv(b, bit);
        return;
    }
    if (c->sym_idx) {
        /* symbolization mode: branch indices + bits are independent of the
         * adaptive probabilities, so no model update is needed */
        if (c->sym_n < c->sym_cap) {
            c->sym_idx[c->sym_n] = idx;
            c->sym_bit[c->sym_n] = (uint8_t)bit;
        }
        ++c->sym_n;
        return;
    }
    uint8_t *b = c->arena + idx * 3;
    vpxw_put(c->w, bit, b[2]);
    branch_update(b, bit);
}

static inline int coder_get(Coder *c, int idx) {
    uint8_t *b = c->arena + idx * 3;
    if (__builtin_expect(c->ans, 0)) {
        int bit = ans_get(c->ar, b[2]);
        branch_update_adv(b, bit);
        return bit;
    }
    int bit = vpxr_get(c->r, b[2]);
    branch_update(b, bit);
    return bit;
}

/* ----------------------------------------------------------- color tables */

typedef struct {
    uint16_t quant[64];            /* raster order */
    int32_t icos_lin[64];
    int32_t icos_x[64];
    int32_t icos_y[64];
    uint8_t min_noise_threshold[64];
    /* Lemire exact-division magic for d = 8192*quant[coord] (the Lakhani
     * normalizer, model.hh:1060) and d = quant[0] (DC prediction round):
     * for 0 <= n < 2^32, n/d == mulhi64(M, n) with M = ~0/d + 1. */
    uint64_t lak_div_magic[64];
    uint64_t q0_div_magic;
    int32_t icos_xT[64];           /* icos_xT[i*8+c] = icos_x[c*8+i] */
} ColorTables;

static inline uint32_t fastdiv_u32(uint32_t n, uint64_t magic) {
    /* magic 0 encodes d == 1 (where ~0/d + 1 wraps to 0) */
    return magic ? (uint32_t)(((unsigned __int128)magic * n) >> 64) : n;
}

static inline int32_t fastdiv_i32(int32_t n, uint64_t magic) {
    /* C truncating division for positive divisors */
    uint32_t a = (uint32_t)(n < 0 ? -n : n);
    uint32_t q = fastdiv_u32(a, magic);
    return n < 0 ? -(int32_t)q : (int32_t)q;
}

static const int ICOS_BASE_8192[64] = {
    8192,  8192,  8192,  8192,  8192,  8192,  8192,  8192,
    11363,  9633,  6436,  2260, -2260, -6436, -9633, -11363,
    10703,  4433, -4433, -10703, -10703, -4433,  4433, 10703,
    9633, -2260, -11363, -6436,  6436, 11363,  2260, -9633,
    8192, -8192, -8192,  8192,  8192, -8192, -8192,  8192,
    6436, -11363,  2260,  9633, -9633, -2260, 11363, -6436,
    4433, -10703, 10703, -4433, -4433, 10703, -10703,  4433,
    2260, -6436,  9633, -11363, 11363, -9633,  6436, -2260};

static const int ICOS_IDCT_LINEAR_8192[64] = {
    1024,  1420,  1338,  1204,  1024,   805,   554,   283,
    1024,  1204,   554,  -283, -1024, -1420, -1338,  -805,
    1024,   805,  -554, -1420, -1024,   283,  1338,  1204,
    1024,   283, -1338,  -805,  1024,  1204,  -554, -1420,
    1024,  -283, -1338,   805,  1024, -1204,  -554,  1420,
    1024,  -805,  -554,  1420, -1024,  -283,  1338, -1204,
    1024, -1204,   554,   283, -1024,  1420, -1338,   805,
    1024, -1420,  1338, -1204,  1024,  -805,   554,  -283};

static const uint16_t FREQMAX[64] = {
    1024, 931, 985, 968, 1020, 968, 1020, 1020,
    932, 858, 884, 840, 932, 838, 854, 854,
    985, 884, 871, 875, 985, 878, 871, 854,
    967, 841, 876, 844, 967, 886, 870, 837,
    1020, 932, 985, 967, 1020, 969, 1020, 1020,
    969, 838, 878, 886, 969, 838, 969, 838,
    1020, 854, 871, 870, 1010, 969, 1020, 1020,
    1020, 854, 854, 838, 1020, 838, 1020, 838};

EXPORT void lepton_init_color(ColorTables *ct, const uint16_t *quant_raster) {
    /* model.hh:247-289 set_quantization_table (quant already raster) */
    memcpy(ct->quant, quant_raster, 64 * sizeof(uint16_t));
    for (int pr = 0; pr < 8; ++pr) {
        for (int i = 0; i < 8; ++i) {
            ct->icos_lin[pr * 8 + i] = ICOS_IDCT_LINEAR_8192[pr * 8 + i] * ct->quant[i];
            ct->icos_x[pr * 8 + i] = ICOS_BASE_8192[i * 8] * ct->quant[i * 8 + pr];
            ct->icos_y[pr * 8 + i] = ICOS_BASE_8192[i * 8] * ct->quant[pr * 8 + i];
        }
    }
    for (int coord = 0; coord < 64; ++coord) {
        uint32_t fm = FREQMAX[coord] + ct->quant[coord] - 1;
        if (ct->quant[coord]) fm /= ct->quant[coord];
        int len = 0;
        while ((1u << len) <= fm) ++len;  /* bit_length */
        ct->min_noise_threshold[coord] =
            (uint8_t)(len > RESID_FLOOR ? len - RESID_FLOOR : 0);
        uint64_t d = 8192ull * (ct->quant[coord] ? ct->quant[coord] : 1);
        ct->lak_div_magic[coord] = ~0ull / d + 1;
    }
    ct->q0_div_magic = ~0ull / (ct->quant[0] ? ct->quant[0] : 1) + 1;
    for (int i = 0; i < 8; ++i)
        for (int c = 0; c < 8; ++c)
            ct->icos_xT[i * 8 + c] = ct->icos_x[c * 8 + i];
}

EXPORT int lepton_color_tables_size(void) { return (int)sizeof(ColorTables); }

/* ----------------------------------------------------------------- idct */

enum { W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108, W7 = 565,
       R2 = 181 };

/* int32 wraparound arithmetic written as well-defined uint32 ops (the
 * reference relies on signed overflow wrapping; we make it explicit) */
static inline uint32_t asr32(uint32_t v, int n) {
    return (uint32_t)((int32_t)v >> n);
}
#define IMUL(a, b) ((uint32_t)(a) * (uint32_t)(b))


static void idct_block(const int16_t *coef, const uint16_t *q,
                       int16_t out[64], int ignore_dc) {
    /* idct.cc:36-160 scalar path; all arithmetic in uint32 wraparound */
    uint32_t inter[64];
    for (int y = 0; y < 8; ++y) {
        int y8 = y * 8;
        uint32_t x0 = ((ignore_dc && y == 0) ? 0u
                       : IMUL(coef[y8], q[y8]) << 11) + 128u;
        uint32_t x1 = IMUL(coef[y8 + 4], q[y8 + 4]) << 11;
        uint32_t x2 = IMUL(coef[y8 + 6], q[y8 + 6]);
        uint32_t x3 = IMUL(coef[y8 + 2], q[y8 + 2]);
        uint32_t x4 = IMUL(coef[y8 + 1], q[y8 + 1]);
        uint32_t x5 = IMUL(coef[y8 + 7], q[y8 + 7]);
        uint32_t x6 = IMUL(coef[y8 + 5], q[y8 + 5]);
        uint32_t x7 = IMUL(coef[y8 + 3], q[y8 + 3]);
        uint32_t x8 = IMUL(W7, x4 + x5);
        x4 = x8 + IMUL(W1 - W7, x4);
        x5 = x8 - IMUL(W1 + W7, x5);
        x8 = IMUL(W3, x6 + x7);
        x6 = x8 - IMUL(W3 - W5, x6);
        x7 = x8 - IMUL(W3 + W5, x7);
        x8 = x0 + x1;
        x0 -= x1;
        x1 = IMUL(W6, x3 + x2);
        x2 = x1 - IMUL(W2 + W6, x2);
        x3 = x1 + IMUL(W2 - W6, x3);
        x1 = x4 + x6;
        x4 -= x6;
        x6 = x5 + x7;
        x5 -= x7;
        x7 = x8 + x3;
        x8 -= x3;
        x3 = x0 + x2;
        x0 -= x2;
        x2 = asr32(IMUL(R2, x4 + x5) + 128u, 8);
        x4 = asr32(IMUL(R2, x4 - x5) + 128u, 8);
        inter[y8 + 0] = asr32(x7 + x1, 8);
        inter[y8 + 1] = asr32(x3 + x2, 8);
        inter[y8 + 2] = asr32(x0 + x4, 8);
        inter[y8 + 3] = asr32(x8 + x6, 8);
        inter[y8 + 4] = asr32(x8 - x6, 8);
        inter[y8 + 5] = asr32(x0 - x4, 8);
        inter[y8 + 6] = asr32(x3 - x2, 8);
        inter[y8 + 7] = asr32(x7 - x1, 8);
    }
    for (int x = 0; x < 8; ++x) {
        uint32_t y0 = (inter[x] << 8) + 8192u;
        uint32_t y1 = inter[32 + x] << 8;
        uint32_t y2 = inter[48 + x];
        uint32_t y3 = inter[16 + x];
        uint32_t y4 = inter[8 + x];
        uint32_t y5 = inter[56 + x];
        uint32_t y6 = inter[40 + x];
        uint32_t y7 = inter[24 + x];
        uint32_t y8 = IMUL(W7, y4 + y5) + 4u;
        y4 = asr32(y8 + IMUL(W1 - W7, y4), 3);
        y5 = asr32(y8 - IMUL(W1 + W7, y5), 3);
        y8 = IMUL(W3, y6 + y7) + 4u;
        y6 = asr32(y8 - IMUL(W3 - W5, y6), 3);
        y7 = asr32(y8 - IMUL(W3 + W5, y7), 3);
        y8 = y0 + y1;
        y0 -= y1;
        y1 = IMUL(W6, y3 + y2) + 4u;
        y2 = asr32(y1 - IMUL(W2 + W6, y2), 3);
        y3 = asr32(y1 + IMUL(W2 - W6, y3), 3);
        y1 = y4 + y6;
        y4 -= y6;
        y6 = y5 + y7;
        y5 -= y7;
        y7 = y8 + y3;
        y8 -= y3;
        y3 = y0 + y2;
        y0 -= y2;
        y2 = asr32(IMUL(R2, y4 + y5) + 128u, 8);
        y4 = asr32(IMUL(R2, y4 - y5) + 128u, 8);
        out[x] = (int16_t)asr32(y7 + y1, 11);
        out[8 + x] = (int16_t)asr32(y3 + y2, 11);
        out[16 + x] = (int16_t)asr32(y0 + y4, 11);
        out[24 + x] = (int16_t)asr32(y8 + y6, 11);
        out[32 + x] = (int16_t)asr32(y8 - y6, 11);
        out[40 + x] = (int16_t)asr32(y0 - y4, 11);
        out[48 + x] = (int16_t)asr32(y3 - y2, 11);
        out[56 + x] = (int16_t)asr32(y7 - y1, 11);
    }
}

/* ----------------------------------------------------------- block codec */

typedef struct {
    uint8_t nz;
    int16_t edge[16];    /* [0..8) vertical, [8..16) horizontal */
} Summary;

static inline int bit_length_u(unsigned v) {
    return v ? 32 - __builtin_clz(v) : 0;
}

static inline int bsr_prior(int best_prior) {
    int v = best_prior < 0 ? -best_prior : best_prior;
    if (v > 1023) v = 1023;
    return bit_length_u((unsigned)v);
}

__attribute__((unused))
static int compute_aavrg(int coord, const int16_t *left, const int16_t *above,
                         const int16_t *aboveleft) {
    /* model.hh:852-871 (uint16 truncation included) */
    int total = 0;
    if (left) total += abs(left[coord]);
    if (above) total += abs(above[coord]);
    if (left && above) {
        total *= 13;
        total += 6 * abs(aboveleft[coord]);
        return (total & 0xFFFF) >> 5;
    }
    return total;
}

/* Whole-block context precomputation (the reference SIMD-izes the same
 * quantities per block, model.hh:895-924 / :928-1031; here the per-block
 * arrays make the loops vectorizable and branch-free). */

static void compute_aavrg_block(uint16_t out[64], const int16_t *left,
                                const int16_t *above,
                                const int16_t *aboveleft) {
    if (left && above) {
        for (int i = 0; i < 64; ++i) {
            uint16_t t = (uint16_t)(abs(left[i]) + abs(above[i]));
            t = (uint16_t)(t * 13 + 6 * (uint16_t)abs(aboveleft[i]));
            out[i] = (uint16_t)(t >> 5);
        }
    } else if (left) {
        for (int i = 0; i < 64; ++i) out[i] = (uint16_t)abs(left[i]);
    } else if (above) {
        for (int i = 0; i < 64; ++i) out[i] = (uint16_t)abs(above[i]);
    } else {
        memset(out, 0, 64 * sizeof(uint16_t));
    }
}

/* All 14 Lakhani predictions for one block: lak_h[c] (c=1..7, row-0 edge,
 * needs `above`), lak_v[r] (r=1..7, col-0 edge, needs `left`).  Both use
 * only the 7x7 interior of `here`, so on decode they are computed right
 * after the interior coefficients, before the edges (decoder.cc:29-142
 * computes them lazily at the same point). */
static void compute_lak_h(int32_t lak_h[8], const int16_t *here,
                          const int16_t *above, const ColorTables *ct) {
    if (above) {
        uint32_t pred[8];
        for (int c = 0; c < 8; ++c)
            pred[c] = IMUL(above[c], ct->icos_xT[c]);
        for (int i = 1; i < 8; ++i) {
            const int32_t *ic = ct->icos_xT + i * 8;
            const int16_t *hr = here + i * 8;
            const int16_t *ar = above + i * 8;
            if (i & 1)
                for (int c = 0; c < 8; ++c)
                    pred[c] -= IMUL(ic[c], hr[c] + ar[c]);
            else
                for (int c = 0; c < 8; ++c)
                    pred[c] -= IMUL(ic[c], hr[c] - ar[c]);
        }
        lak_h[0] = 0;
        for (int c = 1; c < 8; ++c)
            lak_h[c] = fastdiv_i32((int32_t)pred[c], ct->lak_div_magic[c]);
    } else {
        memset(lak_h, 0, 8 * sizeof(int32_t));
    }
}

static void compute_lak_v(int32_t lak_v[8], const int16_t *here,
                          const int16_t *left, const ColorTables *ct) {
    if (left) {
        for (int r = 1; r < 8; ++r) {
            const int32_t *ic = ct->icos_y + r * 8;
            const int16_t *hr = here + r * 8;
            const int16_t *lr = left + r * 8;
            uint32_t pred = IMUL(lr[0], ic[0]);
            for (int i = 1; i < 8; ++i) {
                int32_t sv = (i & 1) ? (int32_t)(hr[i] + lr[i])
                                     : (int32_t)(hr[i] - lr[i]);
                pred -= IMUL(ic[i], sv);
            }
            lak_v[r] = fastdiv_i32((int32_t)pred, ct->lak_div_magic[r * 8]);
        }
        lak_v[0] = 0;
    } else {
        memset(lak_v, 0, 8 * sizeof(int32_t));
    }
}

__attribute__((unused))
static int compute_lak(int coord, const int16_t *here, const int16_t *above,
                       const int16_t *left, const ColorTables *ct) {
    /* model.hh:1033-1071; the final normalizer icos[0] is 8192*quant[coord]
     * for both directions, divided exactly via the precomputed magic */
    int32_t pred;
    if ((coord & 7) && coord < 8) {
        if (!above) return 0;
        const int32_t *icos = ct->icos_x + coord * 8;
        pred = above[coord] * icos[0];
        for (int i = 1; i < 8; ++i) {
            int k = coord + i * 8;
            int sign = (i & 1) ? 1 : -1;
            pred -= icos[i] * (here[k] + sign * above[k]);
        }
    } else if ((coord & 7) == 0 && coord >= 8) {
        if (!left) return 0;
        const int32_t *icos = ct->icos_y + coord;
        pred = left[coord] * icos[0];
        for (int i = 1; i < 8; ++i) {
            int k = coord + i;
            int sign = (i & 1) ? 1 : -1;
            pred -= icos[i] * (here[k] + sign * left[k]);
        }
    } else {
        return 0;
    }
    return fastdiv_i32(pred, ct->lak_div_magic[coord]);
}

static int adv_predict_dc_pix(const int16_t *here, const ColorTables *ct,
                              const Summary *left_s, const Summary *above_s,
                              int *uncertainty, int *uncertainty2,
                              int16_t pixels[64]) {
    /* model.hh:674-784 */
    idct_block(here, ct->quant, pixels, 1);
    int avgmed = 0;
    *uncertainty = 0;
    *uncertainty2 = 0;
    if (left_s || above_s) {
        int16_t est[16];
        int n = 0;
        int avg_h = 0, avg_v = 0;
        if (left_s) {
            for (int i = 0; i < 8; ++i) {
                int a = pixels[i << 3] + 1024;
                int pd = pixels[i << 3] - pixels[(i << 3) + 1];
                int b = left_s->edge[i] - (pd / 2);
                est[n++] = (int16_t)(b - a);
            }
        }
        if (above_s) {
            for (int i = 0; i < 8; ++i) {
                int a = pixels[i] + 1024;
                int pd = pixels[i] - pixels[i + 8];
                int b = above_s->edge[i + 8] - (pd / 2);
                est[n++] = (int16_t)(b - a);
            }
        }
        int mn = est[0], mx = est[0];
        for (int i = 0; i < n; ++i) {
            if (est[i] < mn) mn = est[i];
            if (est[i] > mx) mx = est[i];
            if (i < 8) avg_h += est[i];
            else avg_v += est[i];
        }
        if (n == 8) avg_v = avg_h;
        int overall = (avg_h + avg_v) >> 1;
        avgmed = overall;
        *uncertainty = (mx - mn) >> 3;
        avg_h -= overall;
        avg_v -= overall;
        int far_afield = avg_v;
        if (abs(avg_h) < abs(avg_v)) far_afield = avg_h;
        *uncertainty2 = far_afield >> 3;
    }
    return (fastdiv_i32(avgmed, ct->q0_div_magic) + 4) >> 3;
}

static void set_summary(Summary *s, const int16_t *pixels, int q0, int dc) {
    /* block_context.hh set_vertical / set_horizontal */
    for (int i = 0; i < 8; ++i) {
        int cur = pixels[i * 8 + 7];
        int delta = cur - pixels[i * 8 + 6];
        s->edge[i] = (int16_t)(dc * q0 + cur + 1024 + delta / 2);
    }
    for (int i = 0; i < 8; ++i) {
        int cur = pixels[56 + i];
        int delta = cur - pixels[48 + i];
        s->edge[8 + i] = (int16_t)(dc * q0 + cur + 1024 + delta / 2);
    }
}

static int adv_predict_or_unpredict_dc(int saved_dc, int recover, int pred) {
    int max_value = 1 << (MAX_EXPONENT - 1);
    int adjustment = 2 * max_value + 1;
    int v = saved_dc + (recover ? pred : -pred);
    if (v < -max_value) v += adjustment;
    if (v > max_value) v -= adjustment;
    return v;
}

/* strides for exp/residual tables */
enum {
    S_NZ7_CI = 26 * 6 * 32, S_NZ7_BIN = 6 * 32, S_NZ7_IDX = 32,
    S_NZE_CI = 8 * 8 * 3 * 4, S_NZE_EOB = 8 * 3 * 4, S_NZE_BIN = 3 * 4,
    S_NZE_IDX = 4,
    S_RES_CI = 64 * 10 * 10, S_RES_BAND = 10 * 10, S_RES_BIN = 10,
    S_RDC_LEN = 10,
    S_TH_CI = 256 * 8 * 128, S_TH_ABS = 8 * 128, S_TH_EXP = 128,
    S_E7_CI = 10 * 49 * 12 * 11, S_E7_BIN = 49 * 12 * 11, S_E7_ZZ = 12 * 11,
    S_E7_BSR = 11,
    S_EX_CI = 10 * 15 * 12 * 11, S_EX_BIN = 15 * 12 * 11, S_EX_ZZ = 12 * 11,
    S_EX_BSR = 11,
    S_EDC_LEN = 17 * 11, S_EDC_OFF = 11,
    S_SG_CI = 4 * 12, S_SG_CTX1 = 12,
};

typedef struct {
    const ColorTables *ct;
    int ci;                  /* color index (0 luma, 1 chroma) */
} CompCtx;

static void encode_edge(Coder *c, const CompCtx *cc, const int16_t *here,
                        const int16_t *neighbor,
                        int nz7x7, int est_eob, int horizontal, int *err) {
    int ci = cc->ci;
    int num_nonzeros_edge = 0;
    int delta, zig15, nz_base;
    if (horizontal) {
        for (int k = 1; k < 8; ++k) if (here[k]) ++num_nonzeros_edge;
        delta = 1; zig15 = 0;
        nz_base = OFF_NZ8x1 + ci * S_NZE_CI + est_eob * S_NZE_EOB
            + ((nz7x7 + 3) / 7) * S_NZE_BIN;
    } else {
        for (int k = 1; k < 8; ++k) if (here[k * 8]) ++num_nonzeros_edge;
        delta = 8; zig15 = 7;
        nz_base = OFF_NZ1x8 + ci * S_NZE_CI + est_eob * S_NZE_EOB
            + ((nz7x7 + 3) / 7) * S_NZE_BIN;
    }
    int so_far = 0;
    for (int i = 2; i >= 0; --i) {
        int bit = (num_nonzeros_edge >> i) & 1;
        coder_put(c, bit, nz_base + i * S_NZE_IDX + so_far);
        so_far = (so_far << 1) | bit;
    }
    int32_t lak[8];
    if (num_nonzeros_edge) {
        if (horizontal) compute_lak_h(lak, here, neighbor, cc->ct);
        else compute_lak_v(lak, here, neighbor, cc->ct);
    }
    int coord = delta;
    for (int lane = 0; lane < 7 && num_nonzeros_edge; ++lane, coord += delta) {
        int best_prior = lak[horizontal ? coord : (coord >> 3)];
        int bsr = bsr_prior(best_prior);
        int exp_slice = OFF_EXPX + ci * S_EX_CI + num_nonzeros_edge * S_EX_BIN
            + (zig15 + lane) * S_EX_ZZ + bsr * S_EX_BSR;
        int coef = here[coord];
        unsigned abs_coef = (unsigned)(coef < 0 ? -coef : coef);
        int length = bit_length_u(abs_coef);
        for (int i = 0; i < MAX_EXPONENT; ++i) {
            int cur_bit = length != i;
            coder_put(c, cur_bit, exp_slice + i);
            if (!cur_bit) break;
        }
        if (length > MAX_EXPONENT) { *err = 2; return; }
        if (coef) {
            int mt = cc->ct->min_noise_threshold[coord];
            int ctx1 = best_prior == 0 ? 0 : (best_prior > 0 ? 1 : 2);
            coder_put(c, coef >= 0, OFF_SIGN + ci * S_SG_CI + ctx1 * S_SG_CTX1 + bsr);
            --num_nonzeros_edge;
            if (length > 1) {
                int i = length - 2;
                if (i >= mt) {
                    int abs_prior = best_prior < 0 ? -best_prior : best_prior;
                    int t1 = abs_prior >> mt;
                    if (t1 > 255) t1 = 255;
                    int t2 = length - mt;
                    if (t2 > RESID_FLOOR) t2 = RESID_FLOOR;
                    int th_slice = OFF_THRESH + ci * S_TH_CI + t1 * S_TH_ABS
                        + t2 * S_TH_EXP;
                    int esf = 1;
                    for (; i >= mt; --i) {
                        int cur_bit = (abs_coef >> i) & 1;
                        coder_put(c, cur_bit, th_slice + esf);
                        esf = (esf << 1) | cur_bit;
                        if (esf > 127) esf = 127;
                    }
                }
                int res_slice = OFF_RESID + ci * S_RES_CI + coord * S_RES_BAND
                    + (num_nonzeros_edge + 1) * S_RES_BIN;
                for (; i >= 0; --i)
                    coder_put(c, (abs_coef >> i) & 1, res_slice + i);
            }
        }
    }
}

static void decode_edge(Coder *c, const CompCtx *cc, int16_t *here,
                        const int16_t *neighbor,
                        int nz7x7, int est_eob, int horizontal, int *err) {
    int ci = cc->ci;
    int delta, zig15, nz_base;
    if (horizontal) {
        delta = 1; zig15 = 0;
        nz_base = OFF_NZ8x1 + ci * S_NZE_CI + est_eob * S_NZE_EOB
            + ((nz7x7 + 3) / 7) * S_NZE_BIN;
    } else {
        delta = 8; zig15 = 7;
        nz_base = OFF_NZ1x8 + ci * S_NZE_CI + est_eob * S_NZE_EOB
            + ((nz7x7 + 3) / 7) * S_NZE_BIN;
    }
    int num_nonzeros_edge = 0;
    int so_far = 0;
    for (int i = 2; i >= 0; --i) {
        int bit = coder_get(c, nz_base + i * S_NZE_IDX + so_far);
        num_nonzeros_edge |= bit << i;
        so_far = (so_far << 1) | bit;
    }
    if (num_nonzeros_edge > 7) { *err = 1; return; }
    int32_t lak[8];
    if (num_nonzeros_edge) {
        if (horizontal) compute_lak_h(lak, here, neighbor, cc->ct);
        else compute_lak_v(lak, here, neighbor, cc->ct);
    }
    int coord = delta;
    for (int lane = 0; lane < 7 && num_nonzeros_edge; ++lane, coord += delta) {
        int best_prior = lak[horizontal ? coord : (coord >> 3)];
        int bsr = bsr_prior(best_prior);
        int exp_slice = OFF_EXPX + ci * S_EX_CI + num_nonzeros_edge * S_EX_BIN
            + (zig15 + lane) * S_EX_ZZ + bsr * S_EX_BSR;
        int length = 0;
        while (length != MAX_EXPONENT) {
            if (!coder_get(c, exp_slice + length)) break;
            ++length;
        }
        if (length) {
            int mt = cc->ct->min_noise_threshold[coord];
            int ctx1 = best_prior == 0 ? 0 : (best_prior > 0 ? 1 : 2);
            int neg = !coder_get(c, OFF_SIGN + ci * S_SG_CI + ctx1 * S_SG_CTX1 + bsr);
            int coef = 1 << (length - 1);
            --num_nonzeros_edge;
            if (length > 1) {
                int i = length - 2;
                if (i >= mt) {
                    int abs_prior = best_prior < 0 ? -best_prior : best_prior;
                    int t1 = abs_prior >> mt;
                    if (t1 > 255) t1 = 255;
                    int t2 = length - mt;
                    if (t2 > RESID_FLOOR) t2 = RESID_FLOOR;
                    int th_slice = OFF_THRESH + ci * S_TH_CI + t1 * S_TH_ABS
                        + t2 * S_TH_EXP;
                    int dsf = 1;
                    for (; i >= mt; --i) {
                        int cur_bit = coder_get(c, th_slice + dsf);
                        coef |= cur_bit << i;
                        dsf = (dsf << 1) | cur_bit;
                        if (dsf > 127) dsf = 127;
                    }
                }
                int res_slice = OFF_RESID + ci * S_RES_CI + coord * S_RES_BAND
                    + (num_nonzeros_edge + 1) * S_RES_BIN;
                for (; i >= 0; --i)
                    coef |= coder_get(c, res_slice + i) << i;
            }
            here[coord] = (int16_t)(neg ? -coef : coef);
        }
    }
}

static void encode_block(Coder *c, const CompCtx *cc, const int16_t *here,
                         const int16_t *left, const int16_t *above,
                         const int16_t *aboveleft, const Summary *left_s,
                         const Summary *above_s, Summary *cur_s, int *err) {
    int ci = cc->ci;
    int nz7x7 = 0;
    for (int r = 1; r < 8; ++r)
        for (int col = 1; col < 8; ++col)
            if (here[r * 8 + col]) ++nz7x7;
    cur_s->nz = (uint8_t)nz7x7;
    uint16_t aavrg_arr[64];
    if (nz7x7) compute_aavrg_block(aavrg_arr, left, above, aboveleft);

    int nz_ctx;
    if (above_s && left_s) nz_ctx = (above_s->nz + left_s->nz + 2) / 4;
    else if (above_s) nz_ctx = (above_s->nz + 1) / 2;
    else if (left_s) nz_ctx = (left_s->nz + 1) / 2;
    else nz_ctx = 0;
    int nz_base = OFF_NZ7x7 + ci * S_NZ7_CI + NONZERO_TO_BIN[nz_ctx] * S_NZ7_BIN;
    int so_far = 0;
    for (int index = 5; index >= 0; --index) {
        int bit = (nz7x7 >> index) & 1;
        coder_put(c, bit, nz_base + index * S_NZ7_IDX + so_far);
        so_far = (so_far << 1) | bit;
    }

    int eob_x = 0, eob_y = 0;
    int nz_left = nz7x7;
    for (int zz = 0; zz < 49 && nz_left; ++zz) {
        int coord = UNZIGZAG49[zz];
        int coef = here[coord];
        unsigned abs_coef = (unsigned)(coef < 0 ? -coef : coef);
        int length = bit_length_u(abs_coef);
        int bsr = bsr_prior(aavrg_arr[coord]);
        int nnz_bin = NONZERO_TO_BIN[nz_left];
        int exp_slice = OFF_EXP7 + ci * S_E7_CI + nnz_bin * S_E7_BIN
            + zz * S_E7_ZZ + bsr * S_E7_BSR;
        for (int i = 0; i < MAX_EXPONENT; ++i) {
            int cur_bit = length != i;
            coder_put(c, cur_bit, exp_slice + i);
            if (!cur_bit) break;
        }
        if (length > MAX_EXPONENT) { *err = 2; return; }
        if (length) {
            coder_put(c, coef >= 0, OFF_SIGN + ci * S_SG_CI);
            --nz_left;
            int bx = coord & 7, by = coord >> 3;
            if (bx > eob_x) eob_x = bx;
            if (by > eob_y) eob_y = by;
        }
        if (length > 1) {
            int res_slice = OFF_RESID + ci * S_RES_CI + coord * S_RES_BAND
                + nnz_bin * S_RES_BIN;
            for (int i = length - 2; i >= 0; --i)
                coder_put(c, (abs_coef >> i) & 1, res_slice + i);
        }
    }

    encode_edge(c, cc, here, above, nz7x7, eob_x, 1, err);
    if (*err) return;
    encode_edge(c, cc, here, left, nz7x7, eob_y, 0, err);
    if (*err) return;

    int uncertainty, uncertainty2;
    int16_t pixels[64];
    int pred = adv_predict_dc_pix(here, cc->ct, left_s, above_s,
                                  &uncertainty, &uncertainty2, pixels);
    int dc = here[0];
    int coef = adv_predict_or_unpredict_dc(dc, 0, pred);
    unsigned abs_coef = (unsigned)(coef < 0 ? -coef : coef);
    int length = bit_length_u(abs_coef);
    int len_mxm = bit_length_u((unsigned)abs(uncertainty));
    int len_off = bit_length_u((unsigned)abs(uncertainty2));
    int exp_slice = OFF_EXPDC
        + (len_mxm < NUMLEN - 1 ? len_mxm : NUMLEN - 1) * S_EDC_LEN
        + (len_off < 16 ? len_off : 16) * S_EDC_OFF;
    for (int i = 0; i < MAX_EXPONENT; ++i) {
        int cur_bit = length != i;
        coder_put(c, cur_bit, exp_slice + i);
        if (!cur_bit) break;
    }
    if (length > MAX_EXPONENT) { *err = 2; return; }
    if (length) {
        int sctx = uncertainty2 >= 0 ? (uncertainty2 == 0 ? 3 : 2) : 1;
        coder_put(c, coef >= 0, OFF_SIGN + ci * S_SG_CI + sctx);
    }
    if (length > 1) {
        int res_slice = OFF_RESID_DC
            + (len_mxm < NUMLEN - 1 ? len_mxm : NUMLEN - 1) * S_RDC_LEN;
        for (int i = length - 2; i >= 0; --i)
            coder_put(c, (abs_coef >> i) & 1, res_slice + i);
    }
    set_summary(cur_s, pixels, cc->ct->quant[0], dc);
}

static void decode_block(Coder *c, const CompCtx *cc, int16_t *here,
                         const int16_t *left, const int16_t *above,
                         const int16_t *aboveleft, const Summary *left_s,
                         const Summary *above_s, Summary *cur_s, int *err) {
    int ci = cc->ci;
    memset(here, 0, 64 * sizeof(int16_t));
    int nz_ctx;
    if (above_s && left_s) nz_ctx = (above_s->nz + left_s->nz + 2) / 4;
    else if (above_s) nz_ctx = (above_s->nz + 1) / 2;
    else if (left_s) nz_ctx = (left_s->nz + 1) / 2;
    else nz_ctx = 0;
    int nz_base = OFF_NZ7x7 + ci * S_NZ7_CI + NONZERO_TO_BIN[nz_ctx] * S_NZ7_BIN;
    int nz7x7 = 0;
    int so_far = 0;
    for (int index = 5; index >= 0; --index) {
        int bit = coder_get(c, nz_base + index * S_NZ7_IDX + so_far);
        nz7x7 |= bit << index;
        so_far = (so_far << 1) | bit;
    }
    if (nz7x7 > 49) { *err = 1; return; }
    uint16_t aavrg_arr[64];
    if (nz7x7) compute_aavrg_block(aavrg_arr, left, above, aboveleft);

    int eob_x = 0, eob_y = 0;
    int nz_left = nz7x7;
    for (int zz = 0; zz < 49 && nz_left; ++zz) {
        int coord = UNZIGZAG49[zz];
        int bsr = bsr_prior(aavrg_arr[coord]);
        int nnz_bin = NONZERO_TO_BIN[nz_left];
        int exp_slice = OFF_EXP7 + ci * S_E7_CI + nnz_bin * S_E7_BIN
            + zz * S_E7_ZZ + bsr * S_E7_BSR;
        int length = 0;
        while (length != MAX_EXPONENT) {
            if (!coder_get(c, exp_slice + length)) break;
            ++length;
        }
        if (length) {
            int neg = !coder_get(c, OFF_SIGN + ci * S_SG_CI);
            --nz_left;
            int bx = coord & 7, by = coord >> 3;
            if (bx > eob_x) eob_x = bx;
            if (by > eob_y) eob_y = by;
            int coef = 1 << (length - 1);
            if (length > 1) {
                int res_slice = OFF_RESID + ci * S_RES_CI + coord * S_RES_BAND
                    + nnz_bin * S_RES_BIN;
                for (int i = length - 2; i >= 0; --i)
                    coef |= coder_get(c, res_slice + i) << i;
            }
            here[coord] = (int16_t)(neg ? -coef : coef);
        }
    }

    decode_edge(c, cc, here, above, nz7x7, eob_x, 1, err);
    if (*err) return;
    decode_edge(c, cc, here, left, nz7x7, eob_y, 0, err);
    if (*err) return;

    int uncertainty, uncertainty2;
    int16_t pixels[64];
    int pred = adv_predict_dc_pix(here, cc->ct, left_s, above_s,
                                  &uncertainty, &uncertainty2, pixels);
    int len_mxm = bit_length_u((unsigned)abs(uncertainty));
    int len_off = bit_length_u((unsigned)abs(uncertainty2));
    int exp_slice = OFF_EXPDC
        + (len_mxm < NUMLEN - 1 ? len_mxm : NUMLEN - 1) * S_EDC_LEN
        + (len_off < 16 ? len_off : 16) * S_EDC_OFF;
    int length = 0;
    while (length < MAX_EXPONENT) {
        if (!coder_get(c, exp_slice + length)) break;
        ++length;
    }
    int coef = 0;
    if (length) {
        int sctx = uncertainty2 >= 0 ? (uncertainty2 == 0 ? 3 : 2) : 1;
        int neg = !coder_get(c, OFF_SIGN + ci * S_SG_CI + sctx);
        coef = 1 << (length - 1);
        if (length > 1) {
            int res_slice = OFF_RESID_DC
                + (len_mxm < NUMLEN - 1 ? len_mxm : NUMLEN - 1) * S_RDC_LEN;
            for (int i = length - 2; i >= 0; --i)
                coef |= coder_get(c, res_slice + i) << i;
        }
        if (neg) coef = -coef;
    }
    int dc = adv_predict_or_unpredict_dc(coef, 1, pred);
    here[0] = (int16_t)dc;
    cur_s->nz = (uint8_t)nz7x7;
    set_summary(cur_s, pixels, cc->ct->quant[0], dc);
}

/* ------------------------------------------------------- segment drivers */

typedef struct {
    int16_t *planes[4];
    int32_t widths[4], heights[4];
    int32_t comp_sizes[4];
    int32_t max_coded_heights[4];
    int ncomp, nslots, mcuv;
    const ColorTables *colors[4];
    /* plane row indexing mask: 0x7fffffff = full framebuffer; small
       power-of-two-minus-1 = sliding-window ring (the reference's 2-row
       memory-optimized mode, block_based_image.hh:52-121 off_y) */
    int32_t row_mask[4];
} Image;

typedef struct {
    int min_row_luma_y, next_row_luma_y, luma_y, component, curr_y;
    int last_row_to_complete_mcu, skip, done;
} RowSpec;

static RowSpec row_spec_from_index(int decode_index, const Image *im) {
    /* lepton_codec.hh:41-100; nslots = NumBlockTypes (3, or 4 for CMYK) */
    int nslots = im->nslots;
    int cm[4], mcu_multiple = 0;
    for (int i = 0; i < nslots; ++i) {
        cm[i] = im->heights[i] ? im->heights[i] / im->mcuv : 0;
        mcu_multiple += cm[i];
    }
    int mcu_row = decode_index / mcu_multiple;
    int place = decode_index - mcu_row * mcu_multiple;
    RowSpec spec;
    memset(&spec, 0, sizeof(spec));
    spec.min_row_luma_y = mcu_row * cm[0];
    spec.next_row_luma_y = spec.min_row_luma_y + cm[0];
    spec.luma_y = spec.min_row_luma_y;
    spec.component = nslots;
    for (int i = nslots - 1;; --i) {
        if (place < cm[i]) {
            spec.component = i;
            spec.curr_y = mcu_row * cm[i] + place;
            spec.last_row_to_complete_mcu = (place + 1 == cm[i] && i == 0);
            if (spec.curr_y >= im->max_coded_heights[i]) {
                spec.skip = 1;
                spec.done = 1;
                for (int j = 0; j < nslots - 1; ++j)
                    if (mcu_row * cm[j] < im->max_coded_heights[j])
                        spec.done = 0;
            }
            if (i == 0) spec.luma_y = spec.curr_y;
            break;
        }
        place -= cm[i];
        if (i == 0) { spec.skip = 1; spec.done = 1; break; }
    }
    return spec;
}

typedef struct {
    uint8_t *arena;
    Summary *rings[4];    /* 2*width entries per component */
    int is_top_row[4];
} SegState;

static void process_row(const Image *im, SegState *st, Coder *c, int comp,
                        int y, int encode, int *err) {
    int w = im->widths[comp];
    CompCtx cc = { im->colors[comp], comp == 0 ? 0 : 1 };
    int top = st->is_top_row[comp];
    st->is_top_row[comp] = 0;
    Summary *cur = st->rings[comp] + (y & 1) * w;
    Summary *abv = st->rings[comp] + (1 - (y & 1)) * w;
    int32_t rmask = im->row_mask[comp];
    int16_t *row = im->planes[comp] + (size_t)(y & rmask) * w * 64;
    int16_t *above_row = top ? NULL
        : im->planes[comp] + (size_t)((y - 1) & rmask) * w * 64;
    int size_limit = im->comp_sizes[comp];
    int base = y * w;
    for (int x = 0; x < w; ++x) {
        const int16_t *left = x > 0 ? row + (size_t)(x - 1) * 64 : NULL;
        const int16_t *above = above_row ? above_row + (size_t)x * 64 : NULL;
        const int16_t *aboveleft =
            (above_row && x > 0) ? above_row + (size_t)(x - 1) * 64 : NULL;
        const Summary *left_s = x > 0 ? cur + (x - 1) : NULL;
        const Summary *above_s = top ? NULL : abv + x;
        if (encode) {
            encode_block(c, &cc, row + (size_t)x * 64, left, above, aboveleft,
                         left_s, above_s, cur + x, err);
            if (*err) return;
        } else {
            decode_block(c, &cc, row + (size_t)x * 64, left, above, aboveleft,
                         left_s, above_s, cur + x, err);
            if (*err) return;
        }
        if (base + x + 1 >= size_limit) return;
    }
}

static int run_segment(const Image *im, Coder *c, int min_y, int max_y,
                       int is_last, int encode) {
    SegState st;
    st.arena = c->arena;
    int err = 0;
    for (int i = 0; i < 4; ++i) {
        st.is_top_row[i] = 1;
        int w = i < im->ncomp ? im->widths[i] : 0;
        st.rings[i] = w ? (Summary *)calloc(2 * (size_t)w, sizeof(Summary))
                        : NULL;
    }
    /* identity model (lepton_codec.hh:173-181 per-thread model reset) */
    memcpy(c->arena, identity_arena_template, ARENA_SIZE * 3);
    int index = 0;
    while (!err) {
        RowSpec spec = row_spec_from_index(index++, im);
        if (spec.done) break;
        if (spec.luma_y >= max_y && !is_last) break;
        if (spec.skip) continue;
        if (spec.luma_y < min_y) continue;
        process_row(im, &st, c, spec.component, spec.curr_y, encode, &err);
    }
    for (int i = 0; i < 4; ++i) free(st.rings[i]);
    return err;
}

/* Exported segment entry points.  planes: int16 raster [h][w][64] each. */
EXPORT int64_t lepton_encode_segment(
    int16_t **planes, const int32_t *widths, const int32_t *heights,
    const int32_t *comp_sizes, const int32_t *max_coded_heights, int ncomp,
    int mcuv, const ColorTables *const *colors, uint8_t *arena,
    int min_y, int max_y, int is_last, uint8_t *out, int64_t out_cap) {
    Image im;
    memset(&im, 0, sizeof(im));
    im.ncomp = ncomp;
    im.mcuv = mcuv;
    im.nslots = ncomp == 4 ? 4 : 3;
    for (int i = 0; i < 4; ++i) {
        im.planes[i] = i < ncomp ? planes[i] : NULL;
        im.widths[i] = i < ncomp ? widths[i] : 0;
        im.heights[i] = i < ncomp ? heights[i] : 0;
        im.comp_sizes[i] = i < ncomp ? comp_sizes[i] : 0;
        im.max_coded_heights[i] = i < ncomp ? max_coded_heights[i] : 0;
        im.colors[i] = i < ncomp ? colors[i] : NULL;
        im.row_mask[i] = 0x7fffffff;
    }
    VpxWriter w;
    vpxw_init(&w, out, (size_t)out_cap);
    vpxw_put(&w, 0, 128); /* marker bit */
    Coder c = { arena, &w, NULL, NULL, NULL, 0, 0 };
    int err = run_segment(&im, &c, min_y, max_y, is_last, 1);
    if (err) return err == 2 ? -3 : -1;  /* -3: COEFFICIENT_OUT_OF_RANGE */
    size_t n = vpxw_finish(&w);
    if (w.overflow) return -2;
    return (int64_t)n;
}

EXPORT int lepton_decode_segment(
    int16_t **planes, const int32_t *widths, const int32_t *heights,
    const int32_t *comp_sizes, const int32_t *max_coded_heights, int ncomp,
    int mcuv, const ColorTables *const *colors, uint8_t *arena,
    int min_y, int max_y, int is_last, const uint8_t *data, int64_t len) {
    Image im;
    memset(&im, 0, sizeof(im));
    im.ncomp = ncomp;
    im.mcuv = mcuv;
    im.nslots = ncomp == 4 ? 4 : 3;
    for (int i = 0; i < 4; ++i) {
        im.planes[i] = i < ncomp ? planes[i] : NULL;
        im.widths[i] = i < ncomp ? widths[i] : 0;
        im.heights[i] = i < ncomp ? heights[i] : 0;
        im.comp_sizes[i] = i < ncomp ? comp_sizes[i] : 0;
        im.max_coded_heights[i] = i < ncomp ? max_coded_heights[i] : 0;
        im.colors[i] = i < ncomp ? colors[i] : NULL;
        im.row_mask[i] = 0x7fffffff;
    }
    VpxReader r;
    vpxr_init(&r, data, (size_t)len);
    Coder c = { arena, NULL, &r, NULL, NULL, 0, 0 };
    return run_segment(&im, &c, min_y, max_y, is_last, 0);
}

/* ANS (format v3) segment entry points.  The encoder buffers (prob,bit)
 * pairs during the forward model pass, then serializes them in reverse
 * through two interleaved 64-bit rANS states (ans_bool_writer.hh:21-110,
 * rans64.hh); the decoder streams forward (ans_bool_reader.hh). */

/* exact u64 / freq for freq in [1,256] via Granlund-Montgomery round-up
 * magic: q = (mulhi(m_low, x) + x) >> L with the full multiplier
 * M = 2^(64+L)/d + 1 >= 2^64, of which only the low 64 bits are stored
 * (the implicit 2^64 term is the "+ x").  For d = 2^L the formula gives
 * M = 2^64 + 1, i.e. m_low = 1 and q = (x/2^64 + x) >> L = x >> L --
 * exact, so no power-of-two special case (and no branch) is needed.
 * The hardware 64-bit divide would otherwise dominate the encode loop. */
static struct { uint64_t m; uint32_t l; } RANS_DIV[257];

/* 12KB L1-resident put table indexed by the raw 9-bit (bit<<8 | prob)
 * pair value: everything rans_enc_put derives from (prob, bit) --
 * renorm threshold, division magic, shift, start, 256-freq -- is
 * precomputed, so the serialization loop is two loads + the state
 * arithmetic.  Measured 2.1x on the reverse pass vs computing
 * start/freq with cmovs and indexing RANS_DIV by freq (the cmov chain
 * fed the renorm compare and the mulhi, lengthening the carried
 * dependency; here the entry loads depend only on the pair word,
 * which is available an iteration ahead of the state). */
static struct AnsEnt { uint64_t m, x_max; uint32_t l, start_inv; }
    ANS_ENC_LUT[512];

__attribute__((constructor))
static void init_rans_div(void) {
    for (uint32_t d = 1; d <= 256; ++d) {
        uint32_t l = 0;
        while ((1u << l) < d) ++l;
        unsigned __int128 num = ((unsigned __int128)1) << (64 + l);
        RANS_DIV[d].m = (uint64_t)(num / d + 1);  /* low 64 bits of M */
        RANS_DIV[d].l = l;
    }
    for (int bit = 0; bit < 2; ++bit)
        for (int p = 0; p < 256; ++p) {
            uint32_t freq = bit ? 256 - (uint32_t)p : (uint32_t)p;
            if (!freq) freq = 1;          /* (bit=0, prob=0) never occurs */
            uint32_t start = bit ? (uint32_t)p : 0;
            struct AnsEnt *e = &ANS_ENC_LUT[(bit << 8) | p];
            e->m = RANS_DIV[freq].m;
            e->l = RANS_DIV[freq].l;
            e->x_max = ((RANS64_L >> ANS_SCALE_BITS) << 32) * (uint64_t)freq;
            e->start_inv = start | (((1u << ANS_SCALE_BITS) - freq) << 16);
        }
}

static inline uint64_t rans_divmod(uint64_t x, uint32_t freq,
                                   uint64_t *rem) {
    unsigned __int128 t =
        ((unsigned __int128)RANS_DIV[freq].m * x >> 64) + x;
    uint64_t q = (uint64_t)(t >> RANS_DIV[freq].l);
    *rem = x - q * freq;
    return q;
}

static inline uint64_t rans_enc_put(uint64_t x, uint32_t start,
                                    uint32_t freq, uint32_t **wp) {
    uint64_t x_max = ((RANS64_L >> ANS_SCALE_BITS) << 32) * freq;
    if (x >= x_max) {
        *--(*wp) = (uint32_t)x;
        x >>= 32;
    }
    uint64_t rem;
    uint64_t q = rans_divmod(x, freq, &rem);
    return (q << ANS_SCALE_BITS) + rem + start;
}

/* the hot-loop form: (q << SB) + (x - q*freq) + start == x + q*(2^SB -
 * freq) + start, with every (prob,bit)-derived operand preloaded */
static inline uint64_t rans_enc_put_lut(uint64_t x, const struct AnsEnt *e,
                                        uint32_t **wp) {
    if (x >= e->x_max) {
        *--(*wp) = (uint32_t)x;
        x >>= 32;
    }
    unsigned __int128 t = ((unsigned __int128)e->m * x >> 64) + x;
    uint64_t q = (uint64_t)(t >> e->l);
    uint32_t si = e->start_inv;
    return x + q * (si >> 16) + (si & 0xFFFF);
}

/* serialize the buffered pairs; returns byte length or -1 on overflow */
static int64_t ans_finish(Coder *c, uint8_t *out, int64_t out_cap) {
    if (c->ans_cap < 0) return -1;    /* a pair-buffer grow failed */
    int64_t n = c->ans_n;
    int64_t npairs = (n + 1) / 2;
    /* words written back-to-front into a scratch arena */
    int64_t max_words = 2 * (npairs + 4) + 4 + 8;
    uint32_t *scratch = (uint32_t *)malloc((size_t)max_words * 4);
    if (!scratch) return -1;
    uint32_t *wp = scratch + max_words;
    uint64_t s1 = RANS64_L, s2 = RANS64_L;
    /* encode back-to-front: 4 nop pairs first (decoded last), then the
     * sentinel-padded odd tail, then the clean bulk loop -- peeling the
     * two rare cases keeps the hot body branch-free */
    for (int k = 0; k < 4; ++k) {
        s1 = rans_enc_put(s1, 0, 128, &wp);
        s2 = rans_enc_put(s2, 0, 128, &wp);
    }
    int64_t k = npairs - 1;
    if (n & 1) {
        uint32_t v0 = c->ans_pairs[2 * k];
        uint32_t sb = v0 >> 8, sp = v0 & 0xFF;
        s1 = rans_enc_put(s1, 1, 255, &wp);   /* sentinel fb=1, fp=1 */
        s2 = rans_enc_put(s2, sb ? sp : 0, sb ? 256 - sp : sp, &wp);
        --k;
    }
    /* one u32 load covers both pairs; each pair's low 9 bits are the
     * ANS_ENC_LUT index directly (memcpy = single load, aliasing-safe) */
    for (; k >= 0; --k) {
        uint32_t v;
        memcpy(&v, c->ans_pairs + 2 * k, 4);
        const struct AnsEnt *ef = &ANS_ENC_LUT[(v >> 16) & 0x1FF];
        const struct AnsEnt *es = &ANS_ENC_LUT[v & 0x1FF];
        s1 = rans_enc_put_lut(s1, ef, &wp);
        s2 = rans_enc_put_lut(s2, es, &wp);
    }
    /* flush: the stream leads with [s2lo, s2hi, s1lo, s1hi] so the
       decoder's first state read (w0 | w1<<32) restores s2 as r0
       (ans_bool_writer.hh flush order after the final reverse) */
    *--wp = (uint32_t)(s1 >> 32);
    *--wp = (uint32_t)(s1 & 0xFFFFFFFFu);
    *--wp = (uint32_t)(s2 >> 32);
    *--wp = (uint32_t)(s2 & 0xFFFFFFFFu);
    int64_t nwords = scratch + max_words - wp;
    int64_t nbytes = nwords * 4;
    /* the reference copies one word PAST what the encoder wrote
     * (finish - pptr + 1, ans_bool_writer.hh:108-109): the last nop
     * pair's raw bytes {val=0,prob=128}x2; reproduce for byte parity.
     * Keep in sync with coder/ans.py ANS_PARITY_TAIL (the Python and
     * TPU encoders share that constant). */
    if (nbytes + 4 > out_cap) { free(scratch); return -1; }
    memcpy(out, wp, (size_t)nbytes);   /* little-endian host */
    out[nbytes] = 0x00; out[nbytes + 1] = 0x80;
    out[nbytes + 2] = 0x00; out[nbytes + 3] = 0x80;
    free(scratch);
    return nbytes + 4;
}

EXPORT int64_t lepton_encode_segment_ans(
    int16_t **planes, const int32_t *widths, const int32_t *heights,
    const int32_t *comp_sizes, const int32_t *max_coded_heights, int ncomp,
    int mcuv, const ColorTables *const *colors, uint8_t *arena,
    int min_y, int max_y, int is_last, uint8_t *out, int64_t out_cap) {
    Image im;
    memset(&im, 0, sizeof(im));
    im.ncomp = ncomp;
    im.mcuv = mcuv;
    im.nslots = ncomp == 4 ? 4 : 3;
    for (int i = 0; i < 4; ++i) {
        im.planes[i] = i < ncomp ? planes[i] : NULL;
        im.widths[i] = i < ncomp ? widths[i] : 0;
        im.heights[i] = i < ncomp ? heights[i] : 0;
        im.comp_sizes[i] = i < ncomp ? comp_sizes[i] : 0;
        im.max_coded_heights[i] = i < ncomp ? max_coded_heights[i] : 0;
        im.colors[i] = i < ncomp ? colors[i] : NULL;
        im.row_mask[i] = 0x7fffffff;
    }
    Coder c;
    memset(&c, 0, sizeof(c));
    c.arena = arena;
    c.ans = 1;
    int err = run_segment(&im, &c, min_y, max_y, is_last, 1);
    int64_t r = err == 2 ? -3 : -1;
    if (!err)
        r = ans_finish(&c, out, out_cap);
    free(c.ans_pairs);
    return r;
}

EXPORT int lepton_decode_segment_ans(
    int16_t **planes, const int32_t *widths, const int32_t *heights,
    const int32_t *comp_sizes, const int32_t *max_coded_heights, int ncomp,
    int mcuv, const ColorTables *const *colors, uint8_t *arena,
    int min_y, int max_y, int is_last, const uint8_t *data, int64_t len) {
    Image im;
    memset(&im, 0, sizeof(im));
    im.ncomp = ncomp;
    im.mcuv = mcuv;
    im.nslots = ncomp == 4 ? 4 : 3;
    for (int i = 0; i < 4; ++i) {
        im.planes[i] = i < ncomp ? planes[i] : NULL;
        im.widths[i] = i < ncomp ? widths[i] : 0;
        im.heights[i] = i < ncomp ? heights[i] : 0;
        im.comp_sizes[i] = i < ncomp ? comp_sizes[i] : 0;
        im.max_coded_heights[i] = i < ncomp ? max_coded_heights[i] : 0;
        im.colors[i] = i < ncomp ? colors[i] : NULL;
        im.row_mask[i] = 0x7fffffff;
    }
    AnsReader ar;
    ans_reader_init(&ar, data, (size_t)len);
    Coder c;
    memset(&c, 0, sizeof(c));
    c.arena = arena;
    c.ans = 1;
    c.ar = &ar;
    return run_segment(&im, &c, min_y, max_y, is_last, 0);
}

/* ------------------------------------------------------------------ */
/* Resumable streaming segment decoder (the reference's memory-        */
/* optimized 2-row decode, uncompressed_components.hh:90-108 +         */
/* block_based_image.hh off_y recycling): rows are decoded on demand   */
/* into ring-indexed planes and handed to the recoder MCU row by MCU   */
/* row, keeping decode memory O(width), not O(image).                  */

typedef struct {
    Image im;
    SegState st;
    VpxReader r;
    Coder c;
    uint8_t *arena;
    int index;
    int min_y, max_y, is_last;
    int err, done;
} StreamDecoder;

EXPORT StreamDecoder *lepton_stream_decoder_create(
    int16_t **planes, const int32_t *widths, const int32_t *heights,
    const int32_t *comp_sizes, const int32_t *max_coded_heights, int ncomp,
    int mcuv, const ColorTables *const *colors, const int32_t *row_masks,
    int min_y, int max_y, int is_last, const uint8_t *data, int64_t len) {
    StreamDecoder *sd = (StreamDecoder *)calloc(1, sizeof(StreamDecoder));
    if (!sd) return NULL;
    sd->im.ncomp = ncomp;
    sd->im.mcuv = mcuv;
    sd->im.nslots = ncomp == 4 ? 4 : 3;
    for (int i = 0; i < 4; ++i) {
        sd->im.planes[i] = i < ncomp ? planes[i] : NULL;
        sd->im.widths[i] = i < ncomp ? widths[i] : 0;
        sd->im.heights[i] = i < ncomp ? heights[i] : 0;
        sd->im.comp_sizes[i] = i < ncomp ? comp_sizes[i] : 0;
        sd->im.max_coded_heights[i] = i < ncomp ? max_coded_heights[i] : 0;
        sd->im.colors[i] = i < ncomp ? colors[i] : NULL;
        sd->im.row_mask[i] = i < ncomp ? row_masks[i] : 0x7fffffff;
        sd->st.is_top_row[i] = 1;
        int w = i < ncomp ? widths[i] : 0;
        sd->st.rings[i] = w ? (Summary *)calloc(2 * (size_t)w,
                                                sizeof(Summary)) : NULL;
    }
    sd->arena = (uint8_t *)malloc((size_t)ARENA_SIZE * 3);
    if (!sd->arena) {
        for (int i = 0; i < 4; ++i) free(sd->st.rings[i]);
        free(sd);
        return NULL;
    }
    memcpy(sd->arena, identity_arena_template, ARENA_SIZE * 3);
    sd->st.arena = sd->arena;
    vpxr_init(&sd->r, data, (size_t)len);
    sd->c.arena = sd->arena;
    sd->c.r = &sd->r;
    sd->min_y = min_y; sd->max_y = max_y; sd->is_last = is_last;
    return sd;
}

/* decode rows until the next spec's luma row reaches until_luma_y.
 * returns 0 = paused, 1 = segment complete, <0 = stream error */
EXPORT int lepton_stream_decoder_run(StreamDecoder *sd, int until_luma_y) {
    while (!sd->err) {
        RowSpec spec = row_spec_from_index(sd->index, &sd->im);
        if (spec.done) { sd->done = 1; break; }
        if (spec.luma_y >= sd->max_y && !sd->is_last) { sd->done = 1; break; }
        if (spec.luma_y >= until_luma_y) return 0;
        ++sd->index;
        if (spec.skip) continue;
        if (spec.luma_y < sd->min_y) continue;
        process_row(&sd->im, &sd->st, &sd->c, spec.component, spec.curr_y,
                    0, &sd->err);
    }
    if (sd->err) return -1;
    return 1;
}

EXPORT void lepton_stream_decoder_destroy(StreamDecoder *sd) {
    if (!sd) return;
    for (int i = 0; i < 4; ++i) free(sd->st.rings[i]);
    free(sd->arena);
    free(sd);
}

/* ================================================================== */
/* JPEG Huffman layer: baseline scan decode + re-emit                  */
/* (ports of jpgcoder.cc decode_jpeg/decode_block_seq and              */
/*  recoder.cc recode_one_mcu_row/encode_block_seq)                    */
/* ================================================================== */

typedef struct {
    uint32_t lut[1 << 16];   /* (symbol << 5) | length, 0 = invalid */
    uint32_t lut9[1 << 9];   /* codes of length <= 9 (hot, L1-resident);
                                0 = escape to the full 16-bit table */
    uint16_t cval[256];
    uint8_t clen[256];
    int valid;
} HuffTable;

EXPORT int lepton_huff_table_size(void) { return (int)sizeof(HuffTable); }

EXPORT void lepton_build_huff(HuffTable *ht, const uint8_t *counts,
                              const uint8_t *values, int nvalues) {
    memset(ht, 0, sizeof(*ht));
    int k = 0, code = 0;
    for (int i = 0; i < 16; ++i) {
        for (int j = 0; j < counts[i]; ++j) {
            int v = k < nvalues ? values[k] : 0;
            ht->clen[v] = (uint8_t)(1 + i);
            ht->cval[v] = (uint16_t)code;
            ++k;
            ++code;
        }
        code <<= 1;
    }
    for (int sym = 0; sym < 256; ++sym) {
        int ln = ht->clen[sym];
        if (!ln) continue;
        /* an oversubscribed (corrupt) DHT makes the canonical code
         * overflow its length; the reference truncates its tree and
         * treats such codes as dead nodes ("Huffman table out of
         * space", jpgcoder.cc:5575-5597, accepted for .lep input) --
         * skipping the LUT fill gives the same dead-path decode and
         * keeps prefix+span inside lut[65536] */
        if ((uint32_t)ht->cval[sym] >= (1u << ln)) continue;
        uint32_t prefix = (uint32_t)ht->cval[sym] << (16 - ln);
        uint32_t span = 1u << (16 - ln);
        for (uint32_t i = 0; i < span; ++i)
            ht->lut[prefix + i] = ((uint32_t)sym << 5) | (uint32_t)ln;
        if (ln <= 9) {
            uint32_t prefix9 = (uint32_t)ht->cval[sym] << (9 - ln);
            uint32_t span9 = 1u << (9 - ln);
            for (uint32_t i = 0; i < span9; ++i)
                ht->lut9[prefix9 + i] = ((uint32_t)sym << 5) | (uint32_t)ln;
        }
        ht->valid = 1;
    }
}

/* ------------------------- big-endian bit reader over scan data */
typedef struct {
    const uint8_t *data;
    int64_t nbits, pos;
    int eof;
} HBitReader;

static void hbr_init(HBitReader *r, const uint8_t *data, int64_t nbytes) {
    r->data = data;
    r->nbits = nbytes * 8;
    r->pos = 0;
    r->eof = nbytes == 0;
}

static inline uint32_t hbr_extract(const HBitReader *r, int64_t pos, int n) {
    /* n <= 25 guaranteed by callers */
    int64_t first = pos >> 3;
    if (first + 8 <= (r->nbits >> 3)) {
        uint64_t be;
        memcpy(&be, r->data + first, 8);
        be = __builtin_bswap64(be);
        int bitoff = (int)(pos & 7);
        return (uint32_t)((be << bitoff) >> (64 - n));
    }
    uint64_t chunk = 0;
    int nbytes = (int)(((pos + n - 1) >> 3) - first + 1);
    for (int i = 0; i < nbytes; ++i) chunk = (chunk << 8) | r->data[first + i];
    int total = nbytes * 8;
    chunk >>= total - (int)(pos - (first << 3)) - n;
    return (uint32_t)(chunk & ((1u << n) - 1));
}

static uint32_t hbr_read(HBitReader *r, int n) {
    if (r->eof || n == 0) return 0;
    if (n > 25) {
        /* only reachable via corrupt/malicious DHT symbols (category up
         * to 255); consume MSB-first in extract-safe chunks, keeping the
         * low 32 bits.  The reference's abitreader::read() hits shift-
         * count UB here, so there is no defined behavior to match --
         * deterministic + memory-safe, and the roundtrip verify gate
         * catches any semantic divergence. */
        uint32_t v = 0;
        while (n > 0 && !r->eof) {
            int take = n > 25 ? 25 : n;
            v = (v << take) | hbr_read(r, take);
            n -= take;
        }
        return n > 0 ? (v << (n > 31 ? 31 : n)) : v;
    }
    int64_t end = r->pos + n;
    if (end >= r->nbits) {
        int avail = (int)(r->nbits - r->pos);
        uint32_t val = avail ? hbr_extract(r, r->pos, avail) << (n - avail) : 0;
        r->pos = r->nbits;
        r->eof = 1;
        return val & ((n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1));
    }
    uint32_t val = hbr_extract(r, r->pos, n);
    r->pos = end;
    if (r->pos == r->nbits) r->eof = 1;
    return val;
}

static int huff_decode(HBitReader *r, const HuffTable *ht) {
    int64_t navail = r->nbits - r->pos;
    if (!r->eof && navail >= 16) {
        /* hot path: one peek, L1 table for short codes, skip-advance */
        uint32_t peek = hbr_extract(r, r->pos, 16);
        uint32_t entry = ht->lut9[peek >> 7];
        if (!entry) entry = ht->lut[peek];
        int ln = (int)(entry & 31);
        if (!ln) { hbr_read(r, 16); return -1; }
        r->pos += ln;
        if (r->pos == r->nbits) r->eof = 1;
        return (int)(entry >> 5);
    }
    uint32_t peek;
    if (r->eof) peek = 0;
    else peek = navail ? hbr_extract(r, r->pos, (int)navail) << (16 - navail) : 0;
    uint32_t entry = ht->lut[peek];
    int ln = (int)(entry & 31);
    if (!ln) {
        hbr_read(r, (int)(navail > 0 ? navail : 0));
        return -1;
    }
    hbr_read(r, ln);
    return (int)(entry >> 5);
}

static int hbr_unpad(HBitReader *r, int fillbit) {
    if ((r->pos & 7) == 0 || r->eof) return fillbit;
    int last_bit = (int)hbr_read(r, 1);
    int fill = last_bit;
    int offset = 1;
    while (r->pos & 7) {
        last_bit = (int)hbr_read(r, 1);
        fill |= last_bit << offset;
        ++offset;
    }
    while (offset < 7) {
        fill |= last_bit << offset;
        ++offset;
    }
    return fill;
}

static inline int devli(int s, uint32_t n) {
    if (s == 0) return (int)n;
    if (s > 31) {
        /* only reachable via corrupt/malicious DHT symbols (DC category
         * up to 255).  The reference's DEVLI shifts out of range (UB),
         * so there is no defined behavior to match -- keep the
         * arithmetic defined; the roundtrip verify gate catches any
         * semantic divergence on such inputs. */
        return (int)n;
    }
    if (n >= (1u << (s - 1))) return (int)n;
    /* 64-bit avoids 1<<31 signed overflow at the (corrupt) s=31 edge */
    return (int)((int64_t)n + 1 - ((int64_t)1 << s));
}

/* ------------------------------------------------ scan geometry context */
typedef struct {
    int32_t bch, bcv, bc, nch, ncv, mbs, sfv, sfh;
    int32_t huffdc, huffac;
    int32_t row_mask;   /* plane ring mask; 0x7fffffff = full framebuffer */
} HComp;

typedef struct {
    HComp comps[4];
    int ncomp;               /* components in image */
    int cs_cmpc;             /* components in scan */
    int cs_cmp[4];
    int rsti, mcuh, mcuv, mcuc;
} HScan;

static int h_next_mcupos(const HScan *sc, int *mcu, int *cmp, int *csc,
                         int *sub, int *dpos, int *rstw) {
    int sta = 0;
    if (++(*sub) >= sc->comps[*cmp].mbs) {
        *sub = 0;
        if (++(*csc) >= sc->cs_cmpc) {
            *csc = 0;
            *cmp = sc->cs_cmp[0];
            ++(*mcu);
            if (*mcu >= sc->mcuc) sta = 2;
            else if (sc->rsti > 0 && --(*rstw) == 0) sta = 1;
        } else {
            *cmp = sc->cs_cmp[*csc];
        }
    }
    const HComp *ci = &sc->comps[*cmp];
    if (ci->sfh > 1) {
        int mo = *mcu / sc->mcuh, mm = *mcu - mo * sc->mcuh;
        int so = *sub / ci->sfv, sm = *sub - so * ci->sfv;
        *dpos = (mo * ci->sfh + so) * ci->bch + mm * ci->sfv + sm;
    } else if (ci->sfv > 1) {
        *dpos = *mcu * ci->mbs + *sub;
    } else {
        *dpos = *mcu;
    }
    return sta;
}

static int h_next_mcuposn(const HScan *sc, int cmp, int *dpos, int *rstw) {
    const HComp *ci = &sc->comps[cmp];
    ++(*dpos);
    if (ci->bch != ci->nch && (*dpos % ci->bch) == ci->nch)
        *dpos += ci->bch - ci->nch;
    if (ci->bcv != ci->ncv && (*dpos / ci->bch) == ci->ncv)
        *dpos = ci->bc;
    if (*dpos >= ci->bc) return 2;
    if (sc->rsti > 0 && --(*rstw) == 0) return 1;
    return 0;
}

/* fused symbol + extra-bits decode from one 64-bit window; `ac` selects
 * s = sym & 15 (AC run/size) vs s = sym (DC category) */
static inline int huff_decode_fused(HBitReader *r, const HuffTable *ht,
                                    int ac, uint32_t *extra) {
    int64_t navail = r->nbits - r->pos;
    if (!r->eof && navail >= 64) {
        int64_t first = r->pos >> 3;
        uint64_t be;
        memcpy(&be, r->data + first, 8);
        be = __builtin_bswap64(be);
        uint64_t win = be << (int)(r->pos & 7);
        uint32_t peek = (uint32_t)(win >> 48);
        uint32_t entry = ht->lut9[peek >> 7];
        if (!entry) entry = ht->lut[peek];
        int ln = (int)(entry & 31);
        int sym = (int)(entry >> 5);
        int sbits = ac ? (sym & 15) : sym;
        /* DC symbols come straight from attacker-controlled DHT bytes and
         * can be up to 255; the fused single-window extract is only valid
         * for sbits <= 25 (ln <= 16, so ln + sbits < 48 bits consumed from
         * the 64-bit window, and the shift count 64 - sbits stays in
         * range).  Oversized categories fall through to the slow path,
         * which clamps to nbits and sets eof. */
        if (ln && sbits <= 25) {
            *extra = sbits ? (uint32_t)((win << ln) >> (64 - sbits)) : 0;
            r->pos += ln + sbits;
            if (r->pos > r->nbits) { r->pos = r->nbits; r->eof = 1; }
            return sym;
        }
    }
    int sym = huff_decode(r, ht);
    if (sym < 0) { *extra = 0; return sym; }
    *extra = hbr_read(r, ac ? (sym & 15) : sym);
    return sym;
}

static int decode_block_seq_c(HBitReader *r, const HuffTable *dct,
                              const HuffTable *act, int16_t *block) {
    memset(block, 0, 64 * sizeof(int16_t));
    uint32_t n;
    int hc = huff_decode_fused(r, dct, 0, &n);
    if (hc < 0) return -1;
    int s = hc;
    block[0] = (int16_t)devli(s, n);
    int eob = 64, bpos = 1, eof_fixup = 0;
    while (bpos < 64) {
        hc = huff_decode_fused(r, act, 1, &n);
        if (hc > 0) {
            int z = hc >> 4;
            s = hc & 15;
            if (z + bpos >= 64) { eof_fixup = 1; break; }
            bpos += z;
            block[bpos++] = (int16_t)devli(s, n);
        } else if (hc == 0) {
            eob = bpos;
            break;
        } else {
            return -1;
        }
    }
    if (eof_fixup) {
        if (!r->eof) return -1;
        for (int i = bpos; i < eob; ++i) block[i] = 0;
        if (eob) block[eob - 1] = 1;
    }
    return eob;
}

/* flat handoff record: [luma_y_start, segment_size, overhang_byte,
 *                       num_overhang_bits, dc0..dc3] as int32 */
enum { HANDOFF_I32 = 8, MAX_HANDOFFS = 65540 };

static void crystallize(const HBitReader *r, const uint32_t *hpos,
                        const uint32_t *fpos, int noff, int mcu_y,
                        const int *lastdc, int luma_mul, int32_t *rec) {
    uint32_t pos = (uint32_t)((r->pos >> 3) + 1);
    /* lower_bound over hpos for (pos,pos); pairs sorted by (hpos, fpos) */
    int lo = 0, hi = noff;
    while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (hpos[mid] < pos || (hpos[mid] == pos && fpos[mid] < pos))
            lo = mid + 1;
        else hi = mid;
    }
    int i = lo;
    if (i > 0) --i;
    uint32_t mapped = 0;
    if (i < noff) mapped = fpos[i] + (pos - hpos[i]);
    rec[0] = luma_mul * mcu_y;
    rec[1] = (int32_t)mapped;
    int rem = (int)(r->pos & 7);
    rec[2] = rem ? (r->data[r->pos >> 3] & ((0xFF << (8 - rem)) & 0xFF)) : 0;
    rec[3] = rem;
    for (int k = 0; k < 4; ++k) rec[4 + k] = lastdc[k];
}

/* Decode one baseline scan.  Returns scan status (2 done; negative error);
 * outputs planes (raster int16), handoff records and padbit (in/out). */
EXPORT int lepton_decode_baseline_scan(
    const uint8_t *huffdata, int64_t huff_nbytes, int64_t *bitpos_io,
    const HScan *sc, const HuffTable *tables /* [2][4] */,
    int16_t **planes,
    const uint32_t *offs_hpos, const uint32_t *offs_fpos, int noff,
    int32_t *handoffs_out, int32_t *nhandoffs_io, int32_t *padbit_io,
    int32_t *max_dpos_io) {
    HBitReader r;
    hbr_init(&r, huffdata, huff_nbytes);
    r.pos = *bitpos_io;
    if (r.pos >= r.nbits) r.eof = 1;
    int lastdc[4] = {0, 0, 0, 0};
    int16_t block[64];
    int cmp = sc->cs_cmp[0], csc = 0, mcu = 0, sub = 0, dpos = 0;
    int do_handoff = 1;
    int nh = *nhandoffs_io;
    int padbit = *padbit_io;
    int luma_mul = sc->comps[0].bcv / sc->mcuv;
    int sta = 0;
    int hmul = sc->comps[0].bch / sc->mcuh;
    int vmul = sc->comps[0].bcv / sc->mcuv;

    while (1) {   /* restart-interval loop */
        lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0;
        sta = 0;
        int rstw = sc->rsti;
        while (sta == 0) {
            if (sc->cs_cmpc > 1) {
                if (do_handoff) {
                    if (nh < MAX_HANDOFFS)
                        crystallize(&r, offs_hpos, offs_fpos, noff,
                                    mcu / sc->mcuh, lastdc, luma_mul,
                                    handoffs_out + (size_t)nh * HANDOFF_I32);
                    ++nh;
                    do_handoff = 0;
                }
            } else {
                if (do_handoff) {
                    if (nh < MAX_HANDOFFS)
                        crystallize(&r, offs_hpos, offs_fpos, noff,
                                    (dpos / (hmul * vmul)) / sc->mcuh,
                                    lastdc, luma_mul,
                                    handoffs_out + (size_t)nh * HANDOFF_I32);
                    ++nh;
                    do_handoff = 0;
                }
            }
            if (!r.eof && dpos > max_dpos_io[cmp]) max_dpos_io[cmp] = dpos;
            int eob = decode_block_seq_c(
                &r, &tables[sc->comps[cmp].huffdc],
                &tables[4 + sc->comps[cmp].huffac], block);
            if (eob < 0) { sta = -1; break; }
            block[0] = (int16_t)(block[0] + lastdc[cmp]);
            lastdc[cmp] = block[0];
            {   /* store zigzag block into raster plane */
                const HComp *ci = &sc->comps[cmp];
                int y = dpos / ci->bch, x = dpos % ci->bch;
                if (y < ci->bcv) {
                    int16_t *dst = planes[cmp] +
                        ((size_t)y * ci->bch + x) * 64;
                    for (int b = 0; b < eob; ++b)
                        dst[ZIGZAG_TO_RASTER[b]] = block[b];
                }
            }
            int old_mcu = mcu;
            if (sc->cs_cmpc > 1) {
                sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos, &rstw);
                if (mcu % sc->mcuh == 0 && old_mcu != mcu) do_handoff = 1;
            } else {
                sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                mcu = dpos / (hmul * vmul);
                if (cmp == 0 && mcu % sc->mcuh == 0 &&
                    dpos % (hmul * vmul) == 0)
                    do_handoff = 1;
            }
            if (r.eof) { sta = 2; break; }
        }
        /* unpad / padbit bookkeeping */
        if (padbit != -1) {
            if (padbit != hbr_unpad(&r, padbit)) padbit = 1;
        } else {
            padbit = hbr_unpad(&r, padbit);
        }
        if (sta == -1) return -1;
        if (sta == 2) break;
    }
    /* final crystallize */
    if (nh < MAX_HANDOFFS)
        crystallize(&r, offs_hpos, offs_fpos, noff, mcu / sc->mcuh,
                    lastdc, luma_mul, handoffs_out + (size_t)nh * HANDOFF_I32);
    ++nh;
    *nhandoffs_io = nh;
    *padbit_io = padbit;
    *bitpos_io = r.pos;
    return 2;
}

/* --------------------------------------------- re-emit (recode) */

typedef struct {
    uint8_t *out;
    size_t pos, bound;
} HBound;

static inline void hb_byte(HBound *o, uint8_t b) {
    if (o->pos < o->bound) o->out[o->pos++] = b;
}

static void hb_escaped(HBound *o, const uint8_t *data, size_t n) {
    /* bulk 0xFF stuffing: memchr + memcpy per run (the reference scans
     * with SIMD, recoder.cc:55-123 find_aligned_end_64) */
    size_t i = 0;
    while (i < n) {
        const uint8_t *ff = (const uint8_t *)memchr(data + i, 0xFF, n - i);
        size_t run = ff ? (size_t)(ff - (data + i)) : n - i;
        if (o->pos < o->bound) {
            size_t space = o->bound - o->pos;
            size_t take = run < space ? run : space;
            memcpy(o->out + o->pos, data + i, take);
            o->pos += take;
            if (take < run) o->pos = o->bound;  /* clamp, rest dropped */
        }
        i += run;
        if (ff) {
            hb_byte(o, 0xFF);
            hb_byte(o, 0);
            ++i;
        }
    }
}

typedef struct {
    uint8_t *buf;          /* whole-byte output (pre-escape) */
    size_t pos, cap;
    uint32_t acc;          /* partial bits, top-aligned within `bits` */
    int bits;
} HBitWriter;

static inline void hbw_write(HBitWriter *w, uint32_t val, int n) {
    if (!n) return;
    val &= (n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1);
    uint64_t acc = ((uint64_t)w->acc << n) | val;
    int total = w->bits + n;
    int nbytes = total >> 3;
    if (nbytes) {
        int rem = total & 7;
        uint64_t whole = acc >> rem;   /* nbytes whole bytes, low-aligned */
        if (w->pos + 4 <= w->cap) {
            /* single BE store (callers' buffers carry >=64K slack) */
            uint32_t be = __builtin_bswap32(
                (uint32_t)(whole << (32 - 8 * nbytes)));
            memcpy(w->buf + w->pos, &be, 4);
            w->pos += (size_t)nbytes;
        } else {
            for (int i = nbytes - 1; i >= 0; --i)
                if (w->pos < w->cap)
                    w->buf[w->pos++] = (uint8_t)(whole >> (8 * i));
        }
        total = rem;
    }
    w->acc = (uint32_t)(acc & ((1u << total) - 1));
    w->bits = total;
}

static void hbw_pad(HBitWriter *w, int fillbit) {
    int offset = 1;
    while (w->bits & 7) {
        hbw_write(w, (fillbit & offset) ? 1 : 0, 1);
        offset <<= 1;
    }
}

static int encode_block_seq_c(HBitWriter *w, const HuffTable *dct,
                              const HuffTable *act, const int16_t *zb) {
    int tmp = zb[0];
    unsigned a = (unsigned)(tmp > 0 ? tmp : -tmp);
    int s = bit_length_u(a);
    hbw_write(w, dct->cval[s], dct->clen[s]);
    hbw_write(w, (uint32_t)(tmp > 0 ? tmp : tmp - 1 + (1 << s)), s);
    int end = 63;
    while (end && !zb[end]) --end;
    int z = 0;
    for (int bpos = 1; bpos <= end; ++bpos) {
        tmp = zb[bpos];
        if (!tmp) { ++z; continue; }
        while (z & 0xF0) {
            hbw_write(w, act->cval[0xF0], act->clen[0xF0]);
            z -= 16;
        }
        a = (unsigned)(tmp > 0 ? tmp : -tmp);
        s = bit_length_u(a);
        int hc = (z << 4) + s;
        hbw_write(w, act->cval[hc], act->clen[hc]);
        hbw_write(w, (uint32_t)(tmp > 0 ? tmp : tmp - 1 + (1 << s)), s);
        z = 0;
    }
    if (end != 63) hbw_write(w, act->cval[0x00], act->clen[0x00]);
    return end + 1;
}

/* Re-emit the scan data for mcu rows [start_row, end_row) of one segment.
 * Handoff stitching state (overhang/lastdc) is owned by the caller. */
EXPORT int64_t lepton_recode_rows(
    const HScan *sc, const HuffTable *tables, int16_t **planes,
    int start_mcu_row, int end_mcu_row,
    int overhang_byte, int num_overhang_bits, int32_t *lastdc_io,
    int padbit, const uint32_t *rst_cnt, int n_rst_cnt, int rst_cnt_set,
    uint8_t *out, int64_t out_bound, int64_t out_pos,
    int32_t *overhang_out) {
    HBound o = { out, (size_t)out_pos, (size_t)out_bound };
    size_t cap = (size_t)out_bound + 65536;
    uint8_t *tmp = (uint8_t *)malloc(cap);
    if (!tmp) return -1;
    HBitWriter w = { tmp, 0, cap, 0, 0 };
    w.acc = num_overhang_bits ? (uint32_t)(overhang_byte >> (8 - num_overhang_bits)) : 0;
    w.bits = num_overhang_bits;
    int lastdc[4];
    for (int i = 0; i < 4; ++i) lastdc[i] = lastdc_io[i];
    int16_t zb[64];

    for (int mcu_row = start_mcu_row; mcu_row < end_mcu_row; ++mcu_row) {
        int mcu = mcu_row * sc->mcuh;
        int cmp = sc->cs_cmp[0], csc = 0, sub = 0;
        int mcumul = sc->comps[cmp].sfv * sc->comps[cmp].sfh;
        int dpos = mcu * mcumul;
        int rstw = sc->rsti ? sc->rsti - mcu % sc->rsti : 0;
        unsigned crm = rstw ? (unsigned)(mcu / sc->rsti) : 0;
        int end_of_row = 0;
        while (!end_of_row) {
            int sta = 0;
            while (sta == 0) {
                const HComp *ci = &sc->comps[cmp];
                int y = dpos / ci->bch, x = dpos % ci->bch;
                const int16_t *raster = planes[cmp] +
                    ((size_t)(y & ci->row_mask) * ci->bch + x) * 64;
                for (int zpos = 0; zpos < 64; ++zpos)
                    zb[zpos] = raster[ZIGZAG_TO_RASTER[zpos]];
                int dc = zb[0];
                zb[0] = (int16_t)(zb[0] - lastdc[cmp]);
                lastdc[cmp] = dc;
                encode_block_seq_c(&w, &tables[ci->huffdc],
                                   &tables[4 + ci->huffac], zb);
                int old_mcu = mcu;
                if (sc->cs_cmpc == 1) {
                    sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    mcu = dpos / mcumul;
                } else {
                    sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos,
                                        &rstw);
                }
                if (sta == 0 && w.bits == 0) {
                    hb_escaped(&o, w.buf, w.pos);
                    w.pos = 0;
                }
                if (o.pos >= o.bound) sta = 2;
                if (old_mcu != mcu && mcu % sc->mcuh == 0) {
                    end_of_row = 1;
                    if (sta == 0) goto row_done;
                }
            }
            hbw_pad(&w, padbit);
            if (w.bits == 0) {
                hb_escaped(&o, w.buf, w.pos);
                w.pos = 0;
            }
            if (sta == 2) break;
            if (sta == 1 && sc->rsti > 0) {
                if (!n_rst_cnt || !rst_cnt_set || crm < rst_cnt[0]) {
                    hb_byte(&o, 0xFF);
                    hb_byte(&o, (uint8_t)(0xD0 + (crm & 7)));
                    ++crm;
                }
                rstw = sc->rsti;
                lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0;
            }
        }
row_done:
        /* flush whole bytes after each mcu row */
        hb_escaped(&o, w.buf, w.pos);
        w.pos = 0;
    }
    for (int i = 0; i < 4; ++i) lastdc_io[i] = lastdc[i];
    overhang_out[0] = w.bits ? ((w.acc << (8 - w.bits)) & 0xFF) : 0;
    overhang_out[1] = w.bits;
    free(tmp);
    return (int64_t)o.pos;
}


/* Emit the (branch_index, bit) symbol stream for one segment without
 * arithmetic coding -- the input to batched phase-B coder kernels.
 * Returns symbol count (maybe > cap: caller reallocates and retries). */
EXPORT int64_t lepton_symbolize_segment(
    int16_t **planes, const int32_t *widths, const int32_t *heights,
    const int32_t *comp_sizes, const int32_t *max_coded_heights, int ncomp,
    int mcuv, const ColorTables *const *colors, uint8_t *arena,
    int min_y, int max_y, int is_last,
    int32_t *sym_idx, uint8_t *sym_bit, int64_t sym_cap) {
    Image im;
    memset(&im, 0, sizeof(im));
    im.ncomp = ncomp;
    im.mcuv = mcuv;
    im.nslots = ncomp == 4 ? 4 : 3;
    for (int i = 0; i < 4; ++i) {
        im.planes[i] = i < ncomp ? planes[i] : NULL;
        im.widths[i] = i < ncomp ? widths[i] : 0;
        im.heights[i] = i < ncomp ? heights[i] : 0;
        im.comp_sizes[i] = i < ncomp ? comp_sizes[i] : 0;
        im.max_coded_heights[i] = i < ncomp ? max_coded_heights[i] : 0;
        im.colors[i] = i < ncomp ? colors[i] : NULL;
        im.row_mask[i] = 0x7fffffff;
    }
    Coder c = { arena, NULL, NULL, sym_idx, sym_bit, 0, sym_cap };
    int err = run_segment(&im, &c, min_y, max_y, is_last, 1);
    if (err) return -1;
    return c.sym_n;
}

/* ================================================================== */
/* Progressive JPEG scans: decode + re-emit                            */
/* (ports of jpgcoder.cc progressive paths; semantics mirror the       */
/*  proven Python implementation in jpeg/progressive.py)               */
/* ================================================================== */

typedef struct {
    int cs_from, cs_to, cs_sah, cs_sal;
} HScanPrg;

static inline uint32_t max_eobrun_of(const HuffTable *act) {
    /* hc->max_eobrun (jpgcoder.cc:5540-5547) */
    for (int i = 14; i >= 0; --i)
        if (act->clen[(i << 4) & 255] > 0)
            return (2u << i) - 1;
    return 0;
}

static int h_skip_eobrun(const HScan *sc, int cmp, int *dpos, int *rstw,
                         uint32_t *eobrun) {
    /* jpgcoder.cc:5462-5505 */
    if (*eobrun == 0) return 0;
    const HComp *ci = &sc->comps[cmp];
    if (sc->rsti > 0) {
        if ((int)*eobrun > *rstw) return -1;
        *rstw -= *eobrun;
    }
    if (ci->bch != ci->nch)
        *dpos += (((*dpos % ci->bch) + *eobrun) / ci->nch)
            * (ci->bch - ci->nch);
    if (ci->bcv != ci->ncv && (*dpos / ci->bch) >= ci->ncv)
        *dpos += (ci->bcv - ci->ncv) * ci->bch;
    *dpos += *eobrun;
    *eobrun = 0;
    if (*dpos == ci->bc) return 2;
    if (*dpos > ci->bc) return -1;
    if (sc->rsti > 0 && *rstw == 0) return 1;
    return 0;
}

static inline int16_t *block_at(int16_t **planes, const HScan *sc, int cmp,
                                int dpos) {
    const HComp *ci = &sc->comps[cmp];
    if (ci->row_mask == 0x7fffffff)
        return planes[cmp] + (size_t)dpos * 64;
    int row = dpos / ci->bch, col = dpos - row * ci->bch;
    return planes[cmp]
        + ((size_t)(row & ci->row_mask) * ci->bch + col) * 64;
}

/* Decode one progressive scan (all restart intervals).
 * state_io: [mcu, lastdc0..3].  Returns 2 on success, -1 on error. */
EXPORT int lepton_decode_progressive_scan(
    const uint8_t *huffdata, int64_t nbytes, int64_t *bitpos_io,
    const HScan *sc, const HScanPrg *prg, const HuffTable *tables,
    int16_t **planes,
    const uint32_t *offs_h, const uint32_t *offs_f, int noff,
    int32_t *handoffs_out, int32_t *nh_io, int32_t *padbit_io,
    int32_t *max_dpos_io, int32_t *state_io) {
    HBitReader r;
    hbr_init(&r, huffdata, nbytes);
    r.pos = *bitpos_io;
    if (r.pos >= r.nbits) r.eof = 1;
    int lastdc[4];
    for (int i = 0; i < 4; ++i) lastdc[i] = state_io[1 + i];
    int padbit = *padbit_io;
    int nh = *nh_io;
    int mcu = state_io[0];
    int cmp = sc->cs_cmp[0], csc = 0, sub = 0, dpos = 0;
    mcu = 0;
    int do_handoff = 1;
    int luma_mul = sc->comps[0].bcv / sc->mcuv;
    int16_t block[64];
    uint32_t eobrun = 0;
    int sta = 0;

    while (1) {
        lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0;
        sta = 0;
        eobrun = 0;
        int rstw = sc->rsti;

        if (sc->cs_cmpc > 1) {
            if (prg->cs_sah == 0) {
                while (sta == 0) {   /* interleaved DC first stage */
                    if (do_handoff) {
                        if (nh < MAX_HANDOFFS)
                            crystallize(&r, offs_h, offs_f, noff,
                                        mcu / sc->mcuh, lastdc, luma_mul,
                                        handoffs_out + (size_t)nh * HANDOFF_I32);
                        ++nh;
                        do_handoff = 0;
                    }
                    if (!r.eof && dpos > max_dpos_io[cmp])
                        max_dpos_io[cmp] = dpos;
                    int hc = huff_decode(&r, &tables[sc->comps[cmp].huffdc]);
                    if (hc < 0) { sta = -1; break; }
                    uint32_t n = hbr_read(&r, hc);
                    int16_t dc = (int16_t)(devli(hc, n) + lastdc[cmp]);
                    lastdc[cmp] = dc;
                    block_at(planes, sc, cmp, dpos)[0] =
                        (int16_t)((uint16_t)dc << prg->cs_sal);
                    int old_mcu = mcu;
                    sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos,
                                        &rstw);
                    if (mcu % sc->mcuh == 0 && old_mcu != mcu) do_handoff = 1;
                    if (r.eof) { sta = 2; break; }
                }
            } else {
                while (sta == 0) {   /* interleaved DC refinement */
                    if (!r.eof && dpos > max_dpos_io[cmp])
                        max_dpos_io[cmp] = dpos;
                    uint32_t bitv = hbr_read(&r, 1);
                    int16_t *p = block_at(planes, sc, cmp, dpos);
                    p[0] = (int16_t)(p[0] + ((uint16_t)bitv << prg->cs_sal));
                    sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos,
                                        &rstw);
                    if (r.eof) { sta = 2; break; }
                }
            }
        } else {
            const HComp *ci = &sc->comps[cmp];
            if (prg->cs_to == 0) {
                if (prg->cs_sah == 0) {
                    while (sta == 0) {   /* non-interleaved DC first stage */
                        if (do_handoff) {
                            if (nh < MAX_HANDOFFS)
                                crystallize(&r, offs_h, offs_f, noff,
                                            dpos / ci->bch, lastdc, luma_mul,
                                            handoffs_out + (size_t)nh * HANDOFF_I32);
                            ++nh;
                            do_handoff = 0;
                        }
                        if (!r.eof && dpos > max_dpos_io[cmp])
                            max_dpos_io[cmp] = dpos;
                        int hc = huff_decode(&r, &tables[ci->huffdc]);
                        if (hc < 0) { sta = -1; break; }
                        uint32_t n = hbr_read(&r, hc);
                        int16_t dc = (int16_t)(devli(hc, n) + lastdc[cmp]);
                        lastdc[cmp] = dc;
                        block_at(planes, sc, cmp, dpos)[0] =
                            (int16_t)((uint16_t)dc << prg->cs_sal);
                        if (sta != -1)
                            sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                        if (cmp == 0 && dpos % ci->bch == 0) do_handoff = 1;
                        if (r.eof) { sta = 2; break; }
                    }
                } else {
                    while (sta == 0) {   /* non-interleaved DC refinement */
                        if (!r.eof && dpos > max_dpos_io[cmp])
                            max_dpos_io[cmp] = dpos;
                        uint32_t bitv = hbr_read(&r, 1);
                        int16_t *p = block_at(planes, sc, cmp, dpos);
                        p[0] = (int16_t)(p[0] +
                                         ((uint16_t)bitv << prg->cs_sal));
                        sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                        if (r.eof) { sta = 2; break; }
                    }
                }
            } else if (prg->cs_sah == 0) {
                /* non-interleaved AC first stage */
                const HuffTable *act = &tables[4 + ci->huffac];
                while (sta == 0) {
                    if (!r.eof && dpos > max_dpos_io[cmp])
                        max_dpos_io[cmp] = dpos;
                    int16_t *p = block_at(planes, sc, cmp, dpos);
                    if (eobrun > 0) {
                        --eobrun;
                        for (int b = prg->cs_from; b <= prg->cs_to; ++b)
                            p[ZIGZAG_TO_RASTER[b]] = 0;
                    } else {
                        int bpos = prg->cs_from;
                        int bad = 0;
                        memset(block, 0, sizeof(block));
                        while (bpos <= prg->cs_to) {
                            int hc = huff_decode(&r, act);
                            if (hc < 0) { bad = 1; break; }
                            int l = hc >> 4, rr = hc & 15;
                            if (l == 15 || rr > 0) {
                                uint32_t n = hbr_read(&r, rr);
                                if (l + bpos > prg->cs_to) { bad = 1; break; }
                                bpos += l;
                                block[bpos++] = (int16_t)devli(rr, n);
                            } else {
                                uint32_t n = hbr_read(&r, l);
                                eobrun = (n + (1u << l)) - 1;
                                break;
                            }
                        }
                        if (bad) { sta = -1; break; }
                        for (int b = prg->cs_from; b < bpos; ++b)
                            p[ZIGZAG_TO_RASTER[b]] =
                                (int16_t)((uint16_t)block[b] << prg->cs_sal);
                        sta = h_skip_eobrun(sc, cmp, &dpos, &rstw, &eobrun);
                    }
                    if (sta == 0)
                        sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    if (r.eof) { sta = 2; break; }
                }
            } else {
                /* non-interleaved AC refinement */
                const HuffTable *act = &tables[4 + ci->huffac];
                while (sta == 0) {
                    int16_t *p = block_at(planes, sc, cmp, dpos);
                    for (int b = prg->cs_from; b <= prg->cs_to; ++b)
                        block[b] = p[ZIGZAG_TO_RASTER[b]];
                    if (!r.eof && dpos > max_dpos_io[cmp])
                        max_dpos_io[cmp] = dpos;
                    int bad = 0;
                    if (eobrun == 0) {
                        int bpos = prg->cs_from;
                        while (bpos <= prg->cs_to) {
                            int hc = huff_decode(&r, act);
                            if (hc < 0) { bad = 1; break; }
                            int l = hc >> 4, rr = hc & 15;
                            if (l == 15 || rr > 0) {
                                int z = l, v;
                                if (rr == 0) v = 0;
                                else if (rr == 1)
                                    v = hbr_read(&r, 1) ? 1 : -1;
                                else { bad = 1; break; }
                                while (1) {
                                    if (block[bpos] == 0) {
                                        if (z > 0) --z;
                                        else {
                                            block[bpos++] = (int16_t)v;
                                            break;
                                        }
                                    } else {
                                        uint32_t n = hbr_read(&r, 1);
                                        block[bpos] = (int16_t)(
                                            block[bpos] > 0 ? (int)n : -(int)n);
                                    }
                                    if (bpos >= prg->cs_to) { bad = 1; break; }
                                    ++bpos;
                                }
                                if (bad) break;
                            } else {
                                uint32_t n = hbr_read(&r, l);
                                eobrun = n + (1u << l);
                                break;
                            }
                        }
                        if (!bad && eobrun > 0) {
                            for (int b = bpos; b <= prg->cs_to; ++b) {
                                if (block[b] != 0) {
                                    uint32_t n = hbr_read(&r, 1);
                                    block[b] = (int16_t)(
                                        block[b] > 0 ? (int)n : -(int)n);
                                }
                            }
                            --eobrun;
                        }
                    } else {
                        for (int b = prg->cs_from; b <= prg->cs_to; ++b) {
                            if (block[b] != 0) {
                                uint32_t n = hbr_read(&r, 1);
                                block[b] = (int16_t)(
                                    block[b] > 0 ? (int)n : -(int)n);
                            }
                        }
                        --eobrun;
                    }
                    if (bad) { sta = -1; break; }
                    for (int b = prg->cs_from; b <= prg->cs_to; ++b)
                        p[ZIGZAG_TO_RASTER[b]] = (int16_t)(
                            p[ZIGZAG_TO_RASTER[b]] +
                            (int16_t)((uint16_t)block[b] << prg->cs_sal));
                    sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    if (r.eof) { sta = 2; break; }
                }
            }
        }

        if (padbit != -1) {
            if (padbit != hbr_unpad(&r, padbit)) padbit = 1;
        } else {
            padbit = hbr_unpad(&r, padbit);
        }
        if (sta == -1) return -1;
        if (sta == 2) break;
    }
    state_io[0] = mcu;
    for (int i = 0; i < 4; ++i) state_io[1 + i] = lastdc[i];
    *padbit_io = padbit;
    *bitpos_io = r.pos;
    *nh_io = nh;
    return 2;
}

/* Re-emit one scan (sequential or progressive) into `out`.
 * rstp positions are absolute byte offsets within the full regenerated
 * huffdata (out_base is the byte count before this scan).
 * Returns bytes appended, or -1 on error. */
EXPORT int64_t lepton_recode_any_scan(
    const HScan *sc, const HScanPrg *prg, int jpegtype,
    const HuffTable *tables, int16_t **planes, int padbit,
    uint8_t *out, int64_t out_cap, int64_t out_base,
    uint32_t *rstp_out, int32_t *rstp_cap, int32_t *n_rstp_io) {
    size_t cap = (size_t)out_cap;
    HBitWriter w = { out, 0, cap, 0, 0 };
    int lastdc[4];
    int16_t block[64];
    uint8_t crbits[8192];
    int n_crbits = 0;
    int fill = padbit == -1 ? 0 : padbit;
    int cmp = sc->cs_cmp[0], csc = 0, sub = 0, dpos = 0, mcu = 0;
    uint32_t eobrun = 0;
    int sta = 0;
    int n_rstp = *n_rstp_io;

    #define FLUSH_CRBITS() do { \
        for (int _i = 0; _i < n_crbits; ++_i) hbw_write(&w, crbits[_i], 1); \
        n_crbits = 0; } while (0)

    #define ENCODE_EOBRUN(act) do { \
        if (eobrun > 0) { \
            uint32_t _max = max_eobrun_of(act); \
            /* only corrupt coefficients reach a run the table can't code;
             * error out instead of looping on a zero decrement */ \
            if (_max == 0) return -1; \
            while (eobrun > _max) { \
                hbw_write(&w, (act)->cval[0xE0], (act)->clen[0xE0]); \
                hbw_write(&w, 32767 - (1 << 14), 14); \
                eobrun -= _max; \
            } \
            int _s = bit_length_u(eobrun); \
            if (_s) --_s; \
            hbw_write(&w, (act)->cval[_s << 4], (act)->clen[_s << 4]); \
            hbw_write(&w, eobrun - (1u << _s), _s); \
            eobrun = 0; \
        } } while (0)

    while (1) {
        lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0;
        sta = 0;
        eobrun = 0;
        int rstw = sc->rsti;

        if (sc->cs_cmpc > 1) {
            if (jpegtype == 1) {
                while (sta == 0) {
                    const HComp *ci = &sc->comps[cmp];
                    const int16_t *raster = block_at(planes, sc, cmp, dpos);
                    for (int z = 0; z < 64; ++z)
                        block[z] = raster[ZIGZAG_TO_RASTER[z]];
                    int16_t dc = block[0];
                    block[0] = (int16_t)(block[0] - lastdc[cmp]);
                    lastdc[cmp] = dc;
                    encode_block_seq_c(&w, &tables[ci->huffdc],
                                       &tables[4 + ci->huffac], block);
                    sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos,
                                        &rstw);
                }
            } else if (prg->cs_sah == 0) {
                while (sta == 0) {
                    const HComp *ci = &sc->comps[cmp];
                    int tmp = block_at(planes, sc, cmp, dpos)[0]
                        >> prg->cs_sal;
                    int diff = tmp - lastdc[cmp];
                    lastdc[cmp] = tmp;
                    unsigned a = (unsigned)(diff > 0 ? diff : -diff);
                    int s = bit_length_u(a);
                    const HuffTable *dct = &tables[ci->huffdc];
                    hbw_write(&w, dct->cval[s], dct->clen[s]);
                    hbw_write(&w, (uint32_t)(diff > 0 ? diff
                                             : diff - 1 + (1 << s)), s);
                    sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos,
                                        &rstw);
                }
            } else {
                while (sta == 0) {
                    int bitv = (block_at(planes, sc, cmp, dpos)[0]
                                >> prg->cs_sal) & 1;
                    hbw_write(&w, (uint32_t)bitv, 1);
                    sta = h_next_mcupos(sc, &mcu, &cmp, &csc, &sub, &dpos,
                                        &rstw);
                }
            }
        } else {
            const HComp *ci = &sc->comps[cmp];
            if (jpegtype == 1) {
                while (sta == 0) {
                    const int16_t *raster = block_at(planes, sc, cmp, dpos);
                    for (int z = 0; z < 64; ++z)
                        block[z] = raster[ZIGZAG_TO_RASTER[z]];
                    int16_t dc = block[0];
                    block[0] = (int16_t)(block[0] - lastdc[cmp]);
                    lastdc[cmp] = dc;
                    encode_block_seq_c(&w, &tables[ci->huffdc],
                                       &tables[4 + ci->huffac], block);
                    sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                }
            } else if (prg->cs_to == 0) {
                if (prg->cs_sah == 0) {
                    while (sta == 0) {
                        int tmp = block_at(planes, sc, cmp, dpos)[0]
                            >> prg->cs_sal;
                        int diff = tmp - lastdc[cmp];
                        lastdc[cmp] = tmp;
                        unsigned a = (unsigned)(diff > 0 ? diff : -diff);
                        int s = bit_length_u(a);
                        const HuffTable *dct = &tables[ci->huffdc];
                        hbw_write(&w, dct->cval[s], dct->clen[s]);
                        hbw_write(&w, (uint32_t)(diff > 0 ? diff
                                                 : diff - 1 + (1 << s)), s);
                        sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    }
                } else {
                    while (sta == 0) {
                        int bitv = (block_at(planes, sc, cmp, dpos)[0]
                                    >> prg->cs_sal) & 1;
                        hbw_write(&w, (uint32_t)bitv, 1);
                        sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    }
                }
            } else {
                const HuffTable *act = &tables[4 + ci->huffac];
                if (prg->cs_sah == 0) {
                    while (sta == 0) {
                        const int16_t *raster =
                            block_at(planes, sc, cmp, dpos);
                        /* FDIV2 toward zero */
                        int z = 0;
                        for (int b = prg->cs_from; b <= prg->cs_to; ++b) {
                            int v = raster[ZIGZAG_TO_RASTER[b]];
                            block[b] = (int16_t)(v < 0
                                ? -((-v) >> prg->cs_sal)
                                : v >> prg->cs_sal);
                        }
                        /* encode_ac_prg_fs (jpgcoder.cc:5077-5131) */
                        z = 0;
                        for (int b = prg->cs_from; b <= prg->cs_to; ++b) {
                            int tmp = block[b];
                            if (tmp != 0) {
                                ENCODE_EOBRUN(act);
                                while (z >= 16) {
                                    hbw_write(&w, act->cval[0xF0],
                                              act->clen[0xF0]);
                                    z -= 16;
                                }
                                unsigned a = (unsigned)(tmp > 0 ? tmp : -tmp);
                                int s = bit_length_u(a);
                                int hc = (z << 4) + s;
                                hbw_write(&w, act->cval[hc], act->clen[hc]);
                                hbw_write(&w, (uint32_t)(tmp > 0 ? tmp
                                          : tmp - 1 + (1 << s)), s);
                                z = 0;
                            } else ++z;
                        }
                        if (z > 0) {
                            ++eobrun;
                            if (eobrun == max_eobrun_of(act))
                                ENCODE_EOBRUN(act);
                        }
                        sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    }
                    ENCODE_EOBRUN(act);
                } else {
                    while (sta == 0) {
                        const int16_t *raster =
                            block_at(planes, sc, cmp, dpos);
                        for (int b = prg->cs_from; b <= prg->cs_to; ++b) {
                            int v = raster[ZIGZAG_TO_RASTER[b]];
                            block[b] = (int16_t)(v < 0
                                ? -((-v) >> prg->cs_sal)
                                : v >> prg->cs_sal);
                        }
                        /* encode_ac_prg_sa (jpgcoder.cc:5237-5330) */
                        int eob = prg->cs_from;
                        for (int b = prg->cs_to; b >= prg->cs_from; --b) {
                            if (block[b] == 1 || block[b] == -1) {
                                eob = b + 1;
                                break;
                            }
                        }
                        if (eob > prg->cs_from && eobrun > 0) {
                            ENCODE_EOBRUN(act);
                            FLUSH_CRBITS();
                        }
                        int z = 0;
                        int b = prg->cs_from;
                        for (; b < eob; ++b) {
                            int tmp = block[b];
                            if (tmp == 0) {
                                if (++z == 16) {
                                    hbw_write(&w, act->cval[0xF0],
                                              act->clen[0xF0]);
                                    FLUSH_CRBITS();
                                    z = 0;
                                }
                            } else if (tmp == 1 || tmp == -1) {
                                int s = 1;
                                int hc = (z << 4) + s;
                                hbw_write(&w, act->cval[hc], act->clen[hc]);
                                hbw_write(&w, (uint32_t)(tmp > 0 ? tmp
                                          : tmp - 1 + (1 << s)), s);
                                FLUSH_CRBITS();
                                z = 0;
                            } else {
                                if (n_crbits < (int)sizeof(crbits))
                                    crbits[n_crbits++] =
                                        (uint8_t)(block[b] & 1);
                            }
                        }
                        for (; b <= prg->cs_to; ++b) {
                            if (block[b] != 0 &&
                                n_crbits < (int)sizeof(crbits))
                                crbits[n_crbits++] = (uint8_t)(block[b] & 1);
                        }
                        if (eob <= prg->cs_to) {
                            ++eobrun;
                            if (eobrun == max_eobrun_of(act)) {
                                ENCODE_EOBRUN(act);
                                FLUSH_CRBITS();
                            }
                        }
                        sta = h_next_mcuposn(sc, cmp, &dpos, &rstw);
                    }
                    ENCODE_EOBRUN(act);
                    FLUSH_CRBITS();
                }
            }
        }

        hbw_pad(&w, fill);
        if (sta == -1) return -1;
        if (sta == 2) break;
        if (sta == 1 && sc->rsti > 0) {
            if (n_rstp < *rstp_cap)
                rstp_out[n_rstp] = (uint32_t)(out_base + w.pos - 1);
            ++n_rstp;
        }
    }
    *n_rstp_io = n_rstp;
    return (int64_t)w.pos;
}

/* ================================================================== */
/* Sandbox: seccomp-BPF syscall jail                                   */
/* (TPU-native equivalent of the reference's strict-mode seccomp,      */
/*  src/io/Seccomp.cc:67-138.  The reference preallocates all memory   */
/*  so it can ban mmap/brk outright; a Python-hosted runtime cannot,   */
/*  so the jail is an allow-list that keeps memory + synchronization   */
/*  syscalls and kills filesystem/exec/network access.)                */
/* ================================================================== */
#ifdef __linux__
#include <stddef.h>
#include <sys/prctl.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <linux/filter.h>
#include <linux/seccomp.h>
#include <linux/audit.h>

#if defined(__x86_64__)
#define JAIL_ARCH AUDIT_ARCH_X86_64
#elif defined(__aarch64__)
#define JAIL_ARCH AUDIT_ARCH_AARCH64
#endif

#ifndef SECCOMP_RET_KILL_PROCESS
#define SECCOMP_RET_KILL_PROCESS SECCOMP_RET_KILL
#endif

#ifdef JAIL_ARCH
static const int jail_allowed[] = {
    __NR_read, __NR_write, __NR_writev, __NR_close, __NR_fstat,
    __NR_lseek, __NR_exit, __NR_exit_group, __NR_rt_sigreturn,
    __NR_sigaltstack,
    /* memory (Python/numpy allocate continuously) */
    __NR_brk, __NR_mmap, __NR_munmap, __NR_mprotect, __NR_mremap,
    __NR_madvise,
    /* threads & sync (worker pool, GIL) */
    __NR_futex, __NR_sched_yield, __NR_getpid, __NR_gettid,
    __NR_tgkill, __NR_rt_sigaction, __NR_rt_sigprocmask,
    __NR_restart_syscall,
    /* time (timing harness, CPython internals) */
    __NR_clock_gettime, __NR_clock_nanosleep, __NR_nanosleep,
    __NR_gettimeofday,
    __NR_getrandom,
    /* serving: poll/accept loop stays outside the jail; children only
       pump already-open fds.  Legacy syscalls (poll, epoll_wait, dup2)
       do not exist on aarch64 -- guard each so the AUDIT_ARCH_AARCH64
       branch still compiles. */
#ifdef __NR_poll
    __NR_poll,
#endif
    __NR_ppoll,
#ifdef __NR_epoll_wait
    __NR_epoll_wait,
#endif
    __NR_epoll_pwait,
    __NR_dup,
#ifdef __NR_dup2
    __NR_dup2,
#endif
    __NR_shutdown,
    __NR_membarrier, __NR_sched_getaffinity,
    /* socket data pumping on already-open fds (serve children) */
    __NR_recvfrom, __NR_sendto, __NR_recvmsg, __NR_sendmsg,
    __NR_getsockopt,
};

#ifndef CLONE_THREAD
#define CLONE_THREAD 0x00010000
#endif

#include <signal.h>
static void jail_sigsys_report(int sig, siginfo_t *info, void *ctx) {
    (void)sig; (void)ctx;
    char msg[64] = "jail: banned syscall ";
    int nr = info->si_syscall;
    int len = 21;
    if (nr >= 100) msg[len++] = (char)('0' + nr / 100 % 10);
    if (nr >= 10) msg[len++] = (char)('0' + nr / 10 % 10);
    msg[len++] = (char)('0' + nr % 10);
    msg[len++] = '\n';
    ssize_t r = write(2, msg, (size_t)len);
    (void)r;
    _exit(159);
}

#ifndef SECCOMP_SET_MODE_FILTER
#define SECCOMP_SET_MODE_FILTER 1
#endif
#ifndef SECCOMP_FILTER_FLAG_TSYNC
#define SECCOMP_FILTER_FLAG_TSYNC 1UL
#endif

#include <errno.h>
/* Attach a filter to EVERY thread in the process, not just the caller:
 * the pre-jail warm pool (api._warm_pool) is spawned before the jail
 * and then runs the segment codecs over untrusted input, and
 * prctl(PR_SET_SECCOMP) binds only the calling thread.  seccomp(2) with
 * TSYNC also propagates no_new_privs to the synced threads.  Falls back
 * to prctl on pre-3.17 kernels (single-thread bind, as before). */
static int jail_attach_all_threads(struct sock_fprog *fprog) {
    if (prctl(PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) != 0) return -1;
    long r = syscall(__NR_seccomp, SECCOMP_SET_MODE_FILTER,
                     SECCOMP_FILTER_FLAG_TSYNC, fprog);
    if (r == 0) return 0;
    if (r < 0 && errno == ENOSYS)
        return prctl(PR_SET_SECCOMP, SECCOMP_MODE_FILTER, fprog) != 0
            ? -2 : 0;
    return -2;
}

/* trap mode: report the banned syscall number on stderr, then exit
 * (debug aid; KILL mode is the production contract) */
EXPORT int lepton_install_jail_trap(void);

static int lepton_install_jail_mode(unsigned deny_action);

EXPORT int lepton_install_jail(void) {
    return lepton_install_jail_mode(SECCOMP_RET_KILL_PROCESS);
}

EXPORT int lepton_install_jail_trap(void) {
    struct sigaction sa;
    memset(&sa, 0, sizeof(sa));
    sa.sa_sigaction = jail_sigsys_report;
    sa.sa_flags = SA_SIGINFO;
    sigaction(SIGSYS, &sa, NULL);
    return lepton_install_jail_mode(SECCOMP_RET_TRAP);
}

static int lepton_install_jail_mode(unsigned deny_action) {
    size_t n = sizeof(jail_allowed) / sizeof(jail_allowed[0]);
    /* load arch + nr, compare against the allow list, else KILL.
     * clone is allowed only with CLONE_THREAD (worker threads, never
     * processes); clone3 returns ENOSYS so glibc falls back to clone. */
    struct sock_filter prog[16 + 2 * 80];
    size_t p = 0;
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_LD | BPF_W | BPF_ABS, offsetof(struct seccomp_data, arch));
    prog[p++] = (struct sock_filter)BPF_JUMP(
        BPF_JMP | BPF_JEQ | BPF_K, JAIL_ARCH, 1, 0);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_RET | BPF_K, SECCOMP_RET_KILL_PROCESS);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_LD | BPF_W | BPF_ABS, offsetof(struct seccomp_data, nr));
    for (size_t i = 0; i < n; ++i) {
        prog[p++] = (struct sock_filter)BPF_JUMP(
            BPF_JMP | BPF_JEQ | BPF_K, (unsigned)jail_allowed[i], 0, 1);
        prog[p++] = (struct sock_filter)BPF_STMT(
            BPF_RET | BPF_K, SECCOMP_RET_ALLOW);
    }
    /* clone3 -> ENOSYS (fall back to clone) */
    prog[p++] = (struct sock_filter)BPF_JUMP(
        BPF_JMP | BPF_JEQ | BPF_K, __NR_clone3, 0, 1);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_RET | BPF_K, SECCOMP_RET_ERRNO | 38 /* ENOSYS */);
    /* clone: allow only when flags carry CLONE_THREAD */
    prog[p++] = (struct sock_filter)BPF_JUMP(
        BPF_JMP | BPF_JEQ | BPF_K, __NR_clone, 0, 4);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_LD | BPF_W | BPF_ABS, offsetof(struct seccomp_data, args[0]));
    prog[p++] = (struct sock_filter)BPF_JUMP(
        BPF_JMP | BPF_JSET | BPF_K, CLONE_THREAD, 0, 1);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_RET | BPF_K, SECCOMP_RET_ALLOW);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_RET | BPF_K, deny_action);
    prog[p++] = (struct sock_filter)BPF_STMT(
        BPF_RET | BPF_K, deny_action);
    struct sock_fprog fprog = { (unsigned short)p, prog };
    return jail_attach_all_threads(&fprog);
}

EXPORT int lepton_jail_supported(void) { return 1; }

/* Stage-2 filter: drop the dynamic-memory syscalls stage 1 must still
 * allow for the Python runtime (brk/mmap/mremap).  Installed only after
 * the transcode heap is pre-grown (lepton_prejail_heap) so the
 * allocator serves the whole transcode from its existing arena -- the
 * closest a hosted runtime gets to the reference's preallocate-then-
 * strict-filter design (MemMgrAllocator.cc:159 + Seccomp.cc:67-138).
 * mprotect/munmap/madvise stay allowed: freeing and in-place
 * permission changes on already-mapped pages add no reachable surface.
 * Seccomp filters stack, so this composes with the stage-1 allowlist. */
EXPORT int lepton_install_jail_stage2(void) {
    struct sock_filter prog[] = {
        { BPF_LD | BPF_W | BPF_ABS, 0, 0,
          offsetof(struct seccomp_data, nr) },
        { BPF_JMP | BPF_JEQ | BPF_K, 3, 0, __NR_brk },
        { BPF_JMP | BPF_JEQ | BPF_K, 2, 0, __NR_mmap },
        { BPF_JMP | BPF_JEQ | BPF_K, 1, 0, __NR_mremap },
        { BPF_RET | BPF_K, 0, 0, SECCOMP_RET_ALLOW },
        { BPF_RET | BPF_K, 0, 0, SECCOMP_RET_KILL_PROCESS },
    };
    struct sock_fprog fprog = {
        sizeof(prog) / sizeof(prog[0]), prog };
    return jail_attach_all_threads(&fprog);
}

/* Pre-grow the glibc heap by `bytes` of touched pages and pin it there
 * (no trim, no mmap for large chunks), so a post-stage-2 transcode
 * allocates without asking the kernel for memory.  Run with
 * PYTHONMALLOC=malloc so CPython's object allocator routes here too. */
#include <malloc.h>
EXPORT int lepton_prejail_heap(int64_t bytes) {
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, -1);
    size_t chunk = 64 * 1024 - 64;
    size_t n = (size_t)(bytes > 0 ? bytes : 0) / chunk + 1;
    void **ptrs = (void **)malloc(n * sizeof(void *));
    if (!ptrs) return -1;
    size_t got = 0;
    for (size_t i = 0; i < n; ++i) {
        char *p = (char *)malloc(chunk);
        if (!p) break;
        for (size_t off = 0; off < chunk; off += 4096) p[off] = 0;
        ptrs[got++] = p;
    }
    for (size_t i = 0; i < got; ++i) free(ptrs[i]);
    int rc = got == n ? 0 : -2;
    free(ptrs);
    return rc;
}

/* fault injection: issue a banned syscall (getcwd, like the reference's
 * test_syscall_injection, jpgcoder.cc:1324) -- under the jail the process
 * dies with SIGSYS */
EXPORT long lepton_inject_syscall(void) {
    char buf[64];
    return syscall(__NR_getcwd, buf, sizeof(buf));
}

/* fault injection for the stage-2 filter: a direct anonymous mmap
 * (-injectsyscall=5) must die with SIGSYS under the full jail */
#include <sys/mman.h>
EXPORT long lepton_inject_syscall_mmap(void) {
    void *p = mmap(NULL, 4096, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    return p == MAP_FAILED ? -1 : (long)(intptr_t)p;
}
#else
EXPORT int lepton_install_jail(void) { return -3; }
EXPORT int lepton_install_jail_stage2(void) { return -3; }
EXPORT int lepton_prejail_heap(int64_t bytes) { (void)bytes; return -3; }
EXPORT int lepton_jail_supported(void) { return 0; }
EXPORT long lepton_inject_syscall(void) { return -1; }
EXPORT long lepton_inject_syscall_mmap(void) { return -1; }
#endif
#else
EXPORT int lepton_install_jail(void) { return -3; }
EXPORT int lepton_install_jail_stage2(void) { return -3; }
EXPORT int lepton_prejail_heap(int64_t bytes) { (void)bytes; return -3; }
EXPORT int lepton_jail_supported(void) { return 0; }
EXPORT long lepton_inject_syscall(void) { return -1; }
EXPORT long lepton_inject_syscall_mmap(void) { return -1; }
#endif
