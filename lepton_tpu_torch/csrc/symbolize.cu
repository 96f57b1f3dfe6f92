// symbolize.cu -- each block's live (branch, bit) symbols in emission
// order, from a plane's coefficients alone, for Hopper (sm_90a).
//
// Replaces lepton_tpu/kernels/symbolize.py::symbolize_slice (:104-309),
// with its phase A (lepton_tpu/kernels/contexts.py::phase_a, :257), and
// the compaction after it (_sym_sorted_jit,
// lepton_tpu/kernels/batch_encode.py:91; compact_symbols :313 and
// row_symbol_counts :346 of symbolize.py), all XLA.  The JAX package
// computes every block's contexts as whole-plane arrays, fills a fixed
// slab of slots a block, PAD where nothing is coded, and compacts it by
// sorting: a TPU serialises scatters and pads its tiles to 128.  A GPU has
// neither rule, so the contexts never leave shared memory and each block's
// symbols go straight to their place.  The port's plain version
// (kernels/symbolize.py) keeps phase A's arrays and the slab, 1,420 slots a
// block, of which photos fill about 5%.
//
// Bound: bytes.  symbol_counts reads each block's 128 bytes of
// coefficients and writes its count and flag (5 B); symbol_emit reads the
// coefficients and each block's offset (8 B) and writes 5 B a symbol,
// about 66 symbols a block on photos.  The work is an IDCT of each block
// (twice: as itself and as the block above the next row's tile) and a few
// integer operations a symbol.
//
// Design.  A CTA takes kTile consecutive blocks of one row and stages in
// shared memory, 16 bytes a thread with neighbouring threads on
// neighbouring addresses, two rows of kTile + 1 blocks: the tile with the
// block left of it, and the kTile + 1 blocks above those (zeros where the
// plane has none).  Phase A runs there as kernels/contexts.py computes
// it: each block's IDCT with DC ignored, 8 threads a block (a row each,
// then a column each, through padded shared memory), and each block's 7x7
// nonzero count.  Then one thread a tile block walks it, walk<kEmit>, in
// the emission order of kernels/symbolize.py: the 6-bit nz tree (its
// context from the left and above counts); the 49 interior coefficients
// in zigzag order, each as exponent unary (its bucket from aavrg, the
// weighted neighbour average at that position), sign and residual; the
// horizontal, then the vertical edge, each a 3-bit tree and 7 x
// (exponent, sign, threshold-contexted then noise residual, with the
// so_far chain; the buckets from the Lakhani prediction off the block
// above or to the left); then DC, against the pixel-domain prediction
// from the block's own pixels and the neighbours' edge pixels.  aavrg,
// the predictions and the DC prediction are computed where the walk reads
// them, from shared memory: nothing of phase A reaches device memory.
// The interior and each edge end at their last nonzero coefficient, where
// the slab keeps every slot.  Integer arithmetic wraps as torch's int32
// does: it runs in uint32_t and is cast back.
//
// Two kernels instantiate the walk: symbol_counts_kernel (kEmit false)
// writes each block's count of live symbols and a flag for a coded value
// past 11 bits (the slab's COEF_OUT_OF_RANGE); the wrapper sums the counts
// into offsets; symbol_emit_kernel (kEmit true) takes them.  A tile's
// blocks are consecutive in raster order, so their symbols are one range
// of the output: the walk stages them in shared memory (kStage symbols,
// in the room the IDCT used), COEF_OUT_OF_RANGE in place of a flagged
// block's first branch, and the CTA writes the range with coalesced
// stores.  A tile with more symbols than kStage (dense q100 or hostile
// planes: a block codes up to 1,420) walks in rounds, each round's
// window of the range flushed in turn; a block whose symbols miss a
// round's window skips that round's walk.  One walk makes counts and
// symbols, so the two cannot disagree.  The table offsets and strides
// (model/tables.py), the nonzero bins, the zigzag order, the plane's noise
// thresholds, quantizers and Lakhani cosines come from the wrapper as one
// by-value parameter block (Params), which each CTA copies to shared
// memory.
//
// Bounds checks (checked.cuh; only with -DLEPTON_CHECKED): each 16-byte
// load of the coefficients against the plane; in symbol_emit, each
// block's symbols against its tile's range and each store against the
// output's length.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;              // blocks of one row a CTA walks
constexpr int kSlots = kTile + 1;      // and the block left of them
constexpr int kBlockPad = 66;          // int16 a block in shared memory: 33
                                       // words, so a warp's 32 blocks fall
                                       // in 32 banks
constexpr int kRowPad = 9;             // int32 an IDCT row in shared memory
constexpr int kStage = 4096;           // symbols symbol_emit stages a round
constexpr int kMaxExponent = 11;       // constants.MAX_EXPONENT
constexpr int kCoefBits = 10;          // constants.COEF_BITS
constexpr int kNoiseFloor = 7;         // constants.RESIDUAL_NOISE_FLOOR
constexpr int kNumericLengthMax = 12;  // constants.NUMERIC_LENGTH_MAX
constexpr int kOutOfRange = -3;        // symbolize.COEF_OUT_OF_RANGE
// the fixed-point IDCT's constants (constants.W1 .. R2, idct.cc)
constexpr uint32_t kW1 = 2841;
constexpr uint32_t kW2 = 2676;
constexpr uint32_t kW3 = 2408;
constexpr uint32_t kW5 = 1609;
constexpr uint32_t kW6 = 1108;
constexpr uint32_t kW7 = 565;
constexpr uint32_t kR2 = 181;

// The parameter block, in kernels/symbolize.py's PARAM_NAMES order: each
// table's offset, then its strides but the last (which is 1).
enum Tab {
    NZ_7X7, NZ_7X7_S0, NZ_7X7_S1, NZ_7X7_S2,
    NZ_1X8, NZ_1X8_S0, NZ_1X8_S1, NZ_1X8_S2, NZ_1X8_S3,
    NZ_8X1, NZ_8X1_S0, NZ_8X1_S1, NZ_8X1_S2, NZ_8X1_S3,
    RESIDUAL_NOISE, RESIDUAL_NOISE_S0, RESIDUAL_NOISE_S1, RESIDUAL_NOISE_S2,
    RESIDUAL_NOISE_DC, RESIDUAL_NOISE_DC_S0,
    RESIDUAL_THRESH, RESIDUAL_THRESH_S0, RESIDUAL_THRESH_S1,
    RESIDUAL_THRESH_S2,
    EXP_7X7, EXP_7X7_S0, EXP_7X7_S1, EXP_7X7_S2, EXP_7X7_S3,
    EXP_X, EXP_X_S0, EXP_X_S1, EXP_X_S2, EXP_X_S3,
    EXP_DC, EXP_DC_S0, EXP_DC_S1,
    SIGN, SIGN_S0, SIGN_S1,
    kTabs
};
// then the nonzero-count bins (50), the zigzag order of the 7x7 interior
// (49 raster positions), and the plane's min noise thresholds, quantizers
// and Lakhani cosines of the horizontal and the vertical edge (64 each,
// raster)
constexpr int kNzBin = kTabs;
constexpr int kUnzig = kNzBin + 50;
constexpr int kNoise = kUnzig + 49;
constexpr int kQuant = kNoise + 64;
constexpr int kIcosX = kQuant + 64;
constexpr int kIcosY = kIcosX + 64;
constexpr int kParams = kIcosY + 64;

struct Params {
    int32_t v[kParams];
};

// One plane, row-major blocks: the inputs of kernels/symbolize.py's Plane.
struct Plane {
    const int16_t* coefs;      // [rows * width, 64] raster, 16-byte aligned
    const uint8_t* has_above;  // [rows]: bool
    int64_t rows, width, row_block_offset, size_limit;
    int ci;
};

// A CTA's shared memory.  Block slots: 0 .. kTile the tile's row from the
// block left of the tile, kSlots .. 2 kSlots - 1 the row above, the same
// columns; tile block t is slot t + 1, its left neighbour slot t, the
// block above it slot kSlots + t + 1 and above-left slot kSlots + t.
struct Smem {
    int32_t P[kParams];
    int16_t coef[2 * kSlots][kBlockPad];   // coefficients, raster
    int16_t pix[2 * kSlots][kBlockPad];    // pixels of the IDCT, DC ignored
    union {
        int32_t rows[2 * kSlots][8][kRowPad];  // the IDCT's first pass
        struct {                               // symbol_emit's staging
            int32_t idx[kStage];
            uint8_t bit[kStage];
        } stage;
    } scratch;
    int64_t off[kTile + 1];                // symbol_emit: the offsets
    uint8_t nz[2 * kSlots];                // 7x7 nonzero counts
    uint8_t has_above;                     // the tile row's flag
};

__device__ __forceinline__ uint32_t u32(int32_t v) {
    return static_cast<uint32_t>(v);
}

// int32 arithmetic shift of a wrapped value
__device__ __forceinline__ int32_t sra(uint32_t v, int n) {
    return static_cast<int32_t>(v) >> n;
}

__device__ __forceinline__ int bitlen(int32_t v) {
    return v > 0 ? 32 - __clz(v) : 0;
}

// torch.abs of an int32: INT32_MIN stays itself
__device__ __forceinline__ int32_t wabs(int32_t v) {
    return static_cast<int32_t>(v < 0 ? 0u - u32(v) : u32(v));
}

__device__ __forceinline__ int32_t sign(int32_t v) {
    return (v > 0) - (v < 0);
}

// torch.div(m, d, rounding_mode="floor")
__device__ __forceinline__ int32_t floordiv(int32_t m, int32_t d) {
    const int32_t q = m / d;
    return q - ((m % d != 0) && ((m < 0) != (d < 0)));
}

// contexts._div2_toward_zero, of a value far from the int32 limits
__device__ __forceinline__ int32_t div2(int32_t v) {
    return v < 0 ? -((-v) >> 1) : v >> 1;
}

// the bucket of a prediction: bit_length of |v| clamped to 1023
__device__ __forceinline__ int bsr_prior(int32_t v) {
    return bitlen(min(wabs(v), 1023));
}

// contexts._idct_rows on row y of a block: c the row's coefficients, q its
// quantizers, dc0 to ignore the DC coefficient
__device__ void idct_row(const int16_t* c, const int32_t* q, bool dc0,
                         int32_t* out) {
    uint32_t v[8];
    for (int x = 0; x < 8; ++x) v[x] = u32(c[x]) * u32(q[x]);
    if (dc0) v[0] = 0;
    uint32_t x0 = (v[0] << 11) + 128u;
    uint32_t x1 = v[4] << 11;
    uint32_t x2 = v[6], x3 = v[2], x4 = v[1], x5 = v[7], x6 = v[5];
    uint32_t x7 = v[3];
    uint32_t x8 = kW7 * (x4 + x5);
    const uint32_t a4 = x8 + (kW1 - kW7) * x4;
    const uint32_t a5 = x8 - (kW1 + kW7) * x5;
    x4 = a4;
    x5 = a5;
    x8 = kW3 * (x6 + x7);
    const uint32_t a6 = x8 - (kW3 - kW5) * x6;
    const uint32_t a7 = x8 - (kW3 + kW5) * x7;
    x6 = a6;
    x7 = a7;
    x8 = x0 + x1;
    x0 = x0 - x1;
    x1 = kW6 * (x3 + x2);
    const uint32_t a2 = x1 - (kW2 + kW6) * x2;
    const uint32_t a3 = x1 + (kW2 - kW6) * x3;
    x2 = a2;
    x3 = a3;
    x1 = x4 + x6;
    x4 = x4 - x6;
    x6 = x5 + x7;
    x5 = x5 - x7;
    x7 = x8 + x3;
    x8 = x8 - x3;
    x3 = x0 + x2;
    x0 = x0 - x2;
    x2 = u32(sra(kR2 * (x4 + x5) + 128u, 8));
    x4 = u32(sra(kR2 * (x4 - x5) + 128u, 8));
    out[0] = sra(x7 + x1, 8);
    out[1] = sra(x3 + x2, 8);
    out[2] = sra(x0 + x4, 8);
    out[3] = sra(x8 + x6, 8);
    out[4] = sra(x8 - x6, 8);
    out[5] = sra(x0 - x4, 8);
    out[6] = sra(x3 - x2, 8);
    out[7] = sra(x7 - x1, 8);
}

// contexts._idct_cols on column x of a block's first pass, stored as the
// int16 pixels of contexts.idct_blocks (the cast wraps)
__device__ void idct_col(const int32_t (*t)[kRowPad], int x, int16_t* px) {
    uint32_t y0 = (u32(t[0][x]) << 8) + 8192u;
    uint32_t y1 = u32(t[4][x]) << 8;
    uint32_t y2 = u32(t[6][x]), y3 = u32(t[2][x]), y4 = u32(t[1][x]);
    uint32_t y5 = u32(t[7][x]), y6 = u32(t[5][x]), y7 = u32(t[3][x]);
    uint32_t y8 = kW7 * (y4 + y5) + 4u;
    const uint32_t a4 = u32(sra(y8 + (kW1 - kW7) * y4, 3));
    const uint32_t a5 = u32(sra(y8 - (kW1 + kW7) * y5, 3));
    y4 = a4;
    y5 = a5;
    y8 = kW3 * (y6 + y7) + 4u;
    const uint32_t a6 = u32(sra(y8 - (kW3 - kW5) * y6, 3));
    const uint32_t a7 = u32(sra(y8 - (kW3 + kW5) * y7, 3));
    y6 = a6;
    y7 = a7;
    y8 = y0 + y1;
    y0 = y0 - y1;
    y1 = kW6 * (y3 + y2) + 4u;
    const uint32_t a2 = u32(sra(y1 - (kW2 + kW6) * y2, 3));
    const uint32_t a3 = u32(sra(y1 + (kW2 - kW6) * y3, 3));
    y2 = a2;
    y3 = a3;
    y1 = y4 + y6;
    y4 = y4 - y6;
    y6 = y5 + y7;
    y5 = y5 - y7;
    y7 = y8 + y3;
    y8 = y8 - y3;
    y3 = y0 + y2;
    y0 = y0 - y2;
    y2 = u32(sra(kR2 * (y4 + y5) + 128u, 8));
    y4 = u32(sra(kR2 * (y4 - y5) + 128u, 8));
    px[0 * 8 + x] = static_cast<int16_t>(sra(y7 + y1, 11));
    px[1 * 8 + x] = static_cast<int16_t>(sra(y3 + y2, 11));
    px[2 * 8 + x] = static_cast<int16_t>(sra(y0 + y4, 11));
    px[3 * 8 + x] = static_cast<int16_t>(sra(y8 + y6, 11));
    px[4 * 8 + x] = static_cast<int16_t>(sra(y8 - y6, 11));
    px[5 * 8 + x] = static_cast<int16_t>(sra(y0 - y4, 11));
    px[6 * 8 + x] = static_cast<int16_t>(sra(y3 - y2, 11));
    px[7 * 8 + x] = static_cast<int16_t>(sra(y7 - y1, 11));
}

// The tile of this CTA: its row r, first column c0 and number of blocks.
__device__ __forceinline__ int tile_of(const Plane& pl, int64_t& r,
                                       int64_t& c0) {
    r = blockIdx.y;
    c0 = static_cast<int64_t>(blockIdx.x) * kTile;
    return pl.width - c0 < kTile ? static_cast<int>(pl.width - c0) : kTile;
}

// Fills sm for the tile (r, c0, nt): the parameter block, the two rows of
// coefficients, their pixels and nonzero counts.  Ends with a barrier.
__device__ void load_tile(const Plane& pl, const Params& prm, Smem& sm,
                          int64_t r, int64_t c0, int nt) {
    for (int i = threadIdx.x; i < kParams; i += kThreads) sm.P[i] = prm.v[i];
    if (threadIdx.x == 0) sm.has_above = pl.has_above[r];
    const int4* src = reinterpret_cast<const int4*>(pl.coefs);
    for (int j = threadIdx.x; j < 2 * kSlots * 8; j += kThreads) {
        const int u = j >> 3, q = j & 7;
        const int s = u < kSlots ? u : u - kSlots;
        const int64_t rr = u < kSlots ? r : r - 1, cc = c0 - 1 + s;
        int4 v = make_int4(0, 0, 0, 0);
        if (rr >= 0 && cc >= 0 && s <= nt) {
            int64_t g = (rr * pl.width + cc) * 8 + q;
            LEP_CHECK(coefs, g, pl.rows * pl.width * 8);
            v = __ldg(src + g);
        }
        int32_t* dst = reinterpret_cast<int32_t*>(sm.coef[u]) + q * 4;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * kSlots * 8; j += kThreads) {
        const int u = j >> 3, y = j & 7;
        idct_row(sm.coef[u] + y * 8, sm.P + kQuant + y * 8, y == 0,
                 sm.scratch.rows[u][y]);
    }
    for (int u = threadIdx.x; u < 2 * kSlots; u += kThreads) {
        int n = 0;
        for (int k = 9; k < 64; ++k) n += (k & 7) != 0 && sm.coef[u][k] != 0;
        sm.nz[u] = static_cast<uint8_t>(n);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * kSlots * 8; j += kThreads) {
        const int u = j >> 3;
        idct_col(sm.scratch.rows[u], j & 7, sm.pix[u]);
    }
    __syncthreads();
}

// What the walk of tile block t knows of its place in the plane.
struct Where {
    int t;
    bool has_left, has_above;
    bool top;        // row 0: the row above is not in the plane
};

// contexts.aavrg_all at raster position pos
__device__ __forceinline__ int32_t aavrg(const Smem& sm, const Where& w,
                                         int pos) {
    const int32_t l = abs(static_cast<int32_t>(sm.coef[w.t][pos]));
    const int32_t a = abs(static_cast<int32_t>(sm.coef[kSlots + w.t + 1][pos]));
    const int32_t al = abs(static_cast<int32_t>(sm.coef[kSlots + w.t][pos]));
    if (w.has_left && w.has_above) return ((13 * (l + a) + 6 * al) & 0xFFFF) >> 5;
    return w.has_left ? l : w.has_above ? a : 0;
}

// contexts.lak_all's prediction of edge coefficient l + 1 (e 0: the
// horizontal edge, from the block above) or 8 (l + 1) (e 1: the vertical
// edge, from the block to the left); 0 without that neighbour
__device__ int32_t lak(const Smem& sm, const Where& w, int e, int l) {
    if (e == 0 ? !w.has_above : !w.has_left) return 0;
    const int band = l + 1;
    const int16_t* x = sm.coef[w.t + 1];
    const int16_t* a = e == 0 ? sm.coef[kSlots + w.t + 1] : sm.coef[w.t];
    const int32_t* icos = sm.P + (e == 0 ? kIcosX : kIcosY) + band * 8;
    // element i: (row i, column band) across the horizontal edge's band,
    // (row band, column i) along the vertical's
    const int at0 = e == 0 ? band : band * 8, step = e == 0 ? 8 : 1;
    uint32_t s = 0;
    for (int i = 1; i < 8; ++i) {
        const int k = at0 + i * step;
        const int32_t d = (i & 1) ? x[k] + a[k] : x[k] - a[k];
        s += u32(icos[i]) * u32(d);
    }
    const int32_t pred = static_cast<int32_t>(u32(a[at0]) * u32(icos[0]) - s);
    return static_cast<int32_t>(u32(sign(pred))
                                * u32(floordiv(wabs(pred), icos[0])));
}

// contexts.neighbor_summaries' edge pixel: the block's DC times q0, plus
// an edge pixel `cur`, 1024 and half its step from `prev`, as int16
__device__ __forceinline__ int32_t edge(int32_t dc, int32_t q0, int32_t cur,
                                        int32_t prev) {
    return static_cast<int16_t>(u32(dc) * u32(q0)
                                + u32(cur + 1024 + div2(cur - prev)));
}

// contexts.dc_predictions: the DC prediction and its two uncertainties
__device__ void dc_context(const Smem& sm, const Where& w, int32_t& pred,
                           int32_t& unc, int32_t& unc2) {
    const int16_t* px = sm.pix[w.t + 1];
    const int32_t q0 = sm.P[kQuant];
    int32_t lo = 1 << 30, hi = -(1 << 30), sum_l = 0, sum_a = 0;
    if (w.has_left) {
        const int16_t* lp = sm.pix[w.t];
        const int32_t dc = sm.coef[w.t][0];
        for (int y = 0; y < 8; ++y) {
            const int32_t p0 = px[y * 8], p1 = px[y * 8 + 1];
            const int32_t est = static_cast<int16_t>(
                edge(dc, q0, lp[y * 8 + 7], lp[y * 8 + 6]) - div2(p0 - p1)
                - (p0 + 1024));
            lo = min(lo, est);
            hi = max(hi, est);
            sum_l += est;
        }
    }
    if (w.has_above) {
        const int16_t* ap = sm.pix[kSlots + w.t + 1];
        const int32_t dc = sm.coef[kSlots + w.t + 1][0];
        for (int x = 0; x < 8; ++x) {
            const int32_t p0 = px[x], p1 = px[8 + x];
            const int32_t e = w.top ? 0 : edge(dc, q0, ap[56 + x], ap[48 + x]);
            const int32_t est = static_cast<int16_t>(e - div2(p0 - p1)
                                                     - (p0 + 1024));
            lo = min(lo, est);
            hi = max(hi, est);
            sum_a += est;
        }
    }
    const bool any = w.has_left || w.has_above;
    const int32_t avg_h = w.has_left ? sum_l : sum_a;
    const int32_t avg_v = w.has_left && w.has_above ? sum_a : avg_h;
    const int32_t overall = (avg_h + avg_v) >> 1;
    const int32_t dh = avg_h - overall, dv = avg_v - overall;
    unc = any ? (hi - lo) >> 3 : 0;
    unc2 = any ? (abs(dh) < abs(dv) ? dh : dv) >> 3 : 0;
    const int32_t avgmed = any ? overall : 0;
    pred = (sign(avgmed) * floordiv(abs(avgmed), q0) + 4) >> 3;
}

// Where a walk puts its symbols: counted only (kEmit false), or also
// staged at pos - w0 where pos lies in the window [w0, w1).
template <bool kEmit>
struct Sink {
    int32_t* idx;
    uint8_t* bit;
    int64_t pos, w0, w1;

    __device__ __forceinline__ void put(int32_t i, int b) {
        if (kEmit && pos >= w0 && pos < w1) {
            idx[pos - w0] = i;
            bit[pos - w0] = static_cast<uint8_t>(b);
        }
        ++pos;
    }

    // exponent unary: bit (n != i) at base + i, i = 0..min(n, 10)
    __device__ __forceinline__ void put_exp(int32_t base, int n) {
        const int top = min(n, kMaxExponent - 1);
        for (int i = 0; i <= top; ++i) put(base + i, n != i);
    }

    // residual: bit i of a at base + i, i = n-2 down, at most kCoefBits
    __device__ __forceinline__ void put_res(int32_t base, int n, int32_t a) {
        for (int i = n - 2; i >= max(n - 1 - kCoefBits, 0); --i) {
            put(base + i, (a >> i) & 1);
        }
    }
};

// Tile block w.t's symbols into out; returns whether it codes a value
// past 11 bits.
template <bool kEmit>
__device__ bool walk(const Smem& sm, const Where& w, int ci,
                     Sink<kEmit>& out) {
    const int32_t* P = sm.P;
    const int16_t* co = sm.coef[w.t + 1];
    const int nz7 = sm.nz[w.t + 1];

    // ---- the 7x7 nonzero count, a 6-bit tree
    const int nl = w.has_left ? sm.nz[w.t] : 0;
    const int na = sm.nz[kSlots + w.t + 1];
    int ctx = 0;
    if (w.has_left && w.has_above) {
        ctx = (na + nl + 2) / 4;
    } else if (w.has_above) {
        ctx = (na + 1) / 2;
    } else if (w.has_left) {
        ctx = (nl + 1) / 2;
    }
    const int32_t nz_base = P[NZ_7X7] + ci * P[NZ_7X7_S0]
                            + P[kNzBin + ctx] * P[NZ_7X7_S1];
    for (int i = 5; i >= 0; --i) {
        out.put(nz_base + i * P[NZ_7X7_S2] + (nz7 >> (i + 1)),
                (nz7 >> i) & 1);
    }

    // ---- the 49 interior coefficients in zigzag order, to the last
    // nonzero one
    const int32_t res_base = P[RESIDUAL_NOISE] + ci * P[RESIDUAL_NOISE_S0];
    const int32_t sign_base = P[SIGN] + ci * P[SIGN_S0];
    const int32_t exp_base = P[EXP_7X7] + ci * P[EXP_7X7_S0];
    bool over = false;
    int eob_x = 0, eob_y = 0;
    int nz_left = nz7;
    for (int k = 0; k < 49 && nz_left > 0; ++k) {
        const int pos = P[kUnzig + k];
        const int32_t v = co[pos];
        const int32_t a = wabs(v);
        const int n = bitlen(a);
        const int bsr = bsr_prior(aavrg(sm, w, pos));
        const int nnzb = P[kNzBin + min(nz_left, 49)];
        out.put_exp(exp_base + nnzb * P[EXP_7X7_S1] + k * P[EXP_7X7_S2]
                + bsr * P[EXP_7X7_S3], n);
        if (n > 0) out.put(sign_base, v >= 0);
        out.put_res(res_base + pos * P[RESIDUAL_NOISE_S1]
                + nnzb * P[RESIDUAL_NOISE_S2], n, a);
        over |= n > kMaxExponent;
        if (v != 0) {
            --nz_left;
            eob_x = max(eob_x, pos & 7);
            eob_y = max(eob_y, pos >> 3);
        }
    }

    // ---- the horizontal edge (coords 1..7), then the vertical (8..56)
    const int32_t expx_base = P[EXP_X] + ci * P[EXP_X_S0];
    const int32_t rt_base = P[RESIDUAL_THRESH] + ci * P[RESIDUAL_THRESH_S0];
    constexpr int cap = (1 << kNoiseFloor) - 1;
    for (int e = 0; e < 2; ++e) {
        const int step = e == 0 ? 1 : 8;
        const int zig15 = e == 0 ? 0 : 7;
        const int t = e == 0 ? NZ_8X1 : NZ_1X8;   // offset, then 4 strides
        const int est_eob = e == 0 ? eob_x : eob_y;
        int cnt = 0;
        for (int l = 1; l < 8; ++l) cnt += co[l * step] != 0;
        const int32_t nz_slice = P[t] + ci * P[t + 1] + est_eob * P[t + 2]
                                 + ((nz7 + 3) / 7) * P[t + 3];
        for (int i = 2; i >= 0; --i) {
            out.put(nz_slice + i * P[t + 4] + (cnt >> (i + 1)),
                    (cnt >> i) & 1);
        }
        int remaining = cnt;
        for (int l = 0; l < 7 && remaining > 0; ++l) {
            const int coord = (l + 1) * step;
            const int32_t v = co[coord];
            const int32_t a = wabs(v);
            const int n = bitlen(a);
            const int32_t bp = lak(sm, w, e, l);
            const int bsr = bsr_prior(bp);
            out.put_exp(expx_base + remaining * P[EXP_X_S1]
                    + (zig15 + l) * P[EXP_X_S2] + bsr * P[EXP_X_S3], n);
            if (v != 0) {
                const int ctx1 = bp == 0 ? 0 : bp > 0 ? 1 : 2;
                out.put(sign_base + ctx1 * P[SIGN_S1] + bsr, v >= 0);
            }
            over |= n > kMaxExponent;
            const int mt = P[kNoise + coord];
            const int32_t t1 = min(wabs(bp) >> mt, 255);
            const int t2 = min(n - mt, kNoiseFloor);
            const int32_t thresh = rt_base + t1 * P[RESIDUAL_THRESH_S1]
                                   + t2 * P[RESIDUAL_THRESH_S2];
            const int32_t res = res_base + coord * P[RESIDUAL_NOISE_S1]
                                + remaining * P[RESIDUAL_NOISE_S2];
            int so_far = 1;
            for (int i = n - 2; i >= max(n - 1 - kCoefBits, 0); --i) {
                const int bit = (a >> i) & 1;
                if (i >= mt) {
                    out.put(thresh + so_far, bit);
                    so_far = min((so_far << 1) | bit, cap);
                } else {
                    out.put(res + i, bit);
                }
            }
            if (v != 0) --remaining;
        }
    }

    // ---- DC: the delta from the pixel-domain prediction, wrapped into
    // [-1024, 1024]
    int32_t dc_pred, unc, u2;
    dc_context(sm, w, dc_pred, unc, u2);
    constexpr int32_t maxv = 1 << (kMaxExponent - 1);
    int32_t delta = static_cast<int32_t>(u32(co[0]) - u32(dc_pred));
    if (delta < -maxv) delta += 2 * maxv + 1;
    if (delta > maxv) delta -= 2 * maxv + 1;
    const int32_t a = wabs(delta);
    const int n = bitlen(a);
    const int lm = min(bitlen(wabs(unc)), kNumericLengthMax - 1);
    const int lo = min(bitlen(wabs(u2)), 16);
    out.put_exp(P[EXP_DC] + lm * P[EXP_DC_S0] + lo * P[EXP_DC_S1], n);
    if (n > 0) out.put(sign_base + (u2 < 0 ? 1 : u2 == 0 ? 3 : 2), delta >= 0);
    out.put_res(P[RESIDUAL_NOISE_DC] + lm * P[RESIDUAL_NOISE_DC_S0], n, a);
    return over || n > kMaxExponent;
}

// the size_limit rule: blocks past it code nothing, but block 0 of every
// row codes (the host tests the limit after each block)
__device__ __forceinline__ bool live(const Plane& pl, int64_t b) {
    return pl.row_block_offset + b < pl.size_limit || b % pl.width == 0;
}

__device__ __forceinline__ Where where(const Smem& sm, int64_t r,
                                       int64_t c, int t) {
    return Where{t, c > 0, sm.has_above != 0, r == 0};
}

__global__ void __launch_bounds__(kThreads)
symbol_counts_kernel(const Plane pl, const __grid_constant__ Params prm,
                     int32_t* __restrict__ counts,
                     uint8_t* __restrict__ over) {
    __shared__ Smem sm;
    int64_t r, c0;
    const int nt = tile_of(pl, r, c0);
    load_tile(pl, prm, sm, r, c0, nt);
    const int t = threadIdx.x;
    if (t >= nt) return;
    const int64_t b = r * pl.width + c0 + t;
    Sink<false> out{nullptr, nullptr, 0, 0, 0};
    const bool o = live(pl, b) && walk(sm, where(sm, r, c0 + t, t), pl.ci,
                                       out);
    counts[b] = static_cast<int32_t>(out.pos);
    over[b] = o;
}

__global__ void __launch_bounds__(kThreads)
symbol_emit_kernel(const Plane pl, const __grid_constant__ Params prm,
                   const int64_t* __restrict__ offsets,
                   int32_t* __restrict__ idx, uint8_t* __restrict__ bit,
                   int64_t n_out) {
    __shared__ Smem sm;
    int64_t r, c0;
    const int nt = tile_of(pl, r, c0);
    const int64_t b0 = r * pl.width + c0, n = pl.rows * pl.width;
    // the tile's range of the output: its blocks' offsets, then the next
    // tile's first (or the output's end)
    for (int i = threadIdx.x; i <= nt; i += kThreads) {
        sm.off[i] = b0 + i < n ? offsets[b0 + i] : n_out;
    }
    load_tile(pl, prm, sm, r, c0, nt);
    const int t = threadIdx.x;
    const int64_t lo = sm.off[0], hi = sm.off[nt];
    const bool walker = t < nt && live(pl, b0 + t);
    const int64_t start = walker ? sm.off[t] : 0;
    const int64_t end = walker ? sm.off[t + 1] : 0;
    int32_t* s_idx = sm.scratch.stage.idx;
    uint8_t* s_bit = sm.scratch.stage.bit;
    // rounds of kStage symbols; every live block walks in the first
    bool first = true;
    for (int64_t w0 = lo; first || w0 < hi; w0 += kStage) {
        const int64_t w1 = hi - w0 < kStage ? hi : w0 + kStage;
        if (walker && (first || (start < w1 && end > w0))) {
            Sink<true> out{s_idx, s_bit, start, w0, w1};
            const bool o = walk(sm, where(sm, r, c0 + t, t), pl.ci, out);
            if (o && start >= w0 && start < w1) s_idx[start - w0] = kOutOfRange;
            if (first && out.pos > start) {
                (void)LEP_OK(out, out.pos - 1, hi);
                (void)LEP_OK(out, start - lo, hi - lo);
            }
        }
        __syncthreads();
        for (int64_t k = threadIdx.x; k < w1 - w0; k += kThreads) {
            const int64_t g = w0 + k;
            if (LEP_OK(out, g, n_out)) {
                idx[g] = s_idx[k];
                bit[g] = s_bit[k];
            }
        }
        __syncthreads();
        first = false;
    }
}

// The plane's arguments as the launch functions take them, or false when
// the parameter block is not kParams values long, the coefficients are
// not 16-byte aligned or the plane has more rows than a grid.
bool make_plane(Plane* pl, Params* prm, const void* coefs,
                const void* has_above, int64_t rows, int64_t width,
                int64_t row_block_offset, int64_t size_limit, int ci,
                const int32_t* params, int nparams) {
    if (nparams != kParams || reinterpret_cast<uintptr_t>(coefs) % 16 != 0
            || rows > 65535 || rows < 0 || width < 0) {
        return false;
    }
    *pl = Plane{static_cast<const int16_t*>(coefs),
                static_cast<const uint8_t*>(has_above),
                rows, width, row_block_offset, size_limit, ci};
    std::memcpy(prm->v, params, sizeof(prm->v));
    return true;
}

dim3 grid(int64_t rows, int64_t width) {
    return dim3(static_cast<unsigned>((width + kTile - 1) / kTile),
                static_cast<unsigned>(rows));
}

}  // namespace

extern "C" {

// Writes counts int32 [rows * width] and over uint8 [rows * width] (bool)
// of the plane, a CTA a tile of kTile blocks of a row, on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// make_plane refuses.
int symbol_counts_launch(const void* coefs, const void* has_above,
                         int64_t rows, int64_t width,
                         int64_t row_block_offset, int64_t size_limit,
                         int ci, const int32_t* params, int nparams,
                         int32_t* counts, uint8_t* over, void* stream) {
    Plane pl;
    Params prm;
    if (!make_plane(&pl, &prm, coefs, has_above, rows, width,
                    row_block_offset, size_limit, ci, params, nparams)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
    symbol_counts_kernel<<<grid(rows, width), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pl, prm, counts, over);
    return static_cast<int>(cudaGetLastError());
}

// Writes each block's symbols at offsets[block] (int64 [rows * width]) of
// idx int32 [n_out] and bit uint8 [n_out], a CTA a tile, on `stream`;
// returns as symbol_counts_launch.
int symbol_emit_launch(const void* coefs, const void* has_above,
                       int64_t rows, int64_t width,
                       int64_t row_block_offset, int64_t size_limit, int ci,
                       const int32_t* params, int nparams,
                       const int64_t* offsets, int32_t* idx, uint8_t* bit,
                       int64_t n_out, void* stream) {
    Plane pl;
    Params prm;
    if (!make_plane(&pl, &prm, coefs, has_above, rows, width,
                    row_block_offset, size_limit, ci, params, nparams)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
    symbol_emit_kernel<<<grid(rows, width), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pl, prm, offsets, idx, bit, n_out);
    return static_cast<int>(cudaGetLastError());
}

const char* symbolize_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
