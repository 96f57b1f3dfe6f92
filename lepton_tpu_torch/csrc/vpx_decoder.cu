// vpx_decoder.cu -- per-segment token decoder for Hopper (sm_90a), with a
// VPX reader (containers v1 and v2) and a rANS reader (container v3).
//
// Replaces lepton_tpu/kernels/pallas_decode.py::_build_kernel (the inner
// `kernel`, :270-763, with coder="vpx" and coder="ans"; host side
// decode_segments_pallas / decode_segments_pallas_multi).  The kernel is a
// template on the reader, so the block-decoding body is one and the same
// for both; vpx_decoder_launch picks the instantiation.  For each lane (one
// segment of one .lep) the VPX reader reads the marker bit at probability
// 128 (the rANS reader has none), then for each row descriptor
// and each block of the row, in order: the 7x7 non-zero count (a 6-bit
// tree), the 49 interior coefficients (aavrg-bucketed unary exponent, sign,
// residual), the horizontal then the vertical edge (Lakhani prediction,
// threshold-contexted residual), the DC (pixel-domain prediction through
// an IDCT that ignores the DC), and the block's outgoing neighbour summary
// (reference decoder.cc:168-319, decode_one_edge :29-142, model.hh).  Every
// read is an adaptive branch read-modify-write (vpx_branch.cuh, the same
// rule and layout as the coders), from the identity arena or a trained
// template; the VPX reader updates a branch by update_branch, the rANS
// reader by update_branch_adv.  A lane whose 7x7 count exceeds 49 sets its
// sticky err flag.
//
// Bound: one dependent chain a lane.  Each read's branch index depends on
// the bit just decoded, so a launch takes about as long as its longest
// lane's reads; it moves few bytes (streams in, int16 planes out, the
// arena fill).  What lengthens the chain is each read's wait for its
// branch, the branch update, and whatever else runs between reads.
//
// Design: one CTA of four warps a lane; lanes are independent and run
// concurrently (the TPU grid ran them one after another).
// - The lane's model arena is ARENA_SIZE int32 (2.89 MB), far above the
//   227 KB of shared memory, and stays in device memory as the backing
//   store (torch.empty scratch, filled by all four warps, which then
//   clear the cache and exit but warp 0).  A lane touches only a few
//   thousand distinct branches, so each read looks its branch up in a
//   branch cache in dynamic shared memory: open addressing, insert-only,
//   never evicting.  An entry is 64 bits, the packed branch in the low
//   word and (branch index + 1) in the high word, 0 for empty; the slot is
//   a multiplicative hash of the index (the tables' strides are powers of
//   two), probed linearly over kProbes slots.  A branch met for the first
//   time is copied from the arena into the first empty slot; when all
//   probed slots hold other branches, the read goes to the arena, as
//   every read did before.  A slot is never freed, so a branch is always
//   found where it was put or always falls through: the result is exact
//   whatever the fill, with no write-back.
// - A read's chain is kept short: the update's division is a multiply by
//   a reciprocal from a table in shared memory (vpx_branch.cuh), loaded
//   for both outcomes while the reader decodes the bit, and the updated
//   branch is stored only after the next read has loaded its entry.
// - Warp 0 runs the reads, every lane the same ones, so its control flow
//   never diverges; the block work around them is split across its lanes
//   between __syncwarp()s: loading the above block and its ring summary
//   (the next block's loaded a block ahead, into registers), zeroing the
//   block, the interior contexts (aavrg buckets), the 14 Lakhani edge
//   predictions, the IDCT (rows, then columns), the DC's edge estimates
//   with warp reductions, the outgoing summaries and the int16 copy-out.
// - The stream is read straight from device memory: a VPX refill issues
//   its (up to four) byte loads together, and the rANS reader holds the
//   next word in a register, loaded one renormalisation ahead.  A refill
//   comes every few dozen reads, so staging the stream in shared memory
//   (as the coders' walks stage their input) has little to take off.
// Each lane counts the branches it inserted into the cache and the reads
// that fell through to the arena (counts [S, 2]).  The above block is read
// back from the output plane (the lane decoded the row above itself); the
// above row's summaries (non-zero count and horizontal edge) live in a
// per-lane ring in device memory, ncomp x widest row.  Coefficients are
// stored as int16 straight into the zero-initialised planes, so rows cut
// by early EOF stay zero.
//
// Arithmetic follows the reference's C ints: a uint32 VPX reader window
// and uint64 rANS states, truncating division for the Lakhani and DC
// predictions, int16 wraps on stores, IDCT outputs, edge estimates and
// summaries.
//
// Bounds checks (checked.cuh; compiled in only with -DLEPTON_CHECKED): the
// row and table descriptors against the row count, kMaxTables and the
// table count; the above block, each block store and the ring against the
// planes' block count, ring_slots and ring_width; every branch-cache slot;
// the arena index after its clamp; the stream's bytes and words against
// lmax; err and counts against the lane count.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"
#include "vpx_branch.cuh"

namespace {

constexpr int kThreads = 128;      // warp 0 decodes; all four fill
constexpr int kMaxTables = 4;      // kernels/vpx_decoder.py MAX_TABLES
constexpr int kRowFields = 7;      // ROW_FIELDS
constexpr int kLaneFields = 4;     // LANE_FIELDS
constexpr int kSummary = 9;        // SUMMARY: nz7, horizontal edge [8]
constexpr int kLuts = 256;
constexpr int32_t kLotsOfBits = 0x40000000;
constexpr int kMaxExponent = 11;
constexpr int kNoiseFloor = 7;     // RESIDUAL_NOISE_FLOOR
constexpr int kNumericLengthMax = 12;
// dynamic shared memory before the branch cache (FIXED_SMEM), and the
// cache's linear probe length (CACHE_PROBES)
constexpr int kFixedSmem = 10240;
constexpr int kProbes = 8;
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kArenaSlot = -1;     // the read went to the device arena

// LUT layout (vpx_decoder.build_luts): unzigzag49 at 0, nonzero_to_bin at
// 64, (n + 3) / 7 at 128, then each model table's offset and strides.
enum Lut : int {
    kUnzig = 0, kNzBin = 64, kNz73 = 128,
    kNz77 = 192,                 // off, s0, s1, s2
    kExp77 = kNz77 + 4,          // off, s0, s1, s2, s3
    kRes = kExp77 + 5,           // off, s0, s1, s2
    kSign = kRes + 4,            // off, s0, s1
    kExpX = kSign + 3,           // off, s0, s1, s2, s3
    kThresh = kExpX + 5,         // off, s0, s1, s2
    kExpDc = kThresh + 4,        // off, s0, s1
    kResDc = kExpDc + 3,         // off, s0
    kNz81 = kResDc + 2,          // off, s0, s1, s2, s3
    kNz18 = kNz81 + 5,           // off, s0, s1, s2, s3
};

// IDCT constants (idct.cc)
constexpr int W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108,
              W7 = 565, R2 = 181;

// The CTA's fixed shared memory; the branch cache follows at kFixedSmem.
struct Shared {
    int32_t lut[kLuts];
    int32_t tab[kMaxTables * 4 * 64];
    int32_t here[64], left[64], above[64], al[64], pix[64], tmp[64];
    int32_t ctx7[64];            // interior: exponent context but nnzb
    // edges [e * 7 + k]: exponent context but `remaining`, sign branch,
    // threshold context but the length term, noise bits mt, residual base
    int32_t ectx[16], esign[16], ethr[16], emt[16], eres[16];
    int32_t summ_a[12];          // the above block's ring summary
    int32_t left_vert[8];
    int32_t nz7, eob_x, eob_y, dc;
    uint32_t rcp[vpx::kRecipSize];   // the branch update's reciprocals
};
static_assert(sizeof(Shared) <= kFixedSmem, "kFixedSmem too small");

__device__ __forceinline__ int32_t wrap16(int32_t v) {
    return static_cast<int16_t>(v);
}
__device__ __forceinline__ int32_t div2_tz(int32_t v) {
    return v < 0 ? -((-v) >> 1) : v >> 1;
}
__device__ __forceinline__ int bitlen(int32_t v) {  // v >= 0
    return v > 0 ? 32 - __clz(v) : 0;
}

// The VPX bool reader with a 32-bit window (boolreader.hh:376-416), over
// the lane's stream bytes, after the marker bit (vpx_reader_init).
struct VpxReader {
    const uint8_t* p;
    int32_t len;
    int32_t pos;
    uint32_t value;
    uint32_t rng;
    int32_t count;
    int64_t lim;                 // the lane's row of bytes (checked builds)

    __device__ VpxReader(const void* data, int64_t lmax, int64_t s,
                         int32_t dlen)
        : p(static_cast<const uint8_t*>(data) + s * lmax), len(dlen), pos(0),
          value(0), rng(255), count(-8), lim(lmax) {
        bit(128);
    }

    __device__ __forceinline__ int bit(uint32_t prob) {
        if (count < 0) {
            // the byte-wise refill while shift = 16 - count >= 0, as one
            // step: the bytes it takes are loaded together; past the
            // stream's end LOTS_OF_BITS is added once
            const int shift = 16 - count;
            const int want = (shift >> 3) + 1;
            const int take = min(want, len - pos);
            uint32_t add = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < take && LEP_OK(vpx_bytes, pos + j, lim)) {
                    add |= static_cast<uint32_t>(p[pos + j]) << (shift - 8 * j);
                }
            }
            value |= add;
            pos += take;
            count += 8 * take + (take < want ? kLotsOfBits : 0);
        }
        const uint32_t split = (rng * prob + (256 - prob)) >> 8;
        const uint32_t big = split << 24;
        const int b = value >= big;
        if (b) {
            rng -= split;
            value -= big;
        } else {
            rng = split;
        }
        const int sh = __clz(static_cast<int>(rng)) - 24;
        rng <<= sh;
        value <<= sh;
        count -= sh;
        return b;
    }

    static __device__ __forceinline__ int32_t update(const vpx::Next& n,
                                                     int b) {
        return vpx::update_branch(n, b);
    }
};

// The two-state rANS forward reader (ans_bool_reader.hh, the rans64.hh
// decode step; pallas_decode.py ans_step :330-360 and its init :436-440)
// over the lane's little-endian uint32 words.  Native uint64_t states
// replace the (hi, lo) int32 pairs and 16-bit limbs the TPU needed.  Words
// past the end read as zero; there is no marker bit.  The next word waits
// in a register, loaded one renormalisation ahead.
struct AnsReader {
    const uint32_t* w;
    int32_t nwords;
    int32_t pos;
    uint64_t r0, r1;
    uint32_t next;
    int64_t lim;                 // the lane's row of words (checked builds)

    __device__ AnsReader(const void* data, int64_t lmax, int64_t s,
                         int32_t dlen)
        : w(static_cast<const uint32_t*>(data) + s * lmax), nwords(dlen),
          pos(4), lim(lmax) {
        r0 = word(0) | static_cast<uint64_t>(word(1)) << 32;
        r1 = word(2) | static_cast<uint64_t>(word(3)) << 32;
        next = word(pos);
    }

    __device__ __forceinline__ uint32_t word(int32_t k) const {
        return k < nwords && LEP_OK(ans_words, k, lim) ? w[k] : 0;
    }

    __device__ __forceinline__ int bit(uint32_t prob) {
        uint64_t x = r0;
        r0 = r1;
        const uint32_t cum = static_cast<uint32_t>(x) & 0xFF;
        const int b = cum >= prob;
        const uint32_t start = b ? prob : 0;
        const uint32_t freq = b ? 256 - prob : prob;
        x = freq * (x >> 8) + cum - start;
        if (x < (1ull << 31)) {        // renormalise: one word, unsigned test
            x = x << 32 | next;
            ++pos;
            next = word(pos);
        }
        r1 = x;
        return b;
    }

    static __device__ __forceinline__ int32_t update(const vpx::Next& n,
                                                     int b) {
        return vpx::update_branch_adv(n, b);
    }
};

// The slow path of a branch-cache lookup of branch idx (key idx + 1),
// whose first probed slot `h` did not hold it: probe from h for the key or
// an empty slot (copying the branch from the arena into it), else give the
// read to the arena.  Returns (packed branch, slot | kInserted for a new
// entry, or kArenaSlot).
constexpr int kInserted = 1 << 30;

__device__ __forceinline__ int2 cache_miss(uint2* cache, uint32_t slots,
                                        const int32_t* arena, int idx,
                                        uint32_t key, uint32_t h) {
    uint32_t slot = h;
    for (int i = 0; i < kProbes; ++i) {
        LEP_CHECK(cache_probe, slot, slots);
        const uint2 e = cache[slot];
        if (e.y == key) {
            return make_int2(static_cast<int32_t>(e.x),
                             static_cast<int>(slot));
        }
        if (e.y == 0) {
            const int32_t packed = arena[idx];
            cache[slot] = make_uint2(static_cast<uint32_t>(packed), key);
            return make_int2(packed, static_cast<int>(slot) | kInserted);
        }
        slot = slot + 1 == slots ? 0 : slot + 1;
    }
    return make_int2(arena[idx], kArenaSlot);
}

// Adaptive reads through reader R, each from the lane's branch cache in
// shared memory, or from the lane's arena in device memory on a branch's
// first use (copied into the cache) or when its probed slots are full.
// A read's new branch value is stored into the cache only after the next
// read has loaded its entry (forwarded when both are the same slot), so
// that load does not wait for the update; the store is repeated after a
// read that went to the arena, which leaves the slot as it was.
template <class R>
struct Model {
    R r;
    int32_t* arena;
    int arena_size;
    uint2* cache;                // .x packed branch, .y index + 1 (0: empty)
    uint32_t slots;
    const uint32_t* rcp;         // vpx_branch.cuh reciprocals
    int inserts = 0;
    int falls = 0;
    int pslot = 0;               // the pending store: cache[pslot].x = pval
    int32_t pval = 0;            // (slot 0 is empty before the first read)

    // adaptive read of branch idx (clamped into the arena, as the TPU
    // kernel clamps), then the branch update of R's coder
    __device__ __forceinline__ int read(int idx) {
        idx = min(max(idx, 0), arena_size - 1);
        LEP_CHECK(arena, idx, arena_size);
        const uint32_t key = static_cast<uint32_t>(idx) + 1;
        uint32_t h = __umulhi(key * kHashMul, slots);
        LEP_CHECK(cache_home, h, slots);
        const uint2 e = cache[h];
        LEP_CHECK(cache_pending, pslot, slots);
        cache[pslot].x = static_cast<uint32_t>(pval);
        int32_t packed = static_cast<int>(h) == pslot
                             ? pval : static_cast<int32_t>(e.x);
        int slot = static_cast<int>(h);
        if (e.y != key) {
            const int2 m = cache_miss(cache, slots, arena, idx, key, h);
            packed = m.x;
            slot = m.y;
            if (slot == kArenaSlot) {
                ++falls;
            } else if (slot & kInserted) {
                ++inserts;
                slot &= ~kInserted;
            }
        }
        // the next counts and their reciprocals are loaded while the
        // reader decodes
        const vpx::Next next = vpx::next_counts(packed, rcp);
        const int b = r.bit(vpx::branch_prob(packed));
        const int32_t nv = R::update(next, b);
        if (slot != kArenaSlot) {
            pslot = slot;
            pval = nv;
        } else {
            arena[idx] = nv;
        }
        return b;
    }

    __device__ __forceinline__ int tree(int nbits, int base, int stride) {
        int v = 0, so_far = 0;
        for (int i = nbits - 1; i >= 0; --i) {
            const int b = read(base + i * stride + so_far);
            v |= b << i;
            so_far = (so_far << 1) | b;
        }
        return v;
    }

    // unary exponent: reads while the bits are 1, at most kMaxExponent
    __device__ __forceinline__ int exponent(int base) {
        int length = 0;
        while (length < kMaxExponent && read(base + length)) ++length;
        return length;
    }

    // residual bits length-2 down to 0, every one of them as the host
    // codec reads them (leptonc.c decode_block): up to kMaxExponent - 1
    __device__ __forceinline__ int residual(int length, int base) {
        int acc = 0;
        for (int i = length - 2; i >= 0; --i) {
            acc |= read(base + i) << i;
        }
        return acc;
    }
};

__device__ __forceinline__ int32_t signed_value(int length, int sbit,
                                                int32_t mag) {
    const int32_t v = mag | (1 << (length - 1));
    return sbit ? v : -v;
}

// Row y of the fixed-point IDCT with the DC ignored (idct.cc scalar
// semantics): raster coefficients in, the row pass into tmp.
__device__ void idct_row(const int32_t* here, const int32_t* quant, int y,
                         int32_t* tmp) {
    int32_t r[8];
    for (int i = 0; i < 8; ++i) r[i] = here[y * 8 + i] * quant[y * 8 + i];
    if (y == 0) r[0] = 0;
    int32_t x0 = r[0] * 2048 + 128, x1 = r[4] * 2048;
    int32_t x2 = r[6], x3 = r[2], x4 = r[1], x5 = r[7], x6 = r[5],
            x7 = r[3];
    int32_t x8 = W7 * (x4 + x5);
    x4 = x8 + (W1 - W7) * x4;
    x5 = x8 - (W1 + W7) * x5;
    x8 = W3 * (x6 + x7);
    x6 = x8 - (W3 - W5) * x6;
    x7 = x8 - (W3 + W5) * x7;
    x8 = x0 + x1;
    x0 -= x1;
    x1 = W6 * (x3 + x2);
    x2 = x1 - (W2 + W6) * x2;
    x3 = x1 + (W2 - W6) * x3;
    x1 = x4 + x6;
    x4 -= x6;
    x6 = x5 + x7;
    x5 -= x7;
    x7 = x8 + x3;
    x8 -= x3;
    x3 = x0 + x2;
    x0 -= x2;
    x2 = (R2 * (x4 + x5) + 128) >> 8;
    x4 = (R2 * (x4 - x5) + 128) >> 8;
    int32_t* t = tmp + y * 8;
    t[0] = (x7 + x1) >> 8;
    t[1] = (x3 + x2) >> 8;
    t[2] = (x0 + x4) >> 8;
    t[3] = (x8 + x6) >> 8;
    t[4] = (x8 - x6) >> 8;
    t[5] = (x0 - x4) >> 8;
    t[6] = (x3 - x2) >> 8;
    t[7] = (x7 - x1) >> 8;
}

// Column x of the IDCT's column pass: tmp in, int16-wrapped pixels out.
__device__ void idct_col(const int32_t* tmp, int x, int32_t* out) {
    const int32_t* c = tmp + x;
    int32_t y0 = c[0] * 256 + 8192, y1 = c[32] * 256;
    int32_t y2 = c[48], y3 = c[16], y4 = c[8], y5 = c[56], y6 = c[40],
            y7 = c[24];
    int32_t y8 = W7 * (y4 + y5) + 4;
    y4 = (y8 + (W1 - W7) * y4) >> 3;
    y5 = (y8 - (W1 + W7) * y5) >> 3;
    y8 = W3 * (y6 + y7) + 4;
    y6 = (y8 - (W3 - W5) * y6) >> 3;
    y7 = (y8 - (W3 + W5) * y7) >> 3;
    y8 = y0 + y1;
    y0 -= y1;
    y1 = W6 * (y3 + y2) + 4;
    y2 = (y1 - (W2 + W6) * y2) >> 3;
    y3 = (y1 + (W2 - W6) * y3) >> 3;
    y1 = y4 + y6;
    y4 -= y6;
    y6 = y5 + y7;
    y5 -= y7;
    y7 = y8 + y3;
    y8 -= y3;
    y3 = y0 + y2;
    y0 -= y2;
    y2 = (R2 * (y4 + y5) + 128) >> 8;
    y4 = (R2 * (y4 - y5) + 128) >> 8;
    out[0 * 8 + x] = wrap16((y7 + y1) >> 11);
    out[1 * 8 + x] = wrap16((y3 + y2) >> 11);
    out[2 * 8 + x] = wrap16((y0 + y4) >> 11);
    out[3 * 8 + x] = wrap16((y8 + y6) >> 11);
    out[4 * 8 + x] = wrap16((y8 - y6) >> 11);
    out[5 * 8 + x] = wrap16((y0 - y4) >> 11);
    out[6 * 8 + x] = wrap16((y3 - y2) >> 11);
    out[7 * 8 + x] = wrap16((y7 - y1) >> 11);
}

template <class Op>
__device__ __forceinline__ int warp_reduce(int v, Op op) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = op(v, __shfl_xor_sync(~0u, v, m));
    return v;
}

template <class R>
__global__ void __launch_bounds__(kThreads)
vpx_decoder_kernel(const void* __restrict__ data, int64_t lmax,
                   const int32_t* __restrict__ dlen,
                   const int32_t* __restrict__ lanes,
                   const int32_t* __restrict__ rows, int64_t n_rows,
                   const int32_t* __restrict__ tables, int n_tables,
                   const int32_t* __restrict__ luts,
                   const int32_t* __restrict__ tpl, int32_t* __restrict__ arena,
                   int arena_size, int32_t* __restrict__ ring, int ring_slots,
                   int ring_width, int16_t* __restrict__ coef,
                   int64_t n_blocks, int32_t* __restrict__ err,
                   uint32_t slots, int32_t* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    Shared& sm = *reinterpret_cast<Shared*>(smem);
    uint2* cache = reinterpret_cast<uint2*>(smem + kFixedSmem);
    const int32_t* lut = sm.lut;

    const int64_t s = blockIdx.x;
    const int32_t* ln = lanes + s * kLaneFields;
    const int row0 = ln[0], nrows = ln[1], tab0 = ln[2];
    int ntab = ln[3];
    LEP_CHECK(ntab, ntab, kMaxTables + 1);
    int32_t* a = arena + s * arena_size;
    for (int k = threadIdx.x; k < arena_size; k += kThreads) {
        a[k] = tpl ? tpl[k] : vpx::kIdentityBranch;
    }
    for (uint32_t k = threadIdx.x; k < slots; k += kThreads) {
        cache[k] = make_uint2(0, 0);
    }
    for (int k = threadIdx.x; k < kLuts; k += kThreads) sm.lut[k] = luts[k];
    vpx::fill_recip(sm.rcp, threadIdx.x, kThreads);
    for (int k = threadIdx.x; k < ntab * 4 * 64; k += kThreads) {
        const int64_t t = static_cast<int64_t>(tab0) * 4 * 64 + k;
        sm.tab[k] = LEP_OK(tables, t, n_tables * 4 * 64LL) ? tables[t] : 0;
    }
    __syncthreads();
    if (threadIdx.x >= 32) return;

    const int lane = threadIdx.x;
    Model<R> rd{R(data, lmax, s, dlen[s]), a, arena_size, cache, slots,
                sm.rcp};
    int lane_err = 0;
    int32_t* lane_ring = ring + s * static_cast<int64_t>(ring_slots) * kSummary;

    for (int ri = 0; ri < nrows; ++ri) {
        int64_t r = row0 + ri;
        LEP_CHECK(row, r, n_rows);
        const int32_t* rd_ = rows + r * kRowFields;
        int comp = rd_[0];
        const int ci = rd_[1];
        int width = rd_[2];
        const int W = rd_[3];
        LEP_CHECK(ring_comp, comp, ring_width > 0 ? ring_slots / ring_width : 0);
        LEP_CHECK(ring_x, width, ring_width + 1);    // x < width <= ring_width
        const bool ha = rd_[4] != 0;
        int ct = rd_[5] - tab0;
        LEP_CHECK(ctab, ct, ntab);
        const int32_t* quant = sm.tab + ct * 4 * 64;
        const int32_t* icx = quant + 64;
        const int32_t* icy = quant + 128;
        const int32_t* mnt = quant + 192;
        const int64_t out_block = rd_[6];
        int32_t* ringc = lane_ring + static_cast<int64_t>(comp) * ring_width
                                     * kSummary;
        const int q0 = quant[0];
        const int sign_base = lut[kSign] + ci * lut[kSign + 1];
        const int exp7_base = lut[kExp77] + ci * lut[kExp77 + 1];
        const int res_base = lut[kRes] + ci * lut[kRes + 1];
        const int expx_base = lut[kExpX] + ci * lut[kExpX + 1];
        const int rt_base = lut[kThresh] + ci * lut[kThresh + 1];
        int nz_l = 0;

        // the above block's two coefficients of this lane, and its ring
        // summary word, for block x; loaded a block ahead
        uint32_t above_w = 0;
        int32_t summ_w = 0;
        if (ha && width > 0) {
            if (LEP_OK(above, out_block - W, n_blocks)) {
                above_w = reinterpret_cast<const uint32_t*>(
                    coef + (out_block - W) * 64)[lane];
            }
            if (lane < kSummary) summ_w = ringc[lane];
        }

        for (int x = 0; x < width; ++x) {
            const bool hl = x > 0;
            int16_t* out = coef + (out_block + x) * 64;
            int32_t* summ = ringc + x * kSummary;

            // ---- warp: the above block, its summary, a zeroed block
            sm.above[2 * lane] = static_cast<int16_t>(above_w & 0xFFFF);
            sm.above[2 * lane + 1] = static_cast<int16_t>(above_w >> 16);
            sm.here[2 * lane] = 0;
            sm.here[2 * lane + 1] = 0;
            if (lane < kSummary) sm.summ_a[lane] = summ_w;
            if (ha && x + 1 < width) {
                if (LEP_OK(above, out_block + x + 1 - W, n_blocks)) {
                    above_w = reinterpret_cast<const uint32_t*>(
                        out + 64 - static_cast<int64_t>(W) * 64)[lane];
                }
                if (lane < kSummary) summ_w = summ[kSummary + lane];
            }
            __syncwarp();

            // ---- warp: each interior coefficient's exponent context but
            // its non-zero bin (decoder.cc:200-215)
            for (int zz = lane; zz < 49; zz += 32) {
                const int coord = lut[kUnzig + zz];
                const int absl = hl ? abs(sm.left[coord]) : 0;
                const int absa = ha ? abs(sm.above[coord]) : 0;
                int aavrg;
                if (hl && ha) {
                    aavrg = ((13 * (absl + absa) + 6 * abs(sm.al[coord]))
                             & 0xFFFF) >> 5;
                } else {
                    aavrg = hl ? absl : absa;
                }
                sm.ctx7[zz] = exp7_base + zz * lut[kExp77 + 3]
                              + bitlen(min(aavrg, 1023)) * lut[kExp77 + 4];
            }
            const int nza = ha ? sm.summ_a[0] : 0;
            __syncwarp();

            // ---- reads: 7x7 non-zero count (decoder.cc:171-185), then
            // the 49 interior coefficients (decoder.cc:200-240)
            {
                const int nzl = hl ? nz_l : 0;
                const int nz_ctx = (hl && ha) ? (nza + nzl + 2) >> 2
                                 : ha ? (nza + 1) >> 1
                                 : hl ? (nzl + 1) >> 1 : 0;
                int nz7 = rd.tree(6, lut[kNz77] + ci * lut[kNz77 + 1]
                                     + lut[kNzBin + min(max(nz_ctx, 0), 49)]
                                       * lut[kNz77 + 2],
                                  lut[kNz77 + 3]);
                if (nz7 > 49) {
                    lane_err = 1;
                    nz7 = 49;
                }
                int nz_left = nz7, eob_x = 0, eob_y = 0;
                int nnzb = lut[kNzBin + nz_left];
                for (int zz = 0; zz < 49 && nz_left > 0; ++zz) {
                    const int coord = lut[kUnzig + zz];
                    const int length = rd.exponent(sm.ctx7[zz]
                                                   + nnzb * lut[kExp77 + 2]);
                    if (length > 0) {
                        // the next coefficient's bin, loaded off the chain
                        const int nnzb_next = lut[kNzBin + nz_left - 1];
                        const int sbit = rd.read(sign_base);
                        const int mag = rd.residual(
                            length, res_base + coord * lut[kRes + 2]
                                    + nnzb * lut[kRes + 3]);
                        sm.here[coord] = signed_value(length, sbit, mag);
                        --nz_left;
                        nnzb = nnzb_next;
                        eob_x = max(eob_x, coord & 7);
                        eob_y = max(eob_y, coord >> 3);
                    }
                }
                sm.nz7 = nz7;
                sm.eob_x = eob_x;
                sm.eob_y = eob_y;
            }
            __syncwarp();

            // ---- warp: the 14 edge coefficients' contexts; each Lakhani
            // prediction (model.hh:1033-1071) reads only interior
            // coefficients and the neighbour, so all are known here
            if (lane < 14) {
                const int e = lane >= 7, k = lane - 7 * e;
                const bool horizontal = e == 0;
                const int delta = horizontal ? 1 : 8;
                const int band = (k + 1) * delta;
                int bp = 0;
                if (horizontal ? ha : hl) {
                    // the sum wraps at 32 bits like the reference's ints
                    const int32_t* nb = horizontal ? sm.above : sm.left;
                    const int step = horizontal ? 8 : 1;
                    const int32_t* ic = horizontal ? icx + band * 8
                                                   : icy + band;
                    uint32_t pred = static_cast<uint32_t>(nb[band])
                                    * static_cast<uint32_t>(ic[0]);
                    for (int i = 1; i < 8; ++i) {
                        const int32_t hx = sm.here[band + i * step];
                        const int32_t na = nb[band + i * step];
                        const int32_t sgn_na = (i & 1) ? na : -na;
                        pred -= static_cast<uint32_t>(ic[i])
                                * static_cast<uint32_t>(hx + sgn_na);
                    }
                    bp = static_cast<int32_t>(pred) / ic[0];
                }
                const int absbp = abs(bp);
                const int bsr = bitlen(min(absbp, 1023));
                const int ctx1 = bp == 0 ? 0 : bp > 0 ? 1 : 2;
                const int mt = mnt[band];
                sm.ectx[lane] = expx_base + ((horizontal ? 0 : 7) + k)
                                * lut[kExpX + 3] + bsr * lut[kExpX + 4];
                sm.esign[lane] = sign_base + ctx1 * lut[kSign + 2] + bsr;
                sm.emt[lane] = mt;
                sm.ethr[lane] = rt_base + min(absbp >> mt, 255)
                                * lut[kThresh + 2];
                sm.eres[lane] = res_base + band * lut[kRes + 2];
            }
            __syncwarp();

            // ---- reads: edges, horizontal then vertical (decode_one_edge)
            {
                const int nz73 = lut[kNz73 + sm.nz7];
                for (int e = 0; e < 2; ++e) {
                    const bool horizontal = e == 0;
                    const int t = horizontal ? kNz81 : kNz18;
                    const int delta = horizontal ? 1 : 8;
                    int remaining = rd.tree(
                        3, lut[t] + ci * lut[t + 1]
                           + (horizontal ? sm.eob_x : sm.eob_y) * lut[t + 2]
                           + nz73 * lut[t + 3],
                        lut[t + 4]);
                    for (int k = 0; k < 7 && remaining > 0; ++k) {
                        const int j = e * 7 + k;
                        const int length = rd.exponent(
                            sm.ectx[j] + remaining * lut[kExpX + 2]);
                        if (length > 0) {
                            const int mt = sm.emt[j];
                            const int thresh = sm.ethr[j]
                                + min(length - mt, kNoiseFloor)
                                  * lut[kThresh + 3];
                            const int res = sm.eres[j]
                                            + remaining * lut[kRes + 3];
                            const int sbit = rd.read(sm.esign[j]);
                            int mag = 0, dsf = 1;
                            for (int i = length - 2; i >= 0; --i) {
                                const bool is_th = i >= mt;
                                const int b = rd.read(is_th ? thresh + dsf
                                                            : res + i);
                                mag |= b << i;
                                if (is_th) {
                                    dsf = min((dsf << 1) | b,
                                              (1 << kNoiseFloor) - 1);
                                }
                            }
                            sm.here[(k + 1) * delta] =
                                signed_value(length, sbit, mag);
                            --remaining;
                        }
                    }
                }
            }
            __syncwarp();

            // ---- warp: the DC's prediction (decoder.cc:243-287,
            // model.hh:674-784): the IDCT with the DC ignored, rows then
            // columns, then the 16 edge estimates
            if (lane < 8) idct_row(sm.here, quant, lane, sm.tmp);
            __syncwarp();
            if (lane < 8) idct_col(sm.tmp, lane, sm.pix);
            __syncwarp();
            const int big = 1 << 30;
            int est = 0;
            bool valid = false;
            if (lane < 8) {
                const int c0 = sm.pix[lane * 8], c1 = sm.pix[lane * 8 + 1];
                est = wrap16(sm.left_vert[lane] - div2_tz(c0 - c1)
                             - (c0 + 1024));
                valid = hl;
            } else if (lane < 16) {
                const int j = lane - 8;
                const int r0 = sm.pix[j], r1 = sm.pix[8 + j];
                est = wrap16(sm.summ_a[1 + j] - div2_tz(r0 - r1)
                             - (r0 + 1024));
                valid = ha;
            }
            const int mins = warp_reduce(valid ? est : big,
                                         [](int u, int v) { return min(u, v); });
            const int maxs = warp_reduce(valid ? est : -big,
                                         [](int u, int v) { return max(u, v); });
            const int sum_le = warp_reduce(valid && lane < 8 ? est : 0,
                                           [](int u, int v) { return u + v; });
            const int sum_ae = warp_reduce(valid && lane >= 8 ? est : 0,
                                           [](int u, int v) { return u + v; });

            // ---- reads: the DC
            {
                const int avg_h = hl ? sum_le : sum_ae;
                const int avg_v = (hl && ha) ? sum_ae : avg_h;
                const int overall = (avg_h + avg_v) >> 1;
                const bool any_n = hl || ha;
                const int unc = any_n ? (maxs - mins) >> 3 : 0;
                const int dh = avg_h - overall, dv = avg_v - overall;
                const int unc2 = any_n ? (abs(dh) < abs(dv) ? dh : dv) >> 3
                                       : 0;
                const int avgmed = any_n ? overall : 0;
                const int pred_dc = (avgmed / q0 + 4) >> 3;
                const int lm = min(bitlen(abs(unc)), kNumericLengthMax - 1);
                const int lo = min(bitlen(abs(unc2)), 16);
                const int length = rd.exponent(lut[kExpDc]
                                               + lm * lut[kExpDc + 1]
                                               + lo * lut[kExpDc + 2]);
                int dc = pred_dc;
                if (length > 0) {
                    const int sctx = unc2 < 0 ? 1 : unc2 == 0 ? 3 : 2;
                    const int sbit = rd.read(sign_base + sctx);
                    const int mag = rd.residual(
                        length, lut[kResDc] + lm * lut[kResDc + 1]);
                    dc += signed_value(length, sbit, mag);
                }
                const int max_value = 1 << (kMaxExponent - 1);
                if (dc < -max_value) dc += 2 * max_value + 1;
                if (dc > max_value) dc -= 2 * max_value + 1;
                sm.dc = dc;
            }
            __syncwarp();

            // ---- warp: outgoing neighbour summary (NeighborSummary set_*)
            // and the block out, as int16
            const int dc = sm.dc;
            const int nz7 = sm.nz7;
            if (lane < 8) {
                const int c7 = sm.pix[lane * 8 + 7], c6 = sm.pix[lane * 8 + 6];
                sm.left_vert[lane] = wrap16(dc * q0 + c7 + 1024
                                            + div2_tz(c7 - c6));
            } else if (lane < 16) {
                const int i = lane - 8;
                const int r7 = sm.pix[56 + i], r6 = sm.pix[48 + i];
                summ[1 + i] = wrap16(dc * q0 + r7 + 1024 + div2_tz(r7 - r6));
            } else if (lane == 16) {
                summ[0] = nz7;
            }
            const int32_t v0 = wrap16(lane == 0 ? dc : sm.here[2 * lane]);
            const int32_t v1 = wrap16(sm.here[2 * lane + 1]);
            if (LEP_OK(coef, out_block + x, n_blocks)) {
                reinterpret_cast<uint32_t*>(out)[lane] =
                    (static_cast<uint32_t>(v0) & 0xFFFF)
                    | (static_cast<uint32_t>(v1) << 16);
            }
            sm.left[2 * lane] = v0;
            sm.left[2 * lane + 1] = v1;
            sm.al[2 * lane] = sm.above[2 * lane];
            sm.al[2 * lane + 1] = sm.above[2 * lane + 1];
            nz_l = nz7;
            __syncwarp();
        }
    }
    if (lane == 0 && LEP_OK(err, s, gridDim.x)) {
        err[s] = lane_err;
        counts[2 * s] = rd.inserts;
        counts[2 * s + 1] = rd.falls;
    }
}

template <class R>
int launch(const void* data, int64_t lmax, const int32_t* dlen,
           const int32_t* lanes, int64_t S, const int32_t* rows,
           int64_t n_rows, const int32_t* tables, int n_tables,
           const int32_t* luts, const int32_t* tpl, int32_t* arena,
           int arena_size, int32_t* ring, int ring_slots, int ring_width,
           int16_t* coef, int64_t n_blocks, int32_t* err, uint32_t slots,
           int32_t* counts, cudaStream_t st) {
    const size_t smem = kFixedSmem + static_cast<size_t>(slots) * 8;
    cudaError_t rc = cudaFuncSetAttribute(
        vpx_decoder_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    vpx_decoder_kernel<R><<<static_cast<unsigned>(S), kThreads, smem, st>>>(
        data, lmax, dlen, lanes, rows, n_rows, tables, n_tables, luts, tpl,
        arena, arena_size, ring, ring_slots, ring_width, coef, n_blocks, err,
        slots, counts);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one CTA per lane on `stream` with the VPX reader (coder 0; data
// uint8 [S, lmax] bytes) or the rANS reader (coder 1; data uint32
// [S, lmax] words, dlen in words), each CTA with a branch cache of `slots`
// entries; rows int32 [n_rows, 7], tables int32 [n_tables, 4, 64], coef
// int16 [n_blocks, 64] (the sizes are read by the checked build only);
// counts int32 [S, 2] receives each lane's cache inserts and reads that
// fell through to the arena.  Returns the error of raising the kernel's
// shared-memory limit, else cudaGetLastError().
int vpx_decoder_launch(const void* data, int64_t lmax, const int32_t* dlen,
                       const int32_t* lanes, int64_t S, const int32_t* rows,
                       int64_t n_rows, const int32_t* tables, int n_tables,
                       const int32_t* luts, const int32_t* tpl,
                       int32_t* arena, int arena_size, int32_t* ring,
                       int ring_slots, int ring_width, int16_t* coef,
                       int64_t n_blocks, int32_t* err, int slots,
                       int32_t* counts, int coder, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* fn = coder == 1 ? launch<AnsReader> : launch<VpxReader>;
    return fn(data, lmax, dlen, lanes, S, rows, n_rows, tables, n_tables,
              luts, tpl, arena, arena_size, ring, ring_slots, ring_width,
              coef, n_blocks, err, static_cast<uint32_t>(slots), counts, st);
}

const char* vpx_decoder_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
