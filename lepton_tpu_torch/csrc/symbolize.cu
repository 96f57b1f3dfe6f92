// symbolize.cu -- each block's live (branch, bit) symbols in emission
// order, for Hopper (sm_90a).
//
// Replaces lepton_tpu/kernels/symbolize.py::symbolize_slice (:104-309)
// and the compaction after it (_sym_sorted_jit,
// lepton_tpu/kernels/batch_encode.py:91; compact_symbols :313 and
// row_symbol_counts :346 of symbolize.py), all XLA.  The JAX package fills
// a fixed slab of slots a block, PAD where nothing is coded, and compacts
// it by sorting: a TPU serialises scatters and pads its tiles to 128.  A
// GPU has neither rule, so each block writes its run of symbols straight
// to its offset.  The port's plain version (kernels/symbolize.py) keeps
// the slab, 1,420 slots a block, of which photos fill about 5%.
//
// Bound: bytes.  A live block reads its nz7x7, its 15 edge and DC
// coefficients, its DC prediction and two uncertainties (43 B), and, up
// to the last nonzero coefficient of each loop, an interior coefficient
// and its aavrg (6 B a zigzag step) and an edge's lak (4 B a step); each
// live symbol's branch (int32) and bit (uint8) is written once, 5 B a
// symbol, about 66 symbols a block on photos.  The work a symbol is a few
// integer operations.
//
// Design: one walk of a block, walk<kEmit>, in the emission order of
// kernels/symbolize.py: the 6-bit nz tree; the 49 interior coefficients
// in zigzag order, each as exponent unary, sign and residual; the
// horizontal, then the vertical edge, each a 3-bit tree and 7 x
// (exponent, sign, threshold-contexted then noise residual, with the
// so_far chain); then DC.  Where the slab has PAD the walk writes
// nothing.  Two kernels instantiate it: symbol_counts_kernel (kEmit
// false) writes each block's count of live symbols and a flag for a
// coded value past 11 bits (the slab's COEF_OUT_OF_RANGE); the wrapper
// sums the counts into offsets; symbol_emit_kernel (kEmit true) writes
// the symbols at the block's offset, and COEF_OUT_OF_RANGE in place of a
// flagged block's first branch.  One walk makes both, so the count and
// the emission cannot disagree.  One thread a block: the nz_left
// countdown, the so_far chain and the output position live in
// registers, and the interior and each edge end at their last nonzero
// coefficient, where the slab keeps every slot.  The table offsets and
// strides (model/tables.py), the nonzero bins, the zigzag order and the
// plane's noise thresholds come from the wrapper as one by-value
// parameter block (Params), which each CTA copies to shared memory.
//
// Bounds checks (checked.cuh; only with -DLEPTON_CHECKED): in
// symbol_emit, the block index against the plane's blocks and every store
// against the output's length (a block's offset plus its count).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxExponent = 11;       // constants.MAX_EXPONENT
constexpr int kCoefBits = 10;          // constants.COEF_BITS
constexpr int kNoiseFloor = 7;         // constants.RESIDUAL_NOISE_FLOOR
constexpr int kNumericLengthMax = 12;  // constants.NUMERIC_LENGTH_MAX
constexpr int kOutOfRange = -3;        // symbolize.COEF_OUT_OF_RANGE
constexpr int kLakLanes = 14;          // symbolize.LAK_LANES

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
// (49 raster positions) and the plane's min noise thresholds (64)
constexpr int kNzBin = kTabs;
constexpr int kUnzig = kNzBin + 50;
constexpr int kNoise = kUnzig + 49;
constexpr int kParams = kNoise + 64;

struct Params {
    int32_t v[kParams];
};

// One plane, row-major blocks: the inputs of kernels/symbolize.py's Plane.
struct Plane {
    const int16_t* coefs;      // [n, 64] raster
    const uint8_t* nz7x7;      // [n]
    const int32_t* aavrg;      // [n, 64]
    const int32_t* lak;        // [n, 14]: horizontal edge, then vertical
    const int32_t* dc_pred;    // [n]
    const int32_t* unc;        // [n]
    const int32_t* unc2;       // [n]
    const uint8_t* has_above;  // [rows]: bool
    int64_t rows, width, row_block_offset, size_limit;
    int ci;
};

__device__ __forceinline__ int bitlen(int32_t v) {
    return v > 0 ? 32 - __clz(v) : 0;
}

// torch.abs of an int32: INT32_MIN stays itself
__device__ __forceinline__ int32_t wabs(int32_t v) {
    return static_cast<int32_t>(v < 0 ? 0u - static_cast<uint32_t>(v)
                                      : static_cast<uint32_t>(v));
}

// the bucket of a prediction: bit_length of |v| clamped to 1023
__device__ __forceinline__ int bsr_prior(int32_t v) {
    return bitlen(min(wabs(v), 1023));
}

// Where a walk puts its symbols: counted only (kEmit false), or also
// stored at pos.
template <bool kEmit>
struct Sink {
    int32_t* idx;
    uint8_t* bit;
    int64_t n_out;
    int64_t pos;

    __device__ __forceinline__ void put(int32_t i, int b) {
        if (kEmit && LEP_OK(out, pos, n_out)) {
            idx[pos] = i;
            bit[pos] = static_cast<uint8_t>(b);
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

// Block b's symbols into out; returns whether it codes a value past 11
// bits.  P: the parameter block.
template <bool kEmit>
__device__ bool walk(const Plane& pl, const int32_t* P, int64_t b,
                     Sink<kEmit>& out) {
    const int64_t r = b / pl.width;
    const int64_t c = b - r * pl.width;
    const bool has_left = c > 0;
    const bool has_above = pl.has_above[r] != 0;
    const int16_t* co = pl.coefs + b * 64;
    const int ci = pl.ci;
    const int nz7 = pl.nz7x7[b];

    // ---- the 7x7 nonzero count, a 6-bit tree
    const int nl = has_left ? pl.nz7x7[b - 1] : 0;
    const int na = r > 0 ? pl.nz7x7[b - pl.width] : 0;
    int ctx = 0;
    if (has_left && has_above) {
        ctx = (na + nl + 2) / 4;
    } else if (has_above) {
        ctx = (na + 1) / 2;
    } else if (has_left) {
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
        const int bsr = bsr_prior(pl.aavrg[b * 64 + pos]);
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
            const int32_t bp = pl.lak[b * kLakLanes + zig15 + l];
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
    constexpr int32_t maxv = 1 << (kMaxExponent - 1);
    int32_t delta = static_cast<int32_t>(static_cast<uint32_t>(co[0])
                                         - static_cast<uint32_t>(
                                             pl.dc_pred[b]));
    if (delta < -maxv) delta += 2 * maxv + 1;
    if (delta > maxv) delta -= 2 * maxv + 1;
    const int32_t a = wabs(delta);
    const int n = bitlen(a);
    const int32_t u2 = pl.unc2[b];
    const int lm = min(bitlen(wabs(pl.unc[b])), kNumericLengthMax - 1);
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

__device__ __forceinline__ void load_params(int32_t* P, const Params& prm) {
    for (int i = threadIdx.x; i < kParams; i += kThreads) P[i] = prm.v[i];
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
symbol_counts_kernel(const Plane pl, const __grid_constant__ Params prm,
                     int32_t* __restrict__ counts,
                     uint8_t* __restrict__ over) {
    __shared__ int32_t P[kParams];
    load_params(P, prm);
    const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (b >= pl.rows * pl.width) return;
    Sink<false> out{nullptr, nullptr, 0, 0};
    const bool o = live(pl, b) && walk(pl, P, b, out);
    counts[b] = static_cast<int32_t>(out.pos);
    over[b] = o;
}

__global__ void __launch_bounds__(kThreads)
symbol_emit_kernel(const Plane pl, const __grid_constant__ Params prm,
                   const int64_t* __restrict__ offsets,
                   int32_t* __restrict__ idx, uint8_t* __restrict__ bit,
                   int64_t n_out) {
    __shared__ int32_t P[kParams];
    load_params(P, prm);
    int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t n = pl.rows * pl.width;
    if (b >= n || !live(pl, b)) return;
    LEP_CHECK(block, b, n);
    const int64_t start = offsets[b];
    Sink<true> out{idx, bit, n_out, start};
    if (walk(pl, P, b, out) && LEP_OK(out, start, n_out)) {
        idx[start] = kOutOfRange;
    }
}

// The plane's arguments as the launch functions take them, or false when
// the parameter block is not kParams values long.
bool make_plane(Plane* pl, Params* prm, const void* coefs,
                const void* nz7x7, const void* aavrg, const void* lak,
                const void* dc_pred, const void* unc, const void* unc2,
                const void* has_above, int64_t rows, int64_t width,
                int64_t row_block_offset, int64_t size_limit, int ci,
                const int32_t* params, int nparams) {
    if (nparams != kParams) return false;
    *pl = Plane{static_cast<const int16_t*>(coefs),
                static_cast<const uint8_t*>(nz7x7),
                static_cast<const int32_t*>(aavrg),
                static_cast<const int32_t*>(lak),
                static_cast<const int32_t*>(dc_pred),
                static_cast<const int32_t*>(unc),
                static_cast<const int32_t*>(unc2),
                static_cast<const uint8_t*>(has_above),
                rows, width, row_block_offset, size_limit, ci};
    std::memcpy(prm->v, params, sizeof(prm->v));
    return true;
}

unsigned blocks(int64_t n) {
    return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Writes counts int32 [rows * width] and over uint8 [rows * width] (bool)
// of the plane, a thread a block, on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a parameter block that
// is not kParams values long.
int symbol_counts_launch(const void* coefs, const void* nz7x7,
                         const void* aavrg, const void* lak,
                         const void* dc_pred, const void* unc,
                         const void* unc2, const void* has_above,
                         int64_t rows, int64_t width,
                         int64_t row_block_offset, int64_t size_limit,
                         int ci, const int32_t* params, int nparams,
                         int32_t* counts, uint8_t* over, void* stream) {
    Plane pl;
    Params prm;
    if (!make_plane(&pl, &prm, coefs, nz7x7, aavrg, lak, dc_pred, unc, unc2,
                    has_above, rows, width, row_block_offset, size_limit, ci,
                    params, nparams)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    symbol_counts_kernel<<<blocks(rows * width), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pl, prm, counts, over);
    return static_cast<int>(cudaGetLastError());
}

// Writes each block's symbols at offsets[block] (int64 [rows * width]) of
// idx int32 [n_out] and bit uint8 [n_out], a thread a block, on
// `stream`; returns as symbol_counts_launch.
int symbol_emit_launch(const void* coefs, const void* nz7x7,
                       const void* aavrg, const void* lak,
                       const void* dc_pred, const void* unc,
                       const void* unc2, const void* has_above,
                       int64_t rows, int64_t width,
                       int64_t row_block_offset, int64_t size_limit, int ci,
                       const int32_t* params, int nparams,
                       const int64_t* offsets, int32_t* idx, uint8_t* bit,
                       int64_t n_out, void* stream) {
    Plane pl;
    Params prm;
    if (!make_plane(&pl, &prm, coefs, nz7x7, aavrg, lak, dc_pred, unc, unc2,
                    has_above, rows, width, row_block_offset, size_limit, ci,
                    params, nparams)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    symbol_emit_kernel<<<blocks(rows * width), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pl, prm, offsets, idx, bit, n_out);
    return static_cast<int>(cudaGetLastError());
}

const char* symbolize_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
