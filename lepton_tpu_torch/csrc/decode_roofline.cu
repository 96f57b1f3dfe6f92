// decode_roofline.cu -- probes of the dependent chains the token decoder and
// the coders are made of, on Hopper (sm_90a).
//
// Replaces tools/decode_roofline.py::_mk_kernel (launched at :82 in run),
// the Mosaic probe that measured them on the TPU.  The same four chains run
// on one thread of one CTA:
//   rmw    a dependent arena read-modify-write chain: row = (x + i) & (rows
//          - 1), off = x & 127, v = arena[row][off], arena[row][off] = v + 1,
//          x = (x + v) & 0xFFFF (the branch-arena access of a read);
//   rmw K  the same chain K = 2, 4, 8 ways interleaved (K independent x);
//   alu    12 x  x = ((x * 5) ^ (x >> 3)) + i  an iteration (the reader's
//          dependent arithmetic), int32 arithmetic that wraps;
//   mixed  one rmw step then the 12 alu steps (the shape of one read).
// The arena (4096 rows of 128 int32, 2 MB, every entry 0x010180 at the
// start) lies in device memory, the decoders' case, or, cut to the 256
// rows (128 KB) that fit the 227 KB of shared memory with a power-of-two
// row mask, in shared memory.  The checksum is the sum of the K chains'
// x (rmw) or x (alu, mixed), as out[0]; probes/decode_roofline.py holds
// it against a plain loop of the same arithmetic.
//
// Bound: nothing but the latency of each dependent step; the time over the
// step count is the chain's cost a step on this card.
//
// Bounds checks (checked.cuh; only with -DLEPTON_CHECKED): each arena
// entry a step touches against rows x 128.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int32_t kIdentity = 0x010180;

enum Kind : int { kRmw = 0, kAlu = 1, kMixed = 2 };

__device__ __forceinline__ int32_t alu12(int32_t x, int32_t i) {
    for (int r = 0; r < 12; ++r) {
        const uint32_t m = static_cast<uint32_t>(x) * 5u;
        x = static_cast<int32_t>((m ^ static_cast<uint32_t>(x >> 3))
                                 + static_cast<uint32_t>(i));
    }
    return x;
}

__device__ __forceinline__ int32_t rmw(int32_t* a, int32_t x, int32_t i,
                                       int rows) {
    int32_t* p = a + ((x + i) & (rows - 1)) * kLanes + (x & (kLanes - 1));
    if (!LEP_OK(arena, p - a, rows * kLanes)) return x;
    const int32_t v = *p;
    *p = v + 1;
    return (x + v) & 0xFFFF;
}

template <int kind, int K, bool shared>
__global__ void __launch_bounds__(kThreads)
roofline_kernel(int32_t* __restrict__ arena_g, int n_iter, int rows,
                int32_t* __restrict__ out) {
    extern __shared__ int32_t arena_s[];
    int32_t* a = shared ? arena_s : arena_g;
    if (kind != kAlu) {
        for (int k = threadIdx.x; k < rows * kLanes; k += kThreads) {
            a[k] = kIdentity;
        }
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    if (kind == kRmw) {
        int32_t x[K];
        for (int k = 0; k < K; ++k) x[k] = 7 * (k + 1);
        for (int i = 0; i < n_iter; ++i) {
#pragma unroll
            for (int k = 0; k < K; ++k) x[k] = rmw(a, x[k], i, rows);
        }
        int32_t sum = 0;
        for (int k = 0; k < K; ++k) sum += x[k];
        out[0] = sum;
    } else {
        int32_t x = 7;
        for (int i = 0; i < n_iter; ++i) {
            if (kind == kMixed) x = rmw(a, x, i, rows);
            x = alu12(x, i);
        }
        out[0] = x;
    }
}

template <int kind, int K, bool shared>
int launch(int32_t* arena, int n_iter, int rows, int32_t* out,
           cudaStream_t stream) {
    const size_t smem = shared ? static_cast<size_t>(rows) * kLanes * 4 : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            roofline_kernel<kind, K, shared>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    roofline_kernel<kind, K, shared><<<1, kThreads, smem, stream>>>(
        arena, n_iter, rows, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs one chain (kind 0 rmw with K in {1, 2, 4, 8}, 1 alu, 2 mixed) over
// an arena of `rows` rows (a power of two) in device memory (`arena`, rows
// x 128 int32) or in shared memory (shared != 0); the checksum goes to
// out[0].  Returns a cudaError_t: cudaErrorInvalidValue (1) for a chain
// that is not one of these.
int decode_roofline_launch(int kind, int K, int shared, int n_iter, int rows,
                           int32_t* arena, int32_t* out, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind == kRmw) {
        switch (K * 2 + (shared != 0)) {
            case 2: return launch<kRmw, 1, false>(arena, n_iter, rows, out, st);
            case 3: return launch<kRmw, 1, true>(arena, n_iter, rows, out, st);
            case 4: return launch<kRmw, 2, false>(arena, n_iter, rows, out, st);
            case 5: return launch<kRmw, 2, true>(arena, n_iter, rows, out, st);
            case 8: return launch<kRmw, 4, false>(arena, n_iter, rows, out, st);
            case 9: return launch<kRmw, 4, true>(arena, n_iter, rows, out, st);
            case 16: return launch<kRmw, 8, false>(arena, n_iter, rows, out, st);
            case 17: return launch<kRmw, 8, true>(arena, n_iter, rows, out, st);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (K != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (kind == kAlu) return launch<kAlu, 1, false>(arena, n_iter, rows, out, st);
    if (kind == kMixed) {
        return shared ? launch<kMixed, 1, true>(arena, n_iter, rows, out, st)
                      : launch<kMixed, 1, false>(arena, n_iter, rows, out, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_roofline_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
