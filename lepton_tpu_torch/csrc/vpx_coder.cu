// vpx_coder.cu -- per-segment adaptive VPX bool encoder for Hopper (sm_90a).
//
// Replaces lepton_tpu/kernels/pallas_coder.py::_coder_kernel (host side
// encode_streams_pallas / finalize).  It computes the same per-segment
// stream: each symbol (arena index, bit) is coded with its branch's
// adaptive probability (vpx_write, boolwriter.hh), then the branch is
// updated by Branch::record_obs_and_update (branch.hh:82-100).
//
// Design: one CTA per segment.  All threads of the CTA fill the segment's
// model arena (the identity branch 1 | 1<<8 | 128<<16, or a trained
// template), then thread 0 runs the serial coder over the lane.  The arena
// is ARENA_SIZE int32 (2.89 MB) per segment, far above the 227 KB of shared
// memory, so it lives in device memory and stays L2-resident only for small
// batches.  Segments are independent, so the CTAs run concurrently; the TPU
// kernel ran its grid steps one after another.
//
// Bound: a dependent chain of one arena read-modify-write per symbol, whose
// address comes from the symbol itself.  The kernel is latency-bound, not
// bandwidth-bound: it moves 5 bytes of input per symbol but waits a memory
// round trip for each.
//
// Output: bytes [S, cap] and nbytes [S].  Past cap the kernel stops writing
// but keeps counting, so the caller sees nbytes > cap and relaunches with a
// larger buffer.  Carries ripple backward in place over 0xFF bytes, as
// vpx_write does.  The stop-byte rule is applied on the host.
//
// The branch update is vpx_branch.cuh's, shared with vpx_decoder.cu.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "vpx_branch.cuh"

namespace {

constexpr int32_t kPad = -1;         // no-op lane padding
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vpx_coder_kernel(const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ bit, int64_t L,
                 const int32_t* __restrict__ tpl, int32_t* __restrict__ arena,
                 int arena_size, uint8_t* __restrict__ out, int64_t cap,
                 int32_t* __restrict__ nbytes) {
    const int64_t s = blockIdx.x;
    int32_t* a = arena + s * arena_size;
    for (int k = threadIdx.x; k < arena_size; k += kThreads) {
        a[k] = tpl ? tpl[k] : vpx::kIdentityBranch;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;

    const int32_t* li = idx + s * L;
    const uint8_t* lb = bit + s * L;
    uint8_t* o = out + s * cap;
    uint32_t low = 0;      // vpx lowvalue, wrapping uint32
    uint32_t rng = 255;
    int count = -24;
    int64_t pos = 0;
    for (int64_t t = 0; t < L; ++t) {
        const int32_t i = li[t];
        if (i == kPad) continue;
        const int b = lb[t];
        int32_t packed = 0;
        uint32_t prob = 128;
        if (i >= 0) {            // FIXED_PROB codes at 128
            packed = a[i];
            prob = vpx::branch_prob(packed);
        }
        const uint32_t split = 1 + (((rng - 1) * prob) >> 8);
        if (b) {
            low += split;
            rng -= split;
        } else {
            rng = split;
        }
        // vpx_norm[r] == clz32(r) - 24 for r in 1..255
        const int shift = __clz(static_cast<int>(rng)) - 24;
        rng <<= shift;
        count += shift;
        if (count >= 0) {
            const int offset = shift - count;     // 1..7
            if ((low << (offset - 1)) & 0x80000000u) {
                // carry: +1 ripples back over 0xFF bytes (vpx_write)
                int64_t x = pos - 1;
                if (x < cap) {
                    while (x >= 0 && o[x] == 0xFF) {
                        o[x] = 0;
                        --x;
                    }
                    if (x >= 0) ++o[x];
                }
            }
            if (pos < cap) o[pos] = static_cast<uint8_t>(low >> (24 - offset));
            ++pos;
            low = ((low << offset) & 0xFFFFFF) << count;
            count -= 8;
        } else {
            low <<= shift;
        }
        if (i >= 0) a[i] = vpx::update_branch(packed, b);
    }
    nbytes[s] = static_cast<int32_t>(pos);
}

}  // namespace

extern "C" {

// Launches one CTA per segment on `stream`; returns cudaGetLastError().
int vpx_coder_launch(const int32_t* idx, const uint8_t* bit, int64_t S,
                     int64_t L, const int32_t* tpl, int32_t* arena,
                     int arena_size, uint8_t* out, int64_t cap,
                     int32_t* nbytes, void* stream) {
    vpx_coder_kernel<<<static_cast<unsigned>(S), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        idx, bit, L, tpl, arena, arena_size, out, cap, nbytes);
    return static_cast<int>(cudaGetLastError());
}

const char* vpx_coder_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
