// ans_coder.cu -- per-segment rANS coder (container v3 lanes) for Hopper
// (sm_90a).
//
// Replaces the v3 phase B of lepton_tpu/kernels/batch_encode.py
// (_ansenc_packed_jit :378-428: vpx_scan.model_probs_sorted with
// update="adv", :525-609, then vpx_scan.ans_pass, :744-823) and the word
// order of its host side (_finalize_ans_lane :431-437,
// vpx_scan.finalize_ans_streams :826-852).  It computes the stream of
// coder/ans.py's ANSWriter (reference ans_bool_writer.hh:21-110 over
// rans64.hh): two interleaved 64-bit rANS states over (prob, bit) pairs,
// serialised in reverse.
//
// Design: one CTA per lane.  All threads of the CTA fill the lane's model
// arena (identity or template, as vpx_coder.cu does), then thread 0 runs
// the lane in two passes:
//   1. forward: for each of the lane's nsyms symbols, the branch's
//      probability before the update (the template's stored prob byte on
//      first use) goes to a uint8 [S, L] scratch, then the branch takes
//      update_branch_adv (vpx_branch.cuh);
//   2. reverse: pair k holds second = symbol 2k and first = symbol 2k + 1
//      (an odd count puts the sentinel, bit 1 at prob 1, in the last
//      pair's first slot).  The walk codes 4 nop pairs (0 at 128, 0 at 128)
//      and then pairs npairs-1 ... 0; state s1 takes the first slot, s2 the
//      second, s1's word is emitted before s2's; then the states flush as
//      s1_hi, s1_lo, s2_hi, s2_lo.
// The kernel writes the emitted words and the flush in that order; the
// host reverses them and appends the parity tail (kernels/ans_coder.py
// finalize_ans).  The JAX package split every 64-bit state into (hi, lo)
// uint32 pairs and divided in exact f32 pieces because the TPU has no
// int64; here a state is a uint64_t and the division is a plain 64-bit
// `/` and `%` by freq (<= 256).
//
// Bound: one dependent chain per lane, twice over: the forward pass waits
// a device-memory round trip for each branch (the arena, 2.89 MB a lane,
// is far above 227 KB of shared memory), the reverse pass a 64-bit
// division per symbol.  It moves few bytes (5 per symbol in, the words
// out), so the launch takes about as long as its longest lane.
//
// Output: words [S, cap] and nwords [S].  Past cap the kernel stops
// writing but keeps counting, so the caller sees nwords > cap and
// relaunches with a larger buffer.  A lane that would code a 0 bit at
// probability 0 (freq 0) stops and sets nwords to -1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "vpx_branch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kRansL = 1ull << 31;   // RANS64_L
constexpr int kNopPairs = 4;

// Rans64EncPut (rans64.hh): renormalise, emitting the low word, while
// x >= ((L >> 8) << 32) * freq, then x' = (x / freq) << 8 + x % freq +
// start.  The test is on x >> 32, so freq << 23 never overflows.
__device__ __forceinline__ void put(uint64_t& x, uint32_t start,
                                    uint32_t freq, uint32_t* o, int64_t cap,
                                    int64_t& pos) {
    if ((x >> 32) >= (static_cast<uint64_t>(freq) << 23)) {
        if (pos < cap) o[pos] = static_cast<uint32_t>(x);
        ++pos;
        x >>= 32;
    }
    x = ((x / freq) << 8) + x % freq + start;
}

__device__ __forceinline__ void emit(uint32_t w, uint32_t* o, int64_t cap,
                                     int64_t& pos) {
    if (pos < cap) o[pos] = w;
    ++pos;
}

__global__ void __launch_bounds__(kThreads)
ans_coder_kernel(const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ bit, int64_t L,
                 const int32_t* __restrict__ nsyms,
                 const int32_t* __restrict__ tpl, int32_t* __restrict__ arena,
                 int arena_size, uint8_t* __restrict__ probs,
                 uint32_t* __restrict__ out, int64_t cap,
                 int32_t* __restrict__ nwords) {
    const int64_t s = blockIdx.x;
    int32_t* a = arena + s * arena_size;
    for (int k = threadIdx.x; k < arena_size; k += kThreads) {
        a[k] = tpl ? tpl[k] : vpx::kIdentityBranch;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;

    const int32_t* li = idx + s * L;
    const uint8_t* lb = bit + s * L;
    uint8_t* pr = probs + s * L;
    uint32_t* o = out + s * cap;
    const int64_t n = nsyms[s];

    // 1. forward: each symbol's probability before its branch's update
    bool zero_freq = false;
    for (int64_t t = 0; t < n; ++t) {
        const int32_t i = li[t];
        const bool b = lb[t] != 0;
        uint32_t p = 128;                  // a non-branch symbol codes at 128
        if (i >= 0) {
            const int32_t packed = a[i];
            p = vpx::branch_prob(packed);
            a[i] = vpx::update_branch_adv(packed, b);
        }
        // freq 0: a template's prob-0 branch that sees a 0 bit.  Flagged
        // without a branch, so the loop keeps no early exit.
        zero_freq |= (p == 0) & !b;
        pr[t] = static_cast<uint8_t>(p);
    }
    if (zero_freq) {                       // the host raises on nwords < 0
        nwords[s] = -1;
        return;
    }

    // 2. reverse: 4 nop pairs, then pairs npairs-1 ... 0
    const int64_t npairs = (n + 1) / 2;
    uint64_t x1 = kRansL, x2 = kRansL;
    int64_t pos = 0;
    for (int64_t k = npairs + kNopPairs - 1; k >= 0; --k) {
        uint32_t fb = 0, fp = 128, sb = 0, sp = 128;
        if (k < npairs) {
            sb = lb[2 * k] != 0;
            sp = pr[2 * k];
            if (2 * k + 1 < n) {
                fb = lb[2 * k + 1] != 0;
                fp = pr[2 * k + 1];
            } else {                       // the odd count's sentinel
                fb = 1;
                fp = 1;
            }
        }
        put(x1, fb ? fp : 0, fb ? 256 - fp : fp, o, cap, pos);
        put(x2, sb ? sp : 0, sb ? 256 - sp : sp, o, cap, pos);
    }
    emit(static_cast<uint32_t>(x1 >> 32), o, cap, pos);
    emit(static_cast<uint32_t>(x1), o, cap, pos);
    emit(static_cast<uint32_t>(x2 >> 32), o, cap, pos);
    emit(static_cast<uint32_t>(x2), o, cap, pos);
    nwords[s] = static_cast<int32_t>(pos);
}

}  // namespace

extern "C" {

// Launches one CTA per lane on `stream`; returns cudaGetLastError().
int ans_coder_launch(const int32_t* idx, const uint8_t* bit, int64_t S,
                     int64_t L, const int32_t* nsyms, const int32_t* tpl,
                     int32_t* arena, int arena_size, uint8_t* probs,
                     uint32_t* out, int64_t cap, int32_t* nwords,
                     void* stream) {
    ans_coder_kernel<<<static_cast<unsigned>(S), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        idx, bit, L, nsyms, tpl, arena, arena_size, probs, out, cap, nwords);
    return static_cast<int>(cudaGetLastError());
}

const char* ans_coder_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
