// branch_probs.cu -- the probability stage of both encode coders, for
// Hopper (sm_90a).
//
// Replaces lepton_tpu/kernels/vpx_scan.py::model_probs_sorted (:525-609),
// the first stage of the JAX package's two-pass phase B: with
// update="vpx" for the VPX lanes of containers v1/v2 (before arith_pass),
// with update="adv" for the rANS lanes of v3 (before ans_pass).  Together
// with the walks in vpx_coder.cu and ans_coder.cu it computes the function
// of lepton_tpu/kernels/pallas_coder.py::_coder_kernel (VPX) and of the v3
// phase B (rANS).
//
// Input: the live symbols of all lanes as sorted packed keys
//   ((lane * arena_size + branch) << shift) | (pos << 1) | bit
// (kernels/branch_probs.py::group, one torch.sort), so each (lane, branch)
// is one run of consecutive keys in stream order.  Output: probs[lane, pos]
// = the branch's probability before the symbol's bit, from the identity
// branch or the template's entry on first use.
//
// Bound: not bytes (9 bytes of key and probability a symbol) but the
// longest run: each run is a dependent chain of branch updates, one
// division a step (a multiply by a reciprocal, vpx_branch.cuh).  The
// coders walked the same chains interleaved per lane through a
// device-memory arena, one L2 round trip a symbol.
//
// Design: two kernels, each with its own launch function and wrapper
// (kernels/branch_probs.py run_heads, walk_runs).  run_heads_kernel, one
// thread a key, gathers the keys that start a run (their branch differs
// from the previous key's) into a dense list, in no fixed order, with one
// atomicAdd a warp.  walk_runs_kernel, one thread a run, walks its run
// with the branch in a register, loading the next key one step ahead, and
// scatters one byte a symbol.  With the runs dense, a warp walks 32 runs
// and the longest runs share their SMs with little other work.  The
// update's division is a multiply by a reciprocal from a 2 KB table each
// block keeps in shared memory (vpx_branch.cuh, the decoder's rule); no
// table in device memory sits on the chain.  Runs are short (most tables
// are indexed by coefficient position, a few hits a block), so millions
// of runs walk at once.  The longest run is reduced per block
// and written with one atomicMax a block.  Under the adv rule a run that
// codes a 0 bit at probability 0 (freq 0, no rANS code) flags its lane.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "vpx_branch.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
run_heads_kernel(const uint64_t* __restrict__ keys, int64_t n, int shift,
                 int64_t* __restrict__ heads,
                 unsigned long long* __restrict__ nheads) {
    const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    const bool head = j < n && (j == 0 || (keys[j - 1] >> shift)
                                              != (keys[j] >> shift));
    const unsigned mask = __ballot_sync(0xffffffffu, head);
    if (!mask) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(mask) - 1;
    unsigned long long base = 0;
    if (lane == leader) base = atomicAdd(nheads, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (head) heads[base + __popc(mask & ((1u << lane) - 1))] = j;
}

template <bool kAdv>
__global__ void __launch_bounds__(kThreads)
walk_runs_kernel(const uint64_t* __restrict__ keys, int64_t n, int shift,
                    const int64_t* __restrict__ heads, int64_t nruns,
                    int64_t arena_size, int64_t L,
                    const int32_t* __restrict__ tpl,
                    uint8_t* __restrict__ probs, uint8_t* __restrict__ zero,
                    int32_t* __restrict__ longest) {
    __shared__ int32_t warp_max[kThreads / 32];
    __shared__ uint32_t rcp[vpx::kRecipSize];
    vpx::fill_recip(rcp, threadIdx.x, kThreads);
    __syncthreads();
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    int32_t run = 0;
    if (r < nruns) {
        const int64_t j0 = heads[r];
        uint64_t k = keys[j0];
        const uint64_t br = k >> shift;
        const int64_t lane = static_cast<int64_t>(br / arena_size);
        const int64_t i = static_cast<int64_t>(br) - lane * arena_size;
        const uint64_t pmask = (1ull << (shift - 1)) - 1;
        uint8_t* lp = probs + lane * L;
        int32_t st = tpl ? tpl[i] : vpx::kIdentityBranch;
        bool z = false;
        for (int64_t j = j0;; ++j) {
            // the next key, loaded before this step's chain; ~0 ends every
            // run (its branch field exceeds any real one)
            const uint64_t kn = j + 1 < n ? keys[j + 1] : ~0ull;
            const int b = static_cast<int>(k & 1);
            const uint32_t p = vpx::branch_prob(st);
            lp[(k >> 1) & pmask] = static_cast<uint8_t>(p);
            if (kAdv) {
                z |= (p == 0) & !b;
                st = vpx::update_branch_adv(st, b, rcp);
            } else {
                st = vpx::update_branch(st, b, rcp);
            }
            ++run;
            if ((kn >> shift) != br) break;
            k = kn;
        }
        if (z) zero[lane] = 1;
    }
    run = __reduce_max_sync(0xffffffffu, run);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = run;
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t m = 0;
        for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
        if (m) atomicMax(longest, m);
    }
}

unsigned blocks(int64_t threads) {
    return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Gathers the n keys' run starts into heads (int64 [n]) and their count
// into *nheads (zero on entry), one thread a key, on `stream`; returns
// cudaGetLastError().
int run_heads_launch(const uint64_t* keys, int64_t n, int shift,
                     int64_t* heads, unsigned long long* nheads,
                     void* stream) {
    run_heads_kernel<<<blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(keys, n, shift,
                                                            heads, nheads);
    return static_cast<int>(cudaGetLastError());
}

// Walks the nruns runs that start at heads, one thread a run, on
// `stream`; returns cudaGetLastError().
int walk_runs_launch(const uint64_t* keys, int64_t n, int shift,
                     const int64_t* heads, int64_t nruns,
                     int64_t arena_size, int64_t L, const int32_t* tpl,
                     int adv, uint8_t* probs, uint8_t* zero,
                     int32_t* longest, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (adv) {
        walk_runs_kernel<true><<<blocks(nruns), kThreads, 0, s>>>(
            keys, n, shift, heads, nruns, arena_size, L, tpl, probs, zero,
            longest);
    } else {
        walk_runs_kernel<false><<<blocks(nruns), kThreads, 0, s>>>(
            keys, n, shift, heads, nruns, arena_size, L, tpl, probs, zero,
            longest);
    }
    return static_cast<int>(cudaGetLastError());
}

const char* branch_probs_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
