// ans_coder.cu -- the rANS coder's reverse walk (container v3 lanes) for
// Hopper (sm_90a).
//
// With the probability stage (branch_probs.cu, adv rule) it replaces the
// v3 phase B of lepton_tpu/kernels/batch_encode.py (_ansenc_packed_jit
// :378-428 = vpx_scan.model_probs_sorted(update="adv") + ans_pass).  This
// kernel is the second stage, the port of vpx_scan.py::ans_pass
// (:744-823) with the word order of its host side (_finalize_ans_lane
// :431-437, vpx_scan.finalize_ans_streams :826-852): the stream of
// coder/ans.py's ANSWriter (reference ans_bool_writer.hh:21-110 over
// rans64.hh), two interleaved 64-bit rANS states over (prob, bit) pairs,
// walked in reverse.
//
// Layout, as ANSWriter.finish has it: pair k holds second = symbol 2k and
// first = symbol 2k + 1 (an odd count puts the sentinel, bit 1 at prob 1,
// in the last pair's first slot).  The walk codes 4 nop pairs (0 at 128,
// 0 at 128), then pairs npairs-1 ... 0; state s1 takes the first slot, s2
// the second, s1's word is emitted before s2's; then the states flush as
// s1_hi, s1_lo, s2_hi, s2_lo.  The kernel writes the words in that order;
// the host reverses them and appends the parity tail
// (kernels/ans_coder.py finalize_ans).
//
// Bound: one serial chain a lane, two independent states deep; a launch
// takes as long as its longest lane.  It moves 2 bytes a symbol in and
// about one 4-byte word out for every 30 symbols, far below the card's
// bandwidth.  A 64-bit division by freq was the chain's costliest step.
//
// Design: one CTA a lane.  The division is the reciprocal of the port's
// _native/leptonc.c (RANS_DIV, ANS_ENC_LUT, init_rans_div, rans_divmod):
// one entry per (bit, prob) pair value, (m, x_max, l | start_inv << 32),
// made once on the host (ans_coder.enc_table) and held in shared memory;
// q = (mulhi(m, x) + x) >> l with the 65-bit sum's carry kept, then
// x' = x + q * (256 - freq) + start.  The entry depends only on the pair's
// bytes, so its load runs ahead of the state chain, and the emission is
// a predicated store, not a branch, so the two states' chains interleave.
// Warps 1-3 stage the lane's pairs, 4096 at a time, into a double buffer
// in shared memory ahead of the walker (lane 0 of warp 0), from the lane's
// end to its start; each pair is one 32-bit word of two 9-bit table
// indices (bit << 8 | prob), 4 pairs a 16-byte load.
//
// Output: words [S, cap] and nwords [S].  Past cap the kernel stops
// writing but keeps counting, so the caller sees nwords > cap and
// relaunches the walk alone with a larger buffer.  A 0 bit at probability
// 0 (freq 0) never reaches this kernel: the probability stage flags its
// lane and the host raises.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // warp 0 walks, warps 1-3 stage
constexpr int kStagers = kThreads - 32;
constexpr int kChunkPairs = 4096;      // pairs a staged chunk
constexpr int kEntries = 512;          // (bit << 8 | prob)
constexpr uint64_t kRansL = 1ull << 31;   // RANS64_L
constexpr int kNopPairs = 4;
constexpr uint32_t kNop = 128;         // bit 0 at prob 128
constexpr uint32_t kSentinel = 0x101;  // bit 1 at prob 1

// Warps 1-3: pairs [k0, k0 + cnt) of the lane into buf, each as
// second | first << 16.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ lb,
                                      const uint8_t* __restrict__ lp,
                                      int64_t n, int64_t k0, int cnt,
                                      uint32_t* buf) {
#pragma unroll 4
    for (int j = threadIdx.x - 32; j < cnt; j += kStagers) {
        const int64_t t = 2 * (k0 + j);
        const uint32_t second = lp[t] | (lb[t] ? 0x100u : 0u);
        const uint32_t first = t + 1 < n
            ? lp[t + 1] | (lb[t + 1] ? 0x100u : 0u) : kSentinel;
        buf[j] = second | first << 16;
    }
}

// Rans64EncPut (rans64.hh) by the reciprocal entry e of (bit, prob):
// renormalise, emitting the low word, while x >= x_max = (L >> 8 << 32) *
// freq, then x' = (x / freq) << 8 + x % freq + start.  No branch: the
// store is predicated, so two puts on independent states interleave.
__device__ __forceinline__ void put(uint64_t& x, const uint64_t* e,
                                    uint32_t* o, int64_t cap, int64_t& pos) {
    const bool renorm = x >= e[1];
    if (renorm & (pos < cap)) o[pos] = static_cast<uint32_t>(x);
    pos += renorm;
    x = renorm ? x >> 32 : x;
    const uint32_t l = static_cast<uint32_t>(e[2]) & 0xFF;
    const uint32_t start_inv = static_cast<uint32_t>(e[2] >> 32);
    // q = floor(x / freq) = (mulhi(m, x) + x) >> l, a 65-bit sum
    const uint64_t sum = __umul64hi(e[0], x) + x;
    const uint64_t carry = sum < x;
    const uint64_t q = (sum >> l) | ((carry << (63 - l)) << 1);
    x += q * (start_inv >> 16) + (start_inv & 0xFFFF);
}

__device__ __forceinline__ void emit(uint32_t w, uint32_t* o, int64_t cap,
                                     int64_t& pos) {
    if (pos < cap) o[pos] = w;
    ++pos;
}

__global__ void __launch_bounds__(kThreads)
ans_walk_kernel(const uint8_t* __restrict__ probs,
                const uint8_t* __restrict__ bit, int64_t L,
                const int32_t* __restrict__ nsyms,
                const uint64_t* __restrict__ table,
                uint32_t* __restrict__ out, int64_t cap,
                int32_t* __restrict__ nwords) {
    __shared__ uint64_t lut[kEntries * 3];
    __shared__ __align__(16) uint32_t buf[2][kChunkPairs];
    for (int k = threadIdx.x; k < kEntries * 3; k += kThreads) {
        lut[k] = table[k];
    }
    const int64_t s = blockIdx.x;
    const uint8_t* lp = probs + s * L;
    const uint8_t* lb = bit + s * L;
    uint32_t* o = out + s * cap;
    const int64_t n = nsyms[s];
    const int64_t npairs = (n + 1) / 2;
    const int64_t chunks = (npairs + kChunkPairs - 1) / kChunkPairs;
    // chunk c holds pairs [c * kChunkPairs, ...); the walk takes the last
    // chunk first
    auto count = [&](int64_t c) {
        const int64_t left = npairs - c * kChunkPairs;
        return left < kChunkPairs ? static_cast<int>(left) : kChunkPairs;
    };
    if (threadIdx.x >= 32 && chunks > 0) {
        stage(lb, lp, n, (chunks - 1) * kChunkPairs, count(chunks - 1),
              buf[(chunks - 1) & 1]);
    }
    __syncthreads();

    uint64_t x1 = kRansL, x2 = kRansL;
    int64_t pos = 0;
    if (threadIdx.x == 0) {
        for (int k = 0; k < kNopPairs; ++k) {
            put(x1, lut + 3 * kNop, o, cap, pos);
            put(x2, lut + 3 * kNop, o, cap, pos);
        }
    }
    for (int64_t c = chunks - 1; c >= 0; --c) {
        if (threadIdx.x >= 32) {
            if (c > 0) {
                stage(lb, lp, n, (c - 1) * kChunkPairs, count(c - 1),
                      buf[(c - 1) & 1]);
            }
        } else if (threadIdx.x == 0) {
            const uint32_t* b = buf[c & 1];
            auto pair = [&](uint32_t v) {
                put(x1, lut + 3 * (v >> 16), o, cap, pos);
                put(x2, lut + 3 * (v & 0xFFFF), o, cap, pos);
            };
            // walked backward: the chunk's last pairs past a multiple of
            // 4, then 4 pairs a 16-byte shared-memory load, the next
            // group's load made before this group's chain
            const int cnt = count(c);
            const int groups = cnt / 4;
            for (int k = cnt - 1; k >= 4 * groups; --k) pair(b[k]);
            const uint4* g = reinterpret_cast<const uint4*>(b);
            uint4 next = g[groups > 0 ? groups - 1 : 0];
            for (int q = groups - 1; q >= 0; --q) {
                const uint4 w = next;
                next = g[q > 0 ? q - 1 : 0];
                pair(w.w);
                pair(w.z);
                pair(w.y);
                pair(w.x);
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        emit(static_cast<uint32_t>(x1 >> 32), o, cap, pos);
        emit(static_cast<uint32_t>(x1), o, cap, pos);
        emit(static_cast<uint32_t>(x2 >> 32), o, cap, pos);
        emit(static_cast<uint32_t>(x2), o, cap, pos);
        nwords[s] = static_cast<int32_t>(pos);
    }
}

}  // namespace

extern "C" {

// Launches one CTA per lane on `stream`; returns cudaGetLastError().
int ans_walk_launch(const uint8_t* probs, const uint8_t* bit, int64_t S,
                    int64_t L, const int32_t* nsyms, const uint64_t* table,
                    uint32_t* out, int64_t cap, int32_t* nwords,
                    void* stream) {
    ans_walk_kernel<<<static_cast<unsigned>(S), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        probs, bit, L, nsyms, table, out, cap, nwords);
    return static_cast<int>(cudaGetLastError());
}

const char* ans_walk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
