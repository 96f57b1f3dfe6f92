// vpx_coder.cu -- the VPX bool coder's walk (containers v1/v2 lanes) for
// Hopper (sm_90a).
//
// With the probability stage (branch_probs.cu, update_branch rule) it
// replaces lepton_tpu/kernels/pallas_coder.py::_coder_kernel (host side
// encode_streams_pallas / finalize).  This kernel is the second stage, the
// port of lepton_tpu/kernels/vpx_scan.py::arith_pass (:613-675): vpx_write
// (boolwriter.hh) over each lane's precomputed (probability, bit) stream.
//
// Bound: one serial chain a lane (split, clz normalise, emit), about a
// dozen dependent integer operations a symbol; a launch takes as long as
// its longest lane.  It moves 6 bytes a symbol in and about one byte out
// for every eight symbols, far below the card's bandwidth.  Before the
// probability stage existed the chain also held a read-modify-write of a
// 2.89 MB model arena in device memory a symbol.
//
// Design: one CTA a lane.  Warps 1-3 stage the lane's (idx, bit, prob) in
// chunks of 8192 symbols into a double buffer in shared memory, packed to
// 16 bits (prob | bit << 8 | PAD << 9), one chunk ahead of the walker;
// lane 0 of warp 0 walks the chunk in registers, so no symbol waits on
// device memory.  Staging by other warps was kept over register prefetch
// by the walker: it needs no alignment of the [S, L] rows and keeps the
// walker's loop free of load bookkeeping.  The stagers flag a chunk that
// holds PAD; the walker tests each symbol for PAD only in such a chunk (on
// the main path a lane's last).  The carry ripple reads back the lane's own
// output in device memory; carries are rare.
//
// Output: bytes [S, cap] and nbytes [S].  Past cap the kernel stops writing
// but keeps counting, so the caller sees nbytes > cap and relaunches the
// walk alone with a larger buffer.  Carries ripple backward in place over
// 0xFF bytes, as vpx_write does.  The stop-byte rule is applied on the
// host.  PAD anywhere is a no-op; FIXED_PROB arrives as probability 128.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC; bound with ctypes.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = -1;          // no-op lane padding
constexpr int kThreads = 128;         // warp 0 walks, warps 1-3 stage
constexpr int kStagers = kThreads - 32;
constexpr int kChunk = 8192;          // symbols a staged chunk
constexpr uint32_t kBit = 0x100;
constexpr uint32_t kPadFlag = 0x200;

// Warps 1-3: symbols [t0, t0 + kChunk) of the lane into buf, padded with
// PAD to a multiple of 8 so that the walker reads whole 16-byte groups;
// *has_pad is set when any staged symbol is PAD.
__device__ __forceinline__ void stage(const int32_t* __restrict__ li,
                                      const uint8_t* __restrict__ lb,
                                      const uint8_t* __restrict__ lp,
                                      int64_t t0, int64_t L, uint16_t* buf,
                                      int* has_pad) {
    const int cnt = L - t0 < kChunk ? static_cast<int>(L - t0) : kChunk;
    const int padded = (cnt + 7) & ~7;
    bool pad = false;
#pragma unroll 4
    for (int j = threadIdx.x - 32; j < padded; j += kStagers) {
        const int64_t t = t0 + j;
        const bool p = j >= cnt || li[t] == kPad;
        pad |= p;
        buf[j] = static_cast<uint16_t>(p ? kPadFlag
                                         : (lp[t] | (lb[t] ? kBit : 0u)));
    }
    if (__any_sync(0xffffffffu, pad) && (threadIdx.x & 31) == 0) {
        *has_pad = 1;
    }
}

// vpx_write (boolwriter.hh) of one staged symbol v on the lane's
// registers; kMayPad: v may be PAD, a no-op.
template <bool kMayPad>
__device__ __forceinline__ void code(uint32_t v, uint32_t& low, uint32_t& rng,
                                     int& count, int64_t& pos, uint8_t* o,
                                     int64_t cap) {
    if (kMayPad && (v & kPadFlag)) return;
    const uint32_t split = 1 + (((rng - 1) * (v & 0xFF)) >> 8);
    if (v & kBit) {
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
            // carry: +1 ripples back over 0xFF bytes
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
}

__global__ void __launch_bounds__(kThreads)
vpx_walk_kernel(const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ bit,
                const uint8_t* __restrict__ probs, int64_t L,
                uint8_t* __restrict__ out, int64_t cap,
                int32_t* __restrict__ nbytes) {
    __shared__ __align__(16) uint16_t buf[2][kChunk];
    __shared__ int has_pad[2];
    const int64_t s = blockIdx.x;
    const int32_t* li = idx + s * L;
    const uint8_t* lb = bit + s * L;
    const uint8_t* lp = probs + s * L;
    uint8_t* o = out + s * cap;
    const int64_t chunks = (L + kChunk - 1) / kChunk;
    if (threadIdx.x < 2) has_pad[threadIdx.x] = 0;
    __syncthreads();
    if (threadIdx.x >= 32 && chunks > 0) {
        stage(li, lb, lp, 0, L, buf[0], &has_pad[0]);
    }
    __syncthreads();

    uint32_t low = 0;      // vpx lowvalue, wrapping uint32
    uint32_t rng = 255;
    int count = -24;
    int64_t pos = 0;
    for (int64_t c = 0; c < chunks; ++c) {
        if (threadIdx.x >= 32) {
            if (c + 1 < chunks) {
                stage(li, lb, lp, (c + 1) * kChunk, L, buf[(c + 1) & 1],
                      &has_pad[(c + 1) & 1]);
            }
        } else if (threadIdx.x == 0) {
            // 8 symbols a 16-byte shared-memory load
            const uint4* g = reinterpret_cast<const uint4*>(buf[c & 1]);
            const int64_t left = L - c * kChunk;
            const int groups = left < kChunk ? static_cast<int>(left + 7) / 8
                                             : kChunk / 8;
            auto walk = [&](auto may_pad) {
                for (int q = 0; q < groups; ++q) {
                    const uint4 w = g[q];
                    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int h = 0; h < 8; ++h) {
                        code<decltype(may_pad)::value>(
                            (words[h >> 1] >> (16 * (h & 1))) & 0xFFFF, low,
                            rng, count, pos, o, cap);
                    }
                }
            };
            // a chunk without PAD (all but a lane's last, on the main
            // path) skips the per-symbol test
            if (has_pad[c & 1]) {
                walk(std::true_type{});
            } else {
                walk(std::false_type{});
            }
            has_pad[c & 1] = 0;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) nbytes[s] = static_cast<int32_t>(pos);
}

}  // namespace

extern "C" {

// Launches one CTA per lane on `stream`; returns cudaGetLastError().
int vpx_walk_launch(const int32_t* idx, const uint8_t* bit,
                    const uint8_t* probs, int64_t S, int64_t L, uint8_t* out,
                    int64_t cap, int32_t* nbytes, void* stream) {
    vpx_walk_kernel<<<static_cast<unsigned>(S), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        idx, bit, probs, L, out, cap, nbytes);
    return static_cast<int>(cudaGetLastError());
}

const char* vpx_walk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
