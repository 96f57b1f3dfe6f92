// checked.cuh -- the bounds checks of the kernels' checked builds.
//
// compute-sanitizer's memcheck does not run on every machine with a card,
// so each kernel checks its own indices where they come from its inputs:
// every source is built twice (kernels/cuda_build.py), the default build
// and, with -DLEPTON_CHECKED -lineinfo, a checked one.
//
//   LEP_CHECK(site, i, n)  a statement: in a checked build an i outside
//                          [0, n) is recorded and clamped into it (to 0
//                          when n <= 0), so the access that follows stays
//                          inside the buffer; i must be an lvalue.
//   LEP_OK(site, i, n)     an expression: true when i lies in [0, n); in a
//                          checked build a false one is recorded.  Guards
//                          a store (skipped) or a load (given another
//                          value).
//
// In the default build LEP_CHECK expands to nothing and LEP_OK to true, so
// the checks compile away (chip_smoke.py phase 19 holds ptxas's report of
// the default build unchanged).  `site` names the check for the reader and
// for cuda_build.check_sites, which reads it from the source; the device
// keeps only __LINE__, so each LEP_ call stays on one line.
//
// The record: the first violation of a launch (its line, CTA, thread,
// index and limit) goes into one device record by one atomicCAS; the
// launch runs on (no __trap(), which would end the CUDA context and every
// later launch of the process).  lep_check_take, exported by a checked
// build only, copies the record to the host after the launch and clears
// it; the wrapper raises cuda_build.KernelBoundsError when it holds a
// violation.  Each source includes this header once and is a library of
// its own, so each library has its own record.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifdef LEPTON_CHECKED

namespace lepcheck {

struct Record {
    int32_t hit;
    int32_t line;
    int32_t cta;
    int32_t thread;
    long long index;
    long long limit;
};

__device__ Record g_record;

__device__ __noinline__ void report(int line, long long i, long long n) {
    if (atomicCAS(&g_record.hit, 0, 1) == 0) {
        g_record.line = line;
        g_record.cta = static_cast<int32_t>(blockIdx.x);
        g_record.thread = static_cast<int32_t>(threadIdx.x);
        g_record.index = i;
        g_record.limit = n;
        __threadfence();
    }
}

__device__ __forceinline__ bool ok(int line, long long i, long long n) {
    if (i >= 0 && i < n) return true;
    report(line, i, n);
    return false;
}

__device__ __forceinline__ long long clamp(long long i, long long n) {
    return i < 0 || n <= 0 ? 0 : n - 1;
}

}  // namespace lepcheck

#define LEP_OK(site, i, n) \
    (::lepcheck::ok(__LINE__, static_cast<long long>(i), \
                    static_cast<long long>(n)))
#define LEP_CHECK(site, i, n) \
    do { \
        if (!LEP_OK(site, i, n)) { \
            (i) = static_cast<decltype(i)>(::lepcheck::clamp((i), (n))); \
        } \
    } while (0)

extern "C" __attribute__((visibility("default")))
int lep_check_take(long long* out, void* stream) {
    // out[0..5]: hit, line, CTA, thread, index, limit
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    lepcheck::Record r{};
    cudaError_t e = cudaMemcpyFromSymbolAsync(&r, lepcheck::g_record,
                                              sizeof(r), 0,
                                              cudaMemcpyDeviceToHost, st);
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = r.hit;
    out[1] = r.line;
    out[2] = r.cta;
    out[3] = r.thread;
    out[4] = r.index;
    out[5] = r.limit;
    if (r.hit) {
        const lepcheck::Record zero{};
        e = cudaMemcpyToSymbolAsync(lepcheck::g_record, &zero, sizeof(zero),
                                    0, cudaMemcpyHostToDevice, st);
        if (e == cudaSuccess) e = cudaStreamSynchronize(st);
    }
    return static_cast<int>(e);
}

#else

#define LEP_OK(site, i, n) true
#define LEP_CHECK(site, i, n)

#endif
