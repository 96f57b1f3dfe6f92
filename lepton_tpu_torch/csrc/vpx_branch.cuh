// vpx_branch.cuh -- the adaptive branch of the model arena, shared by the
// probability stage of both coders (branch_probs.cu) and the token decoder
// (vpx_decoder.cu), so that the kernels start from the same arena and
// update it by the same rules: update_branch for VPX lanes (containers v1
// and v2), update_branch_adv for rANS lanes (container v3).
//
// A branch is one int32: fc | tc << 8 | prob << 16 (false count, true
// count, cached probability of a 0 bit), the layout of
// lepton_tpu_torch/model/tables.py (IDENTITY_BRANCH, arena_from_template).
//
// Both rules divide nfc << 8 (below 2^16) by nfc + ntc (1 to 510).  The
// division is a multiply by a reciprocal from a 512-entry table the
// kernel keeps in shared memory (fill_recip): for 2 <= d < 512,
// rcp[d] = ceil(2^32 / d) and n / d == __umulhi(n, rcp[d]) for every
// n < 2^16 (the error n * (rcp[d] - 2^32 / d) / 2^32 < 2^-16 never
// reaches the next integer, whose distance is at least 1 / d); d == 1
// gives n.  The next counts and their reciprocals depend only on the
// branch, so next_counts can run before the bit is known.

#pragma once

#include <cstdint>

namespace vpx {

constexpr int32_t kIdentityBranch = 1 | (1 << 8) | (128 << 16);
constexpr int kRecipSize = 512;

__device__ __forceinline__ uint32_t branch_prob(int32_t packed) {
    return (static_cast<uint32_t>(packed) >> 16) & 0xFF;
}

// rcp[d] = ceil(2^32 / d) for 2 <= d < kRecipSize, 0 for d < 2; thread t
// of nt fills its share.
__device__ __forceinline__ void fill_recip(uint32_t* rcp, int t, int nt) {
    for (int d = t; d < kRecipSize; d += nt) {
        rcp[d] = d >= 2 ? static_cast<uint32_t>(((1ull << 32) + d - 1) / d)
                        : 0;
    }
}

// A branch's counts, and its counts after a 0 bit (f0, t0) and after a 1
// bit (f1, t1) with the reciprocals of their sums: on overflow (a count
// at 255) the observed side becomes 129 and the other (c + 1) >> 1.
struct Next {
    int fc, tc, f0, t0, f1, t1;
    uint32_t m0, m1;
};

__device__ __forceinline__ Next next_counts(int32_t packed,
                                            const uint32_t* rcp) {
    Next n;
    n.fc = packed & 0xFF;
    n.tc = (packed >> 8) & 0xFF;
    n.f0 = n.fc == 0xFF ? 129 : n.fc + 1;
    n.t0 = n.fc == 0xFF ? (1 + n.tc) >> 1 : n.tc;
    n.f1 = n.tc == 0xFF ? (1 + n.fc) >> 1 : n.fc;
    n.t1 = n.tc == 0xFF ? 129 : n.tc + 1;
    n.m0 = rcp[n.f0 + n.t0];
    n.m1 = rcp[n.f1 + n.t1];
    return n;
}

// (nf << 8) / (nf + nt) for the observed side
__device__ __forceinline__ uint32_t next_prob(const Next& n, int obs) {
    const uint32_t nf = obs ? n.f1 : n.f0;
    const uint32_t num = nf << 8;
    const uint32_t q = __umulhi(num, obs ? n.m1 : n.m0);
    return nf + (obs ? n.t1 : n.t0) == 1 ? num : q;
}

// Branch::record_obs_and_update (branch.hh:82-100).  The prob wraps to 8
// bits like the host's uint8 store: only the tc == 0 corner, reachable
// from trained templates alone, yields 256.  Its "never seen" corners
// keep the counts: (1, 255) on a 1 bit gives prob 0, (255, 1) on a 0 bit
// gives 255.
__device__ __forceinline__ int32_t update_branch(const Next& n, int obs) {
    if (obs && n.tc == 0xFF && n.fc == 1) return 1 | (0xFF << 8);
    if (!obs && n.fc == 0xFF && n.tc == 1) {
        return 0xFF | (1 << 8) | (255 << 16);
    }
    const int nf = obs ? n.f1 : n.f0, nt = obs ? n.t1 : n.t0;
    return nf | (nt << 8) | ((next_prob(n, obs) & 0xFF) << 16);
}

// Branch::adv_record_obs_and_update (branch.hh:66-80), the rANS lanes'
// rule: the prob comes from the new counts, wraps to 8 bits and is ORed
// with 1.  No "never seen" case, unlike update_branch.
__device__ __forceinline__ int32_t update_branch_adv(const Next& n,
                                                     int obs) {
    const int nf = obs ? n.f1 : n.f0, nt = obs ? n.t1 : n.t0;
    return nf | (nt << 8) | (((next_prob(n, obs) & 0xFF) | 1) << 16);
}

__device__ __forceinline__ int32_t update_branch(int32_t packed, int obs,
                                                 const uint32_t* rcp) {
    return update_branch(next_counts(packed, rcp), obs);
}

__device__ __forceinline__ int32_t update_branch_adv(int32_t packed,
                                                     int obs,
                                                     const uint32_t* rcp) {
    return update_branch_adv(next_counts(packed, rcp), obs);
}

}  // namespace vpx
