// vpx_branch.cuh -- the adaptive branch of the model arena, shared by the
// VPX coder (vpx_coder.cu), the ANS coder (ans_coder.cu) and the token
// decoder (vpx_decoder.cu), so that the kernels start from the same arena
// and update it by the same rules: update_branch for VPX lanes (containers
// v1 and v2), update_branch_adv for rANS lanes (container v3).
//
// A branch is one int32: fc | tc << 8 | prob << 16 (false count, true
// count, cached probability of a 0 bit), the layout of
// lepton_tpu_torch/model/tables.py (IDENTITY_BRANCH, arena_from_template).

#pragma once

#include <cstdint>

namespace vpx {

constexpr int32_t kIdentityBranch = 1 | (1 << 8) | (128 << 16);

__device__ __forceinline__ uint32_t branch_prob(int32_t packed) {
    return (static_cast<uint32_t>(packed) >> 16) & 0xFF;
}

// Branch::record_obs_and_update (branch.hh:82-100) on a packed branch.
// The prob wraps to 8 bits like the host's uint8 store: only the tc == 0
// corner, reachable from trained templates alone, yields 256.
__device__ __forceinline__ int32_t update_branch(int32_t packed, int obs) {
    const int fc = packed & 0xFF;
    const int tc = (packed >> 8) & 0xFF;
    int nfc, ntc, nprob;
    if (obs) {
        if (tc == 0xFF) {
            if (fc == 1) {
                nfc = 1; ntc = 0xFF; nprob = 0;
            } else {
                nfc = (1 + fc) >> 1; ntc = 129;
                nprob = (nfc << 8) / (nfc + 129);
            }
        } else {
            nfc = fc; ntc = tc + 1;
            nprob = (fc << 8) / (fc + tc + 1);
        }
    } else {
        if (fc == 0xFF) {
            if (tc == 1) {
                nfc = 0xFF; ntc = 1; nprob = 255;
            } else {
                ntc = (1 + tc) >> 1; nfc = 129;
                nprob = (129 << 8) / (129 + ntc);
            }
        } else {
            nfc = fc + 1; ntc = tc;
            nprob = ((fc + 1) << 8) / (fc + tc + 1);
        }
    }
    return nfc | (ntc << 8) | ((nprob & 0xFF) << 16);
}

// Branch::adv_record_obs_and_update (branch.hh:66-80), the rANS lanes'
// rule.  val is the observed side's count before the update; on overflow
// that side becomes 129 and the other (c + 1) >> 1.  The prob comes from
// the new counts, wraps to 8 bits and is ORed with 1.  No "never seen"
// case, unlike update_branch.
__device__ __forceinline__ int32_t update_branch_adv(int32_t packed,
                                                     int obs) {
    int fc = packed & 0xFF;
    int tc = (packed >> 8) & 0xFF;
    if (obs) {
        if (tc == 0xFF) {
            fc = (fc + 1) >> 1;
            tc = 129;
        } else {
            ++tc;
        }
    } else {
        if (fc == 0xFF) {
            tc = (tc + 1) >> 1;
            fc = 129;
        } else {
            ++fc;
        }
    }
    const int prob = (((fc << 8) / (fc + tc)) & 0xFF) | 1;
    return fc | (tc << 8) | (prob << 16);
}

}  // namespace vpx
