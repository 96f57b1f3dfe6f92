// vpx_branch.cuh -- the adaptive branch of the model arena, shared by the
// VPX coder (vpx_coder.cu) and the VPX token decoder (vpx_decoder.cu), so
// that both kernels start from the same arena and update it by the same
// rule.
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

}  // namespace vpx
