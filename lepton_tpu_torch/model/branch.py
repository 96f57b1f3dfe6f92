"""Adaptive binary branch state and its exact update rule.

Copy of update_branch from lepton_tpu/model/branch.py (reference
src/vp8/model/branch.hh record_obs_and_update).  A branch is 3 bytes:
(false_count, true_count, probability).  Identity = (1, 1, 128).  The coder
kernel and its plain version apply the same rule to packed branches; the
tests hold them against this scalar form.
"""
from __future__ import annotations


def update_branch(fc: int, tc: int, prob: int, obs: bool):
    """Exact port of Branch::record_obs_and_update (branch.hh:82-100).

    (fc, tc) are the counts *before* this observation.  Returns the new
    (false_count, true_count, probability).
    """
    if obs:
        if tc == 0xFF:  # overflow
            if fc == 1:  # neverseen: other count still at identity
                return 1, 0xFF, 0
            nfc = (1 + fc) >> 1
            return nfc, 129, (nfc << 8) // (nfc + 129)
        return fc, tc + 1, (fc << 8) // (fc + tc + 1)
    else:
        if fc == 0xFF:  # overflow
            if tc == 1:
                return 0xFF, 1, 255
            ntc = (1 + tc) >> 1
            return 129, ntc, (129 << 8) // (129 + ntc)
        return fc + 1, tc, ((fc + 1) << 8) // (fc + tc + 1)
