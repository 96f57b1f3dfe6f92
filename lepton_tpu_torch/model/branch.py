"""Adaptive binary branch state and its exact update rules.

Copy of update_branch from lepton_tpu/model/branch.py (reference
src/vp8/model/branch.hh record_obs_and_update), the VPX rule, and of
adv_update_branch from lepton_tpu/coder/ans.py (:35-50,
adv_record_obs_and_update), the rule of the rANS lanes of container v3.
A branch is 3 bytes: (false_count, true_count, probability).  Identity =
(1, 1, 128).  The kernels and their plain versions apply the same rules to
packed branches; the tests hold them against these scalar forms.
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


def adv_update_branch(fc: int, tc: int, obs: bool):
    """Exact port of Branch::adv_record_obs_and_update (branch.hh:66-80).

    (fc, tc) are the counts *before* this observation.  The probability
    comes from the counts after it, wrapped to 8 bits like the host's
    uint8 store and ORed with 1 (a zero probability would break the rANS
    interval).  Unlike update_branch there is no "never seen" case.
    Returns the new (false_count, true_count, probability)."""
    if obs:
        val = tc
        tc += 1
        if val == 0xFF:
            fc = (fc + 1) >> 1
            tc = 129
    else:
        val = fc
        fc += 1
        if val == 0xFF:
            tc = (tc + 1) >> 1
            fc = 129
    return fc, tc, (((fc << 8) // (fc + tc)) & 0xFF) | 1
