"""Adaptive binary branch state and its exact update rules.

Copy of lepton_tpu/model/branch.py (:1-137: fast_divide18bit_by_10bit,
update_branch, the reference src/vp8/model/branch.hh
record_obs_and_update, the VPX rule, and its transition LUTs), and of
adv_update_branch from lepton_tpu/coder/ans.py (:35-50,
adv_record_obs_and_update), the rule of the rANS lanes of container v3.
A branch is 3 bytes: (false_count, true_count, probability).  Identity =
(1, 1, 128).  The kernels and their plain versions apply the same rules to
packed branches; the tests hold them against these scalar forms.  The
LUTs drive the scalar segment codec (codec/blocks.py).
"""
from __future__ import annotations

import numpy as np

_next_state = None


def fast_divide18bit_by_10bit(num: int, denom: int) -> int:
    """Bit-exact port of the reference divider (numeric.hh:307-312)."""
    blen = denom.bit_length()
    divisor = ((((1 << blen) - denom) << 18) // denom) + 1
    length = blen - 1  # k16log2
    t = (divisor * num) >> 18
    return (t + ((num - t) >> 1)) >> length


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


def _build_next_state() -> np.ndarray:
    """Build the 256x256x2 -> (fc', tc', prob') transition LUT of
    update_branch (the reference's update_lookup, numeric.cc:4-17)."""
    fc = np.arange(256, dtype=np.int64)[:, None] * np.ones(256, dtype=np.int64)[None, :]
    tc = np.ones(256, dtype=np.int64)[:, None] * np.arange(256, dtype=np.int64)[None, :]
    out = np.zeros((256, 256, 2, 3), dtype=np.uint8)
    tot = np.maximum(fc + tc + 1, 1)

    # obs = True
    nfc = fc.copy()
    ntc = tc + 1
    nprob = (fc << 8) // tot
    ovf = tc == 0xFF
    hfc = (1 + fc) >> 1
    nfc = np.where(ovf, hfc, nfc)
    ntc = np.where(ovf, 129, ntc)
    nprob = np.where(ovf, (hfc << 8) // (hfc + 129), nprob)
    never = ovf & (fc == 1)
    nfc = np.where(never, 1, nfc)
    ntc = np.where(never, 0xFF, ntc)
    nprob = np.where(never, 0, nprob)
    out[:, :, 1, 0] = nfc.astype(np.uint8)
    out[:, :, 1, 1] = ntc.astype(np.uint8)
    out[:, :, 1, 2] = nprob.astype(np.uint8)

    # obs = False
    nfc = fc + 1
    ntc = tc.copy()
    nprob = ((fc + 1) << 8) // tot
    ovf = fc == 0xFF
    htc = (1 + tc) >> 1
    nfc = np.where(ovf, 129, nfc)
    ntc = np.where(ovf, htc, ntc)
    nprob = np.where(ovf, (129 << 8) // np.maximum(129 + htc, 1), nprob)
    never = ovf & (tc == 1)
    nfc = np.where(never, 0xFF, nfc)
    ntc = np.where(never, 1, ntc)
    nprob = np.where(never, 255, nprob)
    out[:, :, 0, 0] = nfc.astype(np.uint8)
    out[:, :, 0, 1] = ntc.astype(np.uint8)
    out[:, :, 0, 2] = nprob.astype(np.uint8)
    return out


def next_state_lut() -> np.ndarray:
    global _next_state
    if _next_state is None:
        _next_state = _build_next_state()
    return _next_state


_next_state_adv = None


def _build_next_state_adv() -> np.ndarray:
    """Transition LUT for adv_record_obs_and_update (branch.hh:66-80),
    the ANS-backend update rule (probability always ORed with 1)."""
    fc = np.arange(256, dtype=np.int64)[:, None] * np.ones(256, dtype=np.int64)[None, :]
    tc = np.ones(256, dtype=np.int64)[:, None] * np.arange(256, dtype=np.int64)[None, :]
    out = np.zeros((256, 256, 2, 3), dtype=np.uint8)
    for obs in (0, 1):
        if obs:
            nfc = fc.copy()
            ntc = tc + 1
            ovf = tc == 0xFF
            nfc = np.where(ovf, (fc + 1) >> 1, nfc)
            ntc = np.where(ovf, 129, ntc)
        else:
            nfc = fc + 1
            ntc = tc.copy()
            ovf = fc == 0xFF
            ntc = np.where(ovf, (tc + 1) >> 1, ntc)
            nfc = np.where(ovf, 129, nfc)
        nprob = ((nfc << 8) // np.maximum(nfc + ntc, 1)) | 1
        out[:, :, obs, 0] = nfc.astype(np.uint8)
        out[:, :, obs, 1] = ntc.astype(np.uint8)
        out[:, :, obs, 2] = nprob.astype(np.uint8)
    return out


def next_state_lut_adv() -> np.ndarray:
    global _next_state_adv
    if _next_state_adv is None:
        _next_state_adv = _build_next_state_adv()
    return _next_state_adv
