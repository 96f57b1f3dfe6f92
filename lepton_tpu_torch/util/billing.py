"""Bit-level accounting: attribute compressed AND uncompressed bits to
the reference's 26 billing categories (src/vp8/util/billing.hh:6-91).

The reference instruments its hot loops (write_bit_bill at every
vpx_write, attributing 1 uncompressed bit + the renormalization shift as
compressed bits, boolwriter.hh:55-59).  Here the same accounting is a
pure *post-hoc* function of the (branch_index, bit) symbol stream:

  - the category of every symbol is recovered from its branch index
    (each model table occupies a disjoint arena range, and the innermost
    stride coordinate of the exponent tables is the unary bit position
    BITMAP/EXP1/EXP2/EXP3/EXPN);
  - the shared sign table is disambiguated by sequence context: a sign
    bit always immediately follows the last bit of its exponent's unary
    code, so the preceding exponent table names it SIGN_7x7/_EDGE/_DC;
  - compressed bits are the renorm shifts of an exact vpx_write replay
    (probabilities from the same adaptive-model recurrence the coder
    ran), so the per-category compressed totals reconcile with the
    actual stream sizes.

This keeps the production loops uninstrumented -- billing runs only at
-v2, like the reference's ENABLE_BILLING debug builds.

Copy of lepton_tpu/util/billing.py (:1-214); the replay's branch
transitions come from model/branch.next_state_lut.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from ..constants import VPX_NORM
from ..model.branch import next_state_lut
from ..model.tables import TABLE_OFFSETS, TABLE_SHAPES, TABLE_STRIDES

# the reference's category list, in enum order (billing.hh:6-33)
CATEGORIES = [
    "HEADER", "DELIMITERS", "RESERVED",
    "NZ_7x7", "BITMAP_7x7", "EXP1_7x7", "EXP2_7x7", "EXP3_7x7",
    "EXPN_7x7", "SIGN_7x7", "RES_7x7",
    "NZ_EDGE", "BITMAP_EDGE", "EXP1_EDGE", "EXP2_EDGE", "EXP3_EDGE",
    "EXPN_EDGE", "SIGN_EDGE", "RES_EDGE",
    "EXP0_DC", "EXP1_DC", "EXP2_DC", "EXP3_DC", "EXPN_DC",
    "SIGN_DC", "RES_DC",
]
_CAT = {n: i for i, n in enumerate(CATEGORIES)}

_OFF = {k: int(v) for k, v in TABLE_OFFSETS.items()}
_STR = {k: tuple(int(s) for s in v) for k, v in TABLE_STRIDES.items()}
_END = {name: _OFF[name] + int(np.prod(shape))
        for name, shape in TABLE_SHAPES}


def _exp_cats(first, rest1, rest2, rest3, restn):
    return np.asarray([first, rest1, rest2, rest3] + [restn] * 7,
                      dtype=np.int32)


def categorize(idx: np.ndarray) -> np.ndarray:
    """Per-symbol category ids for one stream (idx >= 0 entries; negative
    slots -- marker/stop -- map to DELIMITERS)."""
    idx = np.asarray(idx, dtype=np.int64)
    cat = np.full(idx.shape, _CAT["DELIMITERS"], np.int32)

    def in_t(name):
        return (idx >= _OFF[name]) & (idx < _END[name])

    cat[in_t("nz_7x7")] = _CAT["NZ_7x7"]
    cat[in_t("nz_1x8") | in_t("nz_8x1")] = _CAT["NZ_EDGE"]
    cat[in_t("residual_thresh")] = _CAT["RES_EDGE"]
    cat[in_t("residual_noise_dc")] = _CAT["RES_DC"]

    # residual_noise serves both 7x7 and edge coefficients, on disjoint
    # coordinate sets (interior r,c>=1 vs first row/column)
    m = in_t("residual_noise")
    r70, r71, r72, _ = _STR["residual_noise"]
    coord = ((idx[m] - _OFF["residual_noise"]) % r70) // r71
    edge = (coord < 8) | (coord % 8 == 0)
    cm = np.where(edge, _CAT["RES_EDGE"], _CAT["RES_7x7"])
    cat[m] = cm

    for name, cats in (
            ("exp_7x7", _exp_cats(_CAT["BITMAP_7x7"], _CAT["EXP1_7x7"],
                                  _CAT["EXP2_7x7"], _CAT["EXP3_7x7"],
                                  _CAT["EXPN_7x7"])),
            ("exp_x", _exp_cats(_CAT["BITMAP_EDGE"], _CAT["EXP1_EDGE"],
                                _CAT["EXP2_EDGE"], _CAT["EXP3_EDGE"],
                                _CAT["EXPN_EDGE"])),
            ("exp_dc", _exp_cats(_CAT["EXP0_DC"], _CAT["EXP1_DC"],
                                 _CAT["EXP2_DC"], _CAT["EXP3_DC"],
                                 _CAT["EXPN_DC"]))):
        m = in_t(name)
        i = (idx[m] - _OFF[name]) % 11
        cat[m] = cats[np.minimum(i, 10)]

    # signs: category = the exponent family that immediately precedes
    # (a sign bit always directly follows its unary exponent)
    m_sign = in_t("sign")
    if m_sign.any():
        fam = np.zeros(idx.shape, np.int32)          # 0 none,1 7x7,2 edge,3 dc
        fam[in_t("exp_7x7")] = 1
        fam[in_t("exp_x")] = 2
        fam[in_t("exp_dc")] = 3
        # forward-fill the last nonzero family
        nz = fam != 0
        pos = np.where(nz, np.arange(len(fam)), 0)
        np.maximum.accumulate(pos, out=pos)
        last = fam[pos]
        sign_cat = np.asarray([_CAT["RESERVED"], _CAT["SIGN_7x7"],
                               _CAT["SIGN_EDGE"], _CAT["SIGN_DC"]],
                              np.int32)
        cat[m_sign] = sign_cat[last[m_sign]]
    return cat


def replay_shifts(idx: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Renormalization shift (compressed bits emitted) per symbol: an
    exact replay of vpx_write over the adaptive model recurrence
    (boolwriter.hh:48-118 + branch.hh:82-100), matching what the
    reference attributes via write_bit_bill(bt, true, shift)."""
    lut = next_state_lut().reshape(-1).tobytes()  # [(fc<<8|tc)<<1|bit]*3
    norm = bytes(int(v) for v in VPX_NORM)
    av = bytearray(b"\x01\x01\x80" * max(_END.values()))
    shifts = np.zeros(len(idx), np.int32)
    # marker bit (prob 128, bit 0): rng 255 -> 128, shift 0
    rng = 1 + ((254 * 128) >> 8)
    rng <<= norm[rng]
    lidx = idx.tolist()
    lbits = bits.tolist()
    for t in range(len(lidx)):
        ix = lidx[t]
        b = lbits[t]
        if ix >= 0:
            o = ix * 3
            prob = av[o + 2]
            s = (((av[o] << 8) | av[o + 1]) << 1 | b) * 3
            av[o] = lut[s]
            av[o + 1] = lut[s + 1]
            av[o + 2] = lut[s + 2]
        else:
            prob = 128
        split = 1 + (((rng - 1) * prob) >> 8)
        rng = rng - split if b else split
        sh = norm[rng]
        rng <<= sh
        shifts[t] = sh
    return shifts


def bill_streams(segments: Iterable[Tuple[np.ndarray, np.ndarray]],
                 header_bytes: int = 0,
                 mux_overhead_bytes: int = 0) -> Dict[str, Tuple[int, int]]:
    """Full billing maps over per-segment (idx, bit) symbol streams.

    Returns {category: (uncompressed_bits, compressed_bits)}.  The 32
    stop bits per segment and mux framing land in DELIMITERS; container
    header bytes in HEADER (write_byte_bill semantics)."""
    out = {n: [0, 0] for n in CATEGORIES}
    out["HEADER"][0] += 8 * header_bytes
    out["HEADER"][1] += 8 * header_bytes
    out["DELIMITERS"][0] += 8 * mux_overhead_bytes
    out["DELIMITERS"][1] += 8 * mux_overhead_bytes
    for idx, bits in segments:
        idx = np.asarray(idx, np.int64)
        bits = np.asarray(bits, np.uint8)
        # stop bits: 32 fixed-prob zeros after the stream
        idx = np.concatenate([idx, np.full(32, -2, np.int64)])
        bits = np.concatenate([bits, np.zeros(32, np.uint8)])
        cats = categorize(idx)
        shifts = replay_shifts(idx, bits)
        ub = np.bincount(cats, minlength=len(CATEGORIES))
        cb = np.bincount(cats, weights=shifts, minlength=len(CATEGORIES))
        for i, n in enumerate(CATEGORIES):
            out[n][0] += int(ub[i])
            out[n][1] += int(cb[i])
    return {k: (v[0], v[1]) for k, v in out.items()}


def print_bill(segments, file=None, header_bytes: int = 0,
               mux_overhead_bytes: int = 0,
               stream_bytes: int = 0) -> None:
    """print_bill(2)-style table (jpgcoder.cc:1944): per category,
    compressed and uncompressed bit totals in enum order, plus a
    reconciliation line against the actual stream size."""
    import sys
    file = file or sys.stderr
    bill = bill_streams(segments, header_bytes, mux_overhead_bytes)
    file.write(f"{'category':<14}{'uncompressed':>14}{'compressed':>12}"
               f"{'ratio':>8}\n")
    tot_u = tot_c = 0
    for name in CATEGORIES:
        u, c = bill[name]
        tot_u += u
        tot_c += int(c)
        if u or c:
            file.write(f"{name:<14}{u:>14}{int(c):>12}"
                       f"{(c / u if u else 0.0):>8.3f}\n")
    file.write(f"{'TOTAL':<14}{tot_u:>14}{tot_c:>12}"
               f"{(tot_c / max(tot_u, 1)):>8.3f}\n")
    if stream_bytes:
        # compare the replayed coder shifts against the actual mux
        # streams (header/mux byte-categories excluded); the coder's
        # initial count=-24 phantom bits per segment are the only slack
        coder_bits = tot_c - 8 * (header_bytes + mux_overhead_bytes)
        file.write(f"stream bytes: {stream_bytes} "
                   f"({8 * stream_bytes} bits vs {coder_bits} coder-billed; "
                   f"residue {8 * stream_bytes - coder_bits} "
                   f"= per-segment phantom/flush bits)\n")


def bill_symbol_stream(idx: np.ndarray) -> Dict[str, int]:
    """Decision counts per category (uncompressed map only), kept for
    API compatibility with the r1 billing tool (billing.py:209-214)."""
    cats = categorize(np.asarray(idx, np.int64))
    ub = np.bincount(cats, minlength=len(CATEGORIES))
    return {n: int(ub[i]) for i, n in enumerate(CATEGORIES) if ub[i]}
