"""Per-block token codec: the compression brain.

Exact mirror of the reference's serialize_tokens (src/vp8/encoder/encoder.cc:
195-402, encode_one_edge :41-164) and parse_tokens (src/vp8/decoder/decoder.cc:
168-319, decode_one_edge :29-142), restructured around flat arrays:

  - coefficients are raster-order int16[64] blocks in [height][width][64]
    planes (the reference's "aligned" SIMD layout is an implementation detail
    of its C++; iteration orders and contexts are identical)
  - the model is one flat (N,3) byte arena (see model/tables.py)
  - neighbor state is a 2-row ring of (num_nonzeros, edge_pixels[16])

This scalar path is the semantics reference for the C fast path
(_native/leptonc.c) and the card's batched symbolizer and coders.

Copy of lepton_tpu/codec/blocks.py (:1-497), kept as it is, the hot loop's
bytearray idiom included: it is the scalar reference, and the host codec's
route when the C library cannot be built (host.py).
"""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..model import context as ctx
from ..model.branch import next_state_lut, next_state_lut_adv
from ..model.tables import TABLE_OFFSETS, TABLE_STRIDES

_UNZIG49 = [int(v) for v in C.UNZIGZAG49]
_NZ_BIN = [int(v) for v in C.NONZERO_TO_BIN]

# Flattened next-state LUTs: index = ((fc<<8 | tc) << 1 | obs) * 3
_LUT3 = next_state_lut().reshape(-1).tobytes()
_LUT3_ADV = None


def _lut3_adv():
    global _LUT3_ADV
    if _LUT3_ADV is None:
        _LUT3_ADV = next_state_lut_adv().reshape(-1).tobytes()
    return _LUT3_ADV

# Precomputed table base offsets / strides (plain ints for the hot loop)
_OFF = {k: int(v) for k, v in TABLE_OFFSETS.items()}
_STR = {k: tuple(int(s) for s in v) for k, v in TABLE_STRIDES.items()}


class Coder:
    """Couples a bool writer/reader with the adaptive model arena."""

    __slots__ = ("arena", "writer", "reader", "lut")

    def __init__(self, arena: bytearray = None, writer=None, reader=None,
                 ans: bool = False):
        self.arena = arena
        self.writer = writer
        self.reader = reader
        self.lut = _lut3_adv() if ans else _LUT3

    def put(self, bit: int, idx: int) -> None:
        a = self.arena
        lut = self.lut
        o = idx * 3
        self.writer.put_bit(bit, a[o + 2])
        s = (((a[o] << 8) | a[o + 1]) << 1 | bit) * 3
        a[o] = lut[s]
        a[o + 1] = lut[s + 1]
        a[o + 2] = lut[s + 2]

    def get(self, idx: int) -> int:
        a = self.arena
        lut = self.lut
        o = idx * 3
        bit = self.reader.get_bit(a[o + 2])
        s = (((a[o] << 8) | a[o + 1]) << 1 | bit) * 3
        a[o] = lut[s]
        a[o + 1] = lut[s + 1]
        a[o + 2] = lut[s + 2]
        return bit


def _bsr_best_prior(best_prior: int) -> int:
    v = abs(best_prior)
    if v > 1023:
        v = 1023
    return v.bit_length()


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode_block(coder: Coder, color_index: int, colors: ctx.ColorTables,
                 here: np.ndarray, left, above, aboveleft,
                 left_summary, above_summary, cur_summary) -> None:
    """Serialize one 8x8 block.  `here`/`left`/... are raster int16[64]
    (neighbors None when not present in this segment).  Summaries are
    (nz, int16[16]) mutable pairs; cur_summary is updated in place.
    """
    put = coder.put
    ci = color_index
    here_i = [int(v) for v in here]

    # --- 7x7 nonzero count, binary tree coded (encoder.cc:200-213)
    num_nonzeros_7x7 = 0
    for r in range(1, 8):
        base = r * 8
        for c in range(1, 8):
            if here_i[base + c]:
                num_nonzeros_7x7 += 1
    cur_summary[0] = num_nonzeros_7x7

    if above_summary is not None and left_summary is not None:
        nz_ctx = (above_summary[0] + left_summary[0] + 2) // 4
    elif above_summary is not None:
        nz_ctx = (above_summary[0] + 1) // 2
    elif left_summary is not None:
        nz_ctx = (left_summary[0] + 1) // 2
    else:
        nz_ctx = 0
    nz_bin = _NZ_BIN[nz_ctx]
    s70, s71, s72, _ = _STR["nz_7x7"]
    nz_base = _OFF["nz_7x7"] + ci * s70 + nz_bin * s71
    so_far = 0
    for index in range(5, -1, -1):
        bit = (num_nonzeros_7x7 >> index) & 1
        put(bit, nz_base + index * s72 + so_far)
        so_far = (so_far << 1) | bit

    # --- 49 interior coefficients in lepton zigzag order (encoder.cc:216-285)
    eob_x = 0
    eob_y = 0
    nz_left = num_nonzeros_7x7
    e70, e71, e72, e73, _ = _STR["exp_7x7"]
    exp7_base = _OFF["exp_7x7"] + ci * e70
    r70, r71, r72, _ = _STR["residual_noise"]
    res_base = _OFF["residual_noise"] + ci * r70
    sg0, sg1, _ = _STR["sign"]
    sign_base = _OFF["sign"] + ci * sg0
    zz = 0
    while zz < 49 and nz_left:
        coord = _UNZIG49[zz]
        coef = here_i[coord]
        abs_coef = -coef if coef < 0 else coef
        length = abs_coef.bit_length()
        aavrg = ctx.compute_aavrg(coord, left, above, aboveleft)
        bsr = _bsr_best_prior(aavrg)
        nnz_bin = _NZ_BIN[nz_left]
        exp_slice = exp7_base + nnz_bin * e71 + zz * e72 + bsr * e73
        for i in range(C.MAX_EXPONENT):
            cur_bit = 1 if length != i else 0
            put(cur_bit, exp_slice + i)
            if not cur_bit:
                break
        if length:
            put(1 if coef >= 0 else 0, sign_base)  # sign_array_7x7: [ci][0][0]
            nz_left -= 1
            bx = coord & 7
            by = coord >> 3
            if bx > eob_x:
                eob_x = bx
            if by > eob_y:
                eob_y = by
        if length > 1:
            res_slice = res_base + coord * r71 + nnz_bin * r72
            for i in range(length - 2, -1, -1):
                put((abs_coef >> i) & 1, res_slice + i)
        zz += 1

    # --- edges (encoder.cc:166-184: horizontal first, then vertical)
    _encode_edge(coder, ci, colors, here_i, here, left, above,
                 num_nonzeros_7x7, eob_x, True)
    _encode_edge(coder, ci, colors, here_i, here, left, above,
                 num_nonzeros_7x7, eob_y, False)

    # --- DC last (encoder.cc:293-364)
    predicted_val, uncertainty, uncertainty2, pixels = ctx.adv_predict_dc_pix(
        here, colors,
        None if left_summary is None else left_summary[1],
        None if above_summary is None else above_summary[1])
    dc = here_i[0]
    adv_predicted_dc = ctx.adv_predict_or_unpredict_dc(dc, False, predicted_val)
    coef = adv_predicted_dc
    abs_coef = -coef if coef < 0 else coef
    length = abs_coef.bit_length()
    len_abs_mxm = abs(uncertainty).bit_length()
    len_abs_off = abs(uncertainty2).bit_length()
    ed0, ed1, _ = _STR["exp_dc"]
    exp_slice = (_OFF["exp_dc"] + min(len_abs_mxm, C.NUMERIC_LENGTH_MAX - 1) * ed0
                 + min(len_abs_off, 16) * ed1)
    for i in range(C.MAX_EXPONENT):
        cur_bit = 1 if length != i else 0
        put(cur_bit, exp_slice + i)
        if not cur_bit:
            break
    if length:
        sctx = (3 if uncertainty2 == 0 else 2) if uncertainty2 >= 0 else 1
        put(1 if coef >= 0 else 0, sign_base + sctx)
    if length > 1:
        rd0, _ = _STR["residual_noise_dc"]
        res_slice = (_OFF["residual_noise_dc"]
                     + min(C.NUMERIC_LENGTH_MAX - 1, len_abs_mxm) * rd0)
        for i in range(length - 2, -1, -1):
            put((abs_coef >> i) & 1, res_slice + i)

    # --- outgoing neighbor summary (encoder.cc:365-373)
    q0 = int(colors.quant[0])
    cur_summary[1][0:8] = ctx.set_vertical(pixels, q0, dc)
    cur_summary[1][8:16] = ctx.set_horizontal(pixels, q0, dc)


def _encode_edge(coder: Coder, ci: int, colors: ctx.ColorTables,
                 here_i, here, left, above,
                 num_nonzeros_7x7: int, est_eob: int, horizontal: bool) -> None:
    put = coder.put
    if horizontal:
        num_nonzeros_edge = sum(1 for k in range(1, 8) if here_i[k])
        delta = 1
        zig15 = 0
        tbl = "nz_8x1"
    else:
        num_nonzeros_edge = sum(1 for k in range(1, 8) if here_i[k * 8])
        delta = 8
        zig15 = 7
        tbl = "nz_1x8"

    n0, n1, n2, n3, _ = _STR[tbl]
    nz_slice = (_OFF[tbl] + ci * n0 + est_eob * n1
                + ((num_nonzeros_7x7 + 3) // 7) * n2)
    so_far = 0
    for i in range(2, -1, -1):
        bit = (num_nonzeros_edge >> i) & 1
        put(bit, nz_slice + i * n3 + so_far)
        so_far = (so_far << 1) | bit

    ex0, ex1, ex2, ex3, _ = _STR["exp_x"]
    expx_base = _OFF["exp_x"] + ci * ex0
    rt0, rt1, rt2, _ = _STR["residual_thresh"]
    rt_base = _OFF["residual_thresh"] + ci * rt0
    r70, r71, r72, _ = _STR["residual_noise"]
    res_base = _OFF["residual_noise"] + ci * r70
    sg0, sg1, _ = _STR["sign"]
    sign_base = _OFF["sign"] + ci * sg0

    coord = delta
    lane = 0
    while lane < 7 and num_nonzeros_edge:
        best_prior = ctx.compute_lak(coord, here, above, left, colors)
        bsr = _bsr_best_prior(best_prior)
        exp_slice = (expx_base + num_nonzeros_edge * ex1
                     + (zig15 + lane) * ex2 + bsr * ex3)
        coef = here_i[coord]
        abs_coef = -coef if coef < 0 else coef
        length = abs_coef.bit_length()
        for i in range(C.MAX_EXPONENT):
            cur_bit = 1 if length != i else 0
            put(cur_bit, exp_slice + i)
            if not cur_bit:
                break
        if coef:
            min_threshold = int(colors.min_noise_threshold[coord])
            ctx1 = 0 if best_prior == 0 else (1 if best_prior > 0 else 2)
            put(1 if coef >= 0 else 0, sign_base + ctx1 * sg1 + bsr)
            num_nonzeros_edge -= 1
            if length > 1:
                i = length - 2
                if i >= min_threshold:
                    abs_prior = -best_prior if best_prior < 0 else best_prior
                    t1 = abs_prior >> min_threshold
                    if t1 > 255:
                        t1 = 255
                    t2 = length - min_threshold
                    if t2 > 1 + C.RESIDUAL_NOISE_FLOOR - 1:
                        t2 = 1 + C.RESIDUAL_NOISE_FLOOR - 1
                    thresh_slice = rt_base + t1 * rt1 + t2 * rt2
                    encoded_so_far = 1
                    while i >= min_threshold:
                        cur_bit = (abs_coef >> i) & 1
                        put(cur_bit, thresh_slice + encoded_so_far)
                        encoded_so_far = (encoded_so_far << 1) | cur_bit
                        if encoded_so_far > (1 << C.RESIDUAL_NOISE_FLOOR) - 1:
                            encoded_so_far = (1 << C.RESIDUAL_NOISE_FLOOR) - 1
                        i -= 1
                    # fall through to noise bits below min_threshold
                res_slice = (res_base + coord * r71
                             + num_nonzeros_edge_bin(num_nonzeros_edge + 1) * r72)
                while i >= 0:
                    put((abs_coef >> i) & 1, res_slice + i)
                    i -= 1
        lane += 1
        coord += delta


def num_nonzeros_edge_bin(n: int) -> int:
    # Edge residual contexts use the raw remaining-count (pre-decrement)
    # as the "bin" (reference update_coefficient_context8, model.hh:403-419)
    return n


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class StreamInconsistent(Exception):
    pass


def decode_block(coder: Coder, color_index: int, colors: ctx.ColorTables,
                 here: np.ndarray, left, above, aboveleft,
                 left_summary, above_summary, cur_summary) -> None:
    """Parse one 8x8 block into `here` (raster int16[64], zeroed here)."""
    get = coder.get
    ci = color_index
    here[:] = 0
    here_i = [0] * 64

    if above_summary is not None and left_summary is not None:
        nz_ctx = (above_summary[0] + left_summary[0] + 2) // 4
    elif above_summary is not None:
        nz_ctx = (above_summary[0] + 1) // 2
    elif left_summary is not None:
        nz_ctx = (left_summary[0] + 1) // 2
    else:
        nz_ctx = 0
    nz_bin = _NZ_BIN[nz_ctx]
    s70, s71, s72, _ = _STR["nz_7x7"]
    nz_base = _OFF["nz_7x7"] + ci * s70 + nz_bin * s71
    num_nonzeros_7x7 = 0
    so_far = 0
    for index in range(5, -1, -1):
        bit = get(nz_base + index * s72 + so_far)
        num_nonzeros_7x7 |= bit << index
        so_far = (so_far << 1) | bit
    if num_nonzeros_7x7 > 49:
        raise StreamInconsistent("7x7 nonzero count > 49")

    eob_x = 0
    eob_y = 0
    nz_left = num_nonzeros_7x7
    e70, e71, e72, e73, _ = _STR["exp_7x7"]
    exp7_base = _OFF["exp_7x7"] + ci * e70
    r70, r71, r72, _ = _STR["residual_noise"]
    res_base = _OFF["residual_noise"] + ci * r70
    sg0, sg1, _ = _STR["sign"]
    sign_base = _OFF["sign"] + ci * sg0
    zz = 0
    while zz < 49 and nz_left:
        coord = _UNZIG49[zz]
        aavrg = ctx.compute_aavrg(coord, left, above, aboveleft)
        bsr = _bsr_best_prior(aavrg)
        nnz_bin = _NZ_BIN[nz_left]
        exp_slice = exp7_base + nnz_bin * e71 + zz * e72 + bsr * e73
        length = 0
        while length != C.MAX_EXPONENT:
            if not get(exp_slice + length):
                break
            length += 1
        if length:
            neg = not get(sign_base)
            nz_left -= 1
            bx = coord & 7
            by = coord >> 3
            if bx > eob_x:
                eob_x = bx
            if by > eob_y:
                eob_y = by
            coef = 1 << (length - 1)
            if length > 1:
                res_slice = res_base + coord * r71 + nnz_bin * r72
                for i in range(length - 2, -1, -1):
                    coef |= get(res_slice + i) << i
            if neg:
                coef = -coef
            here_i[coord] = coef
            here[coord] = coef
        zz += 1

    _decode_edge(coder, ci, colors, here_i, here, left, above,
                 num_nonzeros_7x7, eob_x, True)
    _decode_edge(coder, ci, colors, here_i, here, left, above,
                 num_nonzeros_7x7, eob_y, False)

    # DC
    predicted_dc, uncertainty, uncertainty2, pixels = ctx.adv_predict_dc_pix(
        here, colors,
        None if left_summary is None else left_summary[1],
        None if above_summary is None else above_summary[1])
    len_abs_mxm = abs(uncertainty).bit_length()
    len_abs_off = abs(uncertainty2).bit_length()
    ed0, ed1, _ = _STR["exp_dc"]
    exp_slice = (_OFF["exp_dc"] + min(len_abs_mxm, C.NUMERIC_LENGTH_MAX - 1) * ed0
                 + min(len_abs_off, 16) * ed1)
    length = 0
    while length < C.MAX_EXPONENT:
        if not get(exp_slice + length):
            break
        length += 1
    coef = 0
    if length:
        sctx = (3 if uncertainty2 == 0 else 2) if uncertainty2 >= 0 else 1
        neg = not get(sign_base + sctx)
        coef = 1 << (length - 1)
        if length > 1:
            rd0, _ = _STR["residual_noise_dc"]
            res_slice = (_OFF["residual_noise_dc"]
                         + min(C.NUMERIC_LENGTH_MAX - 1, len_abs_mxm) * rd0)
            for i in range(length - 2, -1, -1):
                coef |= get(res_slice + i) << i
        if neg:
            coef = -coef
    dc = ctx.adv_predict_or_unpredict_dc(coef, True, predicted_dc)
    here[0] = dc

    cur_summary[0] = num_nonzeros_7x7
    q0 = int(colors.quant[0])
    cur_summary[1][0:8] = ctx.set_vertical(pixels, q0, dc)
    cur_summary[1][8:16] = ctx.set_horizontal(pixels, q0, dc)


def _decode_edge(coder: Coder, ci: int, colors: ctx.ColorTables,
                 here_i, here, left, above,
                 num_nonzeros_7x7: int, est_eob: int, horizontal: bool) -> None:
    get = coder.get
    if horizontal:
        delta = 1
        zig15 = 0
        tbl = "nz_8x1"
    else:
        delta = 8
        zig15 = 7
        tbl = "nz_1x8"

    n0, n1, n2, n3, _ = _STR[tbl]
    nz_slice = (_OFF[tbl] + ci * n0 + est_eob * n1
                + ((num_nonzeros_7x7 + 3) // 7) * n2)
    num_nonzeros_edge = 0
    so_far = 0
    for i in range(2, -1, -1):
        bit = get(nz_slice + i * n3 + so_far)
        num_nonzeros_edge |= bit << i
        so_far = (so_far << 1) | bit
    if num_nonzeros_edge > 7:
        raise StreamInconsistent("edge nonzero count > 7")

    ex0, ex1, ex2, ex3, _ = _STR["exp_x"]
    expx_base = _OFF["exp_x"] + ci * ex0
    rt0, rt1, rt2, _ = _STR["residual_thresh"]
    rt_base = _OFF["residual_thresh"] + ci * rt0
    r70, r71, r72, _ = _STR["residual_noise"]
    res_base = _OFF["residual_noise"] + ci * r70
    sg0, sg1, _ = _STR["sign"]
    sign_base = _OFF["sign"] + ci * sg0

    coord = delta
    lane = 0
    while lane < 7 and num_nonzeros_edge:
        best_prior = ctx.compute_lak(coord, here, above, left, colors)
        bsr = _bsr_best_prior(best_prior)
        exp_slice = (expx_base + num_nonzeros_edge * ex1
                     + (zig15 + lane) * ex2 + bsr * ex3)
        length = 0
        while length != C.MAX_EXPONENT:
            if not get(exp_slice + length):
                break
            length += 1
        if length:
            min_threshold = int(colors.min_noise_threshold[coord])
            ctx1 = 0 if best_prior == 0 else (1 if best_prior > 0 else 2)
            neg = not get(sign_base + ctx1 * sg1 + bsr)
            coef = 1 << (length - 1)
            num_nonzeros_edge -= 1
            if length > 1:
                i = length - 2
                if i >= min_threshold:
                    abs_prior = -best_prior if best_prior < 0 else best_prior
                    t1 = abs_prior >> min_threshold
                    if t1 > 255:
                        t1 = 255
                    t2 = length - min_threshold
                    if t2 > C.RESIDUAL_NOISE_FLOOR:
                        t2 = C.RESIDUAL_NOISE_FLOOR
                    thresh_slice = rt_base + t1 * rt1 + t2 * rt2
                    decoded_so_far = 1
                    while i >= min_threshold:
                        cur_bit = get(thresh_slice + decoded_so_far)
                        coef |= cur_bit << i
                        decoded_so_far = (decoded_so_far << 1) | cur_bit
                        if decoded_so_far > (1 << C.RESIDUAL_NOISE_FLOOR) - 1:
                            decoded_so_far = (1 << C.RESIDUAL_NOISE_FLOOR) - 1
                        i -= 1
                res_slice = (res_base + coord * r71
                             + (num_nonzeros_edge + 1) * r72)
                while i >= 0:
                    coef |= get(res_slice + i) << i
                    i -= 1
            if neg:
                coef = -coef
            here_i[coord] = coef
            here[coord] = coef
        lane += 1
        coord += delta
