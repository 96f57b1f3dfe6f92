"""The symbol kernels' plain versions and the two-pass route of
kernels/batch_encode.py on the CPU (csrc/symbolize.cu runs only on a card:
tests/test_torch_cuda.py holds it to these).

- symbol_counts_plain against symbolize_slice's live slots, block by block;
- block_contexts, the phase A that the kernels compute from a block and
  its neighbours in shared memory, in Python, against the port's and the
  JAX package's contexts.phase_a, with segment-top rows, column 0 and
  values that wrap int32 and int16;
- walk_block, the kernels' walk in Python over those contexts, against
  the same slab, so that the CUDA source's arithmetic, which the two
  follow line by line, is checked here;
- the parameter block the wrappers pass: model/tables.py's offsets and
  strides, in the order of the source's Tab, the plane's tables, and the
  source's constants;
- _symbolize_plane (counts, offsets, one total, emission) against the
  mask compaction of the slab it replaces, against the JAX package's
  symbolize_slice, and, where the two packages differ on purpose (the
  tenth residual bit of an 11-bit coefficient, block 0 of a row past an
  early-EOF cut), against the host's C symbolizer; on the CPU it makes
  the slab once a chunk;
- chip_smoke.py's count of the bytes behind the kernels' bound and its
  trace, which lets a kernel's failure through.

The planes are seeded numpy planes shaped like a JPEG's; every comparison
is exact (idx, bit, counts, flags).
"""
import ctypes
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from lepton_tpu.kernels import contexts as jctx  # noqa: E402
from lepton_tpu.kernels import symbolize as jsym  # noqa: E402
from lepton_tpu.model.context import ColorTables as JColorTables  # noqa: E402
from lepton_tpu_torch import _native, api, constants as C, host  # noqa: E402
from lepton_tpu_torch.kernels import (batch_encode, contexts,  # noqa: E402
                                      cuda_build)
from lepton_tpu_torch.kernels import symbolize as S  # noqa: E402
from lepton_tpu_torch.kernels.vpx_coder import PAD  # noqa: E402
from lepton_tpu_torch.model.context import ColorTables  # noqa: E402
from lepton_tpu_torch.model.tables import (TABLE_OFFSETS,  # noqa: E402
                                           TABLE_STRIDES)


def _plane(seed, H, W):
    """Coefficients shaped like a JPEG's: large DC, AC decaying with
    frequency, mostly zero at high frequencies, all within 10 bits."""
    rng = np.random.default_rng(seed)
    freq = np.add.outer(np.arange(8), np.arange(8)).reshape(64)
    scale = 60.0 / (1 + freq) ** 1.3
    coefs = np.round(rng.laplace(0, scale, (H, W, 64))).astype(np.int64)
    coefs[rng.random((H, W, 64)) < 0.02 * freq] = 0
    coefs[..., 0] = rng.integers(-1000, 1000, (H, W))
    return np.clip(coefs, -1023, 1023).astype(np.int16)


def _tables(seed):
    return np.random.default_rng(seed).integers(1, 60, 64)


# name: (seed, H, W, ci, segment-top rows, blocks cut off the end,
#        {(row, col, raster position): value})
CASES = {
    "luma": (1, 6, 7, 0, [0], 0, {}),
    "chroma": (2, 5, 6, 1, [0], 0, {}),
    "segment_tops": (3, 7, 5, 0, [0, 2, 5], 0, {}),
    "past_cut": (4, 6, 6, 1, [0, 3], 13, {}),
    "eleven_bits": (5, 4, 6, 0, [0], 0,
                    {(1, 2, 9): 1500, (2, 3, 3): -2047, (3, 0, 0): 1023}),
    "past_eleven_bits": (6, 4, 5, 1, [0], 0,
                         {(2, 1, 20): 3000, (0, 4, 8): -2048}),
}


def _case(name):
    seed, H, W, ci, tops, cut, plant = CASES[name]
    coefs = _plane(seed, H, W)
    for (r, c, k), v in plant.items():
        coefs[r, c, k] = v
    rha = np.ones(H, bool)
    rha[tops] = False
    return coefs, ci, ColorTables(_tables(seed)), rha, H * W - cut


def _slab(coefs, ci, ct, rha, size_limit):
    """symbolize_slice's slab of the whole plane, as numpy [N, slots]."""
    args = [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)]
    idx, bit = S.symbolize_slice(torch.as_tensor(coefs), ci, *args, 0,
                                 size_limit, torch.as_tensor(rha))
    H, W = coefs.shape[:2]
    return idx.numpy().reshape(H * W, -1), bit.numpy().reshape(H * W, -1)


@pytest.mark.parametrize("name", list(CASES))
def test_counts_plain_are_the_slabs_live_slots(name):
    """Each block's count is its live slots in symbolize_slice's slab, and
    its flag is set exactly where the slab's first slot carries
    COEF_OUT_OF_RANGE (a coded value past 11 bits)."""
    coefs, ci, ct, rha, size_limit = _case(name)
    idx, _ = _slab(coefs, ci, ct, rha, size_limit)
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    counts, over = S.symbol_counts_plain(plane)
    assert counts.dtype == torch.int32 and over.dtype == torch.bool
    assert np.array_equal(counts.numpy().reshape(-1), (idx != PAD).sum(-1))
    flags = idx[:, 0] == S.COEF_OUT_OF_RANGE
    assert np.array_equal(over.numpy().reshape(-1), flags)
    assert flags.any() == (name == "past_eleven_bits")
    if name == "past_cut":
        H, W = coefs.shape[:2]
        dead = ~((np.arange(H * W) < size_limit) | (np.arange(H * W) % W
                                                    == 0))
        assert dead.any() and not counts.numpy().reshape(-1)[dead].any()


# ---------------------------------------------------------------------------
# csrc/symbolize.cu in Python, one block at a time: phase A from the block
# and its neighbours (block_contexts), then the walk (walk_block).  Line
# by line as the source computes, int32 arithmetic wrapping as there.
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1


def _i32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def _i16(v: int) -> int:
    v &= 0xFFFF
    return v - (1 << 16) if v >> 15 else v


def _sra(v: int, n: int) -> int:
    """int32 arithmetic shift of a wrapped value."""
    return _i32(v) >> n


def _wabs(v: int) -> int:
    """torch.abs of an int32: INT32_MIN stays itself."""
    return -v if -(1 << 31) < v < 0 else v


def _bitlen(v: int) -> int:
    return v.bit_length() if v > 0 else 0


def _bsr(v: int) -> int:
    return _bitlen(min(_wabs(v), 1023))


def _sign(v: int) -> int:
    return (v > 0) - (v < 0)


def _div2(v: int) -> int:
    return -((-v) >> 1) if v < 0 else v >> 1


def _idct_row(c, q, dc0: bool) -> list:
    v = [(a * b) & M32 for a, b in zip(c, q)]
    if dc0:
        v[0] = 0
    x0 = ((v[0] << 11) + 128) & M32
    x1 = (v[4] << 11) & M32
    x2, x3, x4, x5, x6, x7 = v[6], v[2], v[1], v[7], v[5], v[3]
    x8 = C.W7 * (x4 + x5)
    x4, x5 = x8 + C.W1MW7 * x4, x8 - C.W1PW7 * x5
    x8 = C.W3 * (x6 + x7)
    x6, x7 = x8 - C.W3MW5 * x6, x8 - C.W3PW5 * x7
    x8, x0 = x0 + x1, x0 - x1
    x1 = C.W6 * (x3 + x2)
    x2, x3 = x1 - C.W2PW6 * x2, x1 + C.W2MW6 * x3
    x1, x4 = x4 + x6, x4 - x6
    x6, x5 = x5 + x7, x5 - x7
    x7, x8 = x8 + x3, x8 - x3
    x3, x0 = x0 + x2, x0 - x2
    x2 = _sra(C.R2 * (x4 + x5) + 128, 8)
    x4 = _sra(C.R2 * (x4 - x5) + 128, 8)
    return [_sra(v, 8) for v in (x7 + x1, x3 + x2, x0 + x4, x8 + x6,
                                 x8 - x6, x0 - x4, x3 - x2, x7 - x1)]


def _idct_col(y0, y1, y2, y3, y4, y5, y6, y7) -> list:
    """One column of the first pass (its rows 0..7 as the source names
    them: y0 = row 0, y1 = row 4, y2 = row 6, y3 = row 2, y4 = row 1,
    y5 = row 7, y6 = row 5, y7 = row 3); int16 pixels of rows 0..7."""
    y0 = (y0 << 8) + 8192
    y1 = y1 << 8
    y8 = C.W7 * (y4 + y5) + 4
    y4, y5 = _sra(y8 + C.W1MW7 * y4, 3), _sra(y8 - C.W1PW7 * y5, 3)
    y8 = C.W3 * (y6 + y7) + 4
    y6, y7 = _sra(y8 - C.W3MW5 * y6, 3), _sra(y8 - C.W3PW5 * y7, 3)
    y8, y0 = y0 + y1, y0 - y1
    y1 = C.W6 * (y3 + y2) + 4
    y2, y3 = _sra(y1 - C.W2PW6 * y2, 3), _sra(y1 + C.W2MW6 * y3, 3)
    y1, y4 = y4 + y6, y4 - y6
    y6, y5 = y5 + y7, y5 - y7
    y7, y8 = y8 + y3, y8 - y3
    y3, y0 = y0 + y2, y0 - y2
    y2 = _sra(C.R2 * (y4 + y5) + 128, 8)
    y4 = _sra(C.R2 * (y4 - y5) + 128, 8)
    return [_i16(_sra(v, 11)) for v in (y7 + y1, y3 + y2, y0 + y4, y8 + y6,
                                        y8 - y6, y0 - y4, y3 - y2, y7 - y1)]


def _pixels(co, quant) -> list:
    """A block's IDCT with DC ignored: 64 int16 pixels, raster.  Python's
    integers do not wrap, so each step of the source's uint32 arithmetic
    is taken mod 2^32 where it is shifted (_sra) or stored."""
    rows = [_idct_row(co[8 * y:8 * y + 8], quant[8 * y:8 * y + 8], y == 0)
            for y in range(8)]
    px = [0] * 64
    for x in range(8):
        col = _idct_col(*(rows[k][x] for k in (0, 4, 6, 2, 1, 7, 5, 3)))
        for y in range(8):
            px[8 * y + x] = col[y]
    return px


def _nz7(co) -> int:
    return sum(co[k] != 0 for k in range(9, 64) if k & 7)


def _edge(dc, q0, cur, prev) -> int:
    return _i16(dc * q0 + cur + 1024 + _div2(cur - prev))


def block_contexts(nb: dict, quant, icos_x, icos_y, has_left: bool,
                   has_above: bool, top: bool) -> dict:
    """Phase A of one block as csrc/symbolize.cu computes it from the
    block and its neighbours: nb holds the coefficient lists (64, raster)
    of "here", "left", "above" and "above_left", zeros where the plane has
    no such block.  has_left: column > 0; has_above: the row's flag; top:
    row 0 (no row above in the plane).  Returns nz7x7, aavrg (64), lak
    (14), pixels (64), dc_pred, uncertainty and uncertainty2, with
    phase_a's names."""
    co, left, above, al = (nb[k] for k in ("here", "left", "above",
                                           "above_left"))
    aavrg = []
    for pos in range(64):
        l, a, b = abs(left[pos]), abs(above[pos]), abs(al[pos])
        aavrg.append(((13 * (l + a) + 6 * b) & 0xFFFF) >> 5
                     if has_left and has_above else
                     l if has_left else a if has_above else 0)
    lak = []
    for e in (0, 1):
        for l in range(7):
            if not (has_above if e == 0 else has_left):
                lak.append(0)
                continue
            band = l + 1
            nbr = above if e == 0 else left
            icos = (icos_x if e == 0 else icos_y)[8 * band:8 * band + 8]
            at0, step = (band, 8) if e == 0 else (8 * band, 1)
            s = 0
            for i in range(1, 8):
                k = at0 + i * step
                d = co[k] + nbr[k] if i & 1 else co[k] - nbr[k]
                s += icos[i] * d
            pred = _i32(nbr[at0] * icos[0] - s)
            # floor of the magnitude, which stays negative at INT32_MIN
            lak.append(_i32(_sign(pred) * (_wabs(pred) // icos[0])))
    px = _pixels(co, quant)
    q0 = quant[0]
    lo, hi, sum_l, sum_a = 1 << 30, -(1 << 30), 0, 0
    if has_left:
        lp = _pixels(left, quant)
        for y in range(8):
            p0, p1 = px[8 * y], px[8 * y + 1]
            est = _i16(_edge(left[0], q0, lp[8 * y + 7], lp[8 * y + 6])
                       - _div2(p0 - p1) - (p0 + 1024))
            lo, hi, sum_l = min(lo, est), max(hi, est), sum_l + est
    if has_above:
        ap = _pixels(above, quant)
        for x in range(8):
            p0, p1 = px[x], px[8 + x]
            e = 0 if top else _edge(above[0], q0, ap[56 + x], ap[48 + x])
            est = _i16(e - _div2(p0 - p1) - (p0 + 1024))
            lo, hi, sum_a = min(lo, est), max(hi, est), sum_a + est
    any_ = has_left or has_above
    avg_h = sum_l if has_left else sum_a
    avg_v = sum_a if has_left and has_above else avg_h
    overall = (avg_h + avg_v) >> 1
    dh, dv = avg_h - overall, avg_v - overall
    avgmed = overall if any_ else 0
    return dict(nz7x7=_nz7(co), aavrg=aavrg, lak=lak, pixels=px,
                dc_pred=(_sign(avgmed) * (abs(avgmed) // q0) + 4) >> 3,
                uncertainty=(hi - lo) >> 3 if any_ else 0,
                uncertainty2=(dh if abs(dh) < abs(dv) else dv) >> 3
                if any_ else 0)


def neighbours(coefs: np.ndarray, r: int, c: int) -> dict:
    """Block (r, c)'s coefficient lists and its neighbours', as the
    kernel's tile holds them: zeros where the plane has no block."""
    def at(rr, cc):
        if rr < 0 or cc < 0:
            return [0] * 64
        return [int(v) for v in coefs[rr, cc]]
    return dict(here=at(r, c), left=at(r, c - 1), above=at(r - 1, c),
                above_left=at(r - 1, c - 1))


def walk_block(plane: S.Plane, b: int):
    """The walk of csrc/symbolize.cu for block b (flat, row-major) of a
    CPU plane, over block_contexts.  Returns (idx list, bit list, over)."""
    prm = [int(v) for v in S.params(plane)]
    T = {name: prm[k] for k, name in enumerate(S.PARAM_NAMES)}
    at = len(S.PARAM_NAMES)
    nzbin, unzig, noise = (prm[at:at + 50], prm[at + 50:at + 99],
                           prm[at + 99:at + 163])
    coefs = plane.coefs.numpy()
    W = coefs.shape[1]
    r, c = divmod(b, W)
    idx, bits = [], []

    def put(i, bit):
        idx.append(int(i))
        bits.append(int(bit))

    if not (plane.row_block_offset + b < plane.size_limit or c == 0):
        return idx, bits, False
    nb = neighbours(coefs, r, c)
    has_left, has_above = c > 0, bool(plane.row_has_above[r])
    q, ix, iy = (np.asarray(a).tolist() for a in (plane.quant, plane.icos_x,
                                                   plane.icos_y))
    ctx = block_contexts(nb, q, ix, iy, has_left, has_above, r == 0)
    co = nb["here"]
    ci = plane.ci
    nz7 = ctx["nz7x7"]
    nl = _nz7(nb["left"]) if has_left else 0
    na = _nz7(nb["above"])
    if has_left and has_above:
        nctx = (na + nl + 2) // 4
    elif has_above:
        nctx = (na + 1) // 2
    elif has_left:
        nctx = (nl + 1) // 2
    else:
        nctx = 0
    base = T["NZ_7X7"] + ci * T["NZ_7X7_S0"] + nzbin[nctx] * T["NZ_7X7_S1"]
    for i in range(5, -1, -1):
        put(base + i * T["NZ_7X7_S2"] + (nz7 >> (i + 1)), (nz7 >> i) & 1)

    def put_exp(base, n):
        for i in range(min(n, C.MAX_EXPONENT - 1) + 1):
            put(base + i, n != i)

    def put_res(base, n, a):
        for i in range(n - 2, max(n - 1 - C.COEF_BITS, 0) - 1, -1):
            put(base + i, (a >> i) & 1)

    res_base = T["RESIDUAL_NOISE"] + ci * T["RESIDUAL_NOISE_S0"]
    sign_base = T["SIGN"] + ci * T["SIGN_S0"]
    exp_base = T["EXP_7X7"] + ci * T["EXP_7X7_S0"]
    over = False
    eob_x = eob_y = 0
    nz_left = nz7
    k = 0
    while k < 49 and nz_left > 0:
        pos = unzig[k]
        v = co[pos]
        a = _wabs(v)
        n = _bitlen(a)
        bsr = _bsr(ctx["aavrg"][pos])
        nnzb = nzbin[min(nz_left, 49)]
        put_exp(exp_base + nnzb * T["EXP_7X7_S1"] + k * T["EXP_7X7_S2"]
                + bsr * T["EXP_7X7_S3"], n)
        if n > 0:
            put(sign_base, v >= 0)
        put_res(res_base + pos * T["RESIDUAL_NOISE_S1"]
                + nnzb * T["RESIDUAL_NOISE_S2"], n, a)
        over |= n > C.MAX_EXPONENT
        if v != 0:
            nz_left -= 1
            eob_x = max(eob_x, pos & 7)
            eob_y = max(eob_y, pos >> 3)
        k += 1

    expx_base = T["EXP_X"] + ci * T["EXP_X_S0"]
    rt_base = T["RESIDUAL_THRESH"] + ci * T["RESIDUAL_THRESH_S0"]
    cap = (1 << C.RESIDUAL_NOISE_FLOOR) - 1
    for horizontal in (True, False):
        step, zig15, t, est_eob = ((1, 0, "NZ_8X1", eob_x) if horizontal
                                   else (8, 7, "NZ_1X8", eob_y))
        cnt = sum(co[l * step] != 0 for l in range(1, 8))
        nz_slice = (T[t] + ci * T[t + "_S0"] + est_eob * T[t + "_S1"]
                    + ((nz7 + 3) // 7) * T[t + "_S2"])
        for i in range(2, -1, -1):
            put(nz_slice + i * T[t + "_S3"] + (cnt >> (i + 1)),
                (cnt >> i) & 1)
        remaining = cnt
        l = 0
        while l < 7 and remaining > 0:
            coord = (l + 1) * step
            v = co[coord]
            a = _wabs(v)
            n = _bitlen(a)
            bp = ctx["lak"][zig15 + l]
            bsr = _bsr(bp)
            put_exp(expx_base + remaining * T["EXP_X_S1"]
                    + (zig15 + l) * T["EXP_X_S2"] + bsr * T["EXP_X_S3"], n)
            if v != 0:
                ctx1 = 0 if bp == 0 else 1 if bp > 0 else 2
                put(sign_base + ctx1 * T["SIGN_S1"] + bsr, v >= 0)
            over |= n > C.MAX_EXPONENT
            mt = noise[coord]
            t1 = min(_wabs(bp) >> mt, 255)
            t2 = min(n - mt, C.RESIDUAL_NOISE_FLOOR)
            thresh = (rt_base + t1 * T["RESIDUAL_THRESH_S1"]
                      + t2 * T["RESIDUAL_THRESH_S2"])
            res = (res_base + coord * T["RESIDUAL_NOISE_S1"]
                   + remaining * T["RESIDUAL_NOISE_S2"])
            so_far = 1
            for i in range(n - 2, max(n - 1 - C.COEF_BITS, 0) - 1, -1):
                bit = (a >> i) & 1
                if i >= mt:
                    put(thresh + so_far, bit)
                    so_far = min((so_far << 1) | bit, cap)
                else:
                    put(res + i, bit)
            if v != 0:
                remaining -= 1
            l += 1

    maxv = 1 << (C.MAX_EXPONENT - 1)
    delta = _i32(co[0] - ctx["dc_pred"])
    if delta < -maxv:
        delta += 2 * maxv + 1
    if delta > maxv:
        delta -= 2 * maxv + 1
    a = _wabs(delta)
    n = _bitlen(a)
    u, u2 = ctx["uncertainty"], ctx["uncertainty2"]
    lm = min(_bitlen(_wabs(u)), C.NUMERIC_LENGTH_MAX - 1)
    lo = min(_bitlen(_wabs(u2)), 16)
    put_exp(T["EXP_DC"] + lm * T["EXP_DC_S0"] + lo * T["EXP_DC_S1"], n)
    if n > 0:
        put(sign_base + (1 if u2 < 0 else 3 if u2 == 0 else 2), delta >= 0)
    put_res(T["RESIDUAL_NOISE_DC"] + lm * T["RESIDUAL_NOISE_DC_S0"], n, a)
    over |= n > C.MAX_EXPONENT
    if over:
        idx[0] = S.COEF_OUT_OF_RANGE
    return idx, bits, over


def _wrap_plane(seed, H, W, big):
    """A plane of values that wrap phase A's int32 and int16 arithmetic:
    coefficients at +-big scattered over a JPEG-like plane."""
    rng = np.random.default_rng(seed)
    coefs = _plane(seed, H, W).astype(np.int64)
    hit = rng.random((H, W, 64)) < 0.2
    coefs[hit] = rng.choice([-big, big, -big + 1, big - 1], int(hit.sum()))
    return coefs.astype(np.int16)


# name: (plane, segment-top rows, quantizer max); the quantizers are
# seeded from the plane's seed
CONTEXT_CASES = {
    "segment_tops": (lambda: _plane(21, 7, 6), [0, 3, 4], 255),
    "row0_has_above": (lambda: _plane(22, 5, 6), [3], 60),
    "wrap_2047_q65535": (lambda: _wrap_plane(23, 5, 7, 2047), [0, 2],
                         65535),
    "wrap_32767_q255": (lambda: _wrap_plane(24, 5, 6, 32767), [0], 255),
    "wrap_32767_q65535": (lambda: _wrap_plane(25, 6, 5, 32767), [0, 5],
                          65535),
}


def _context_case(name):
    make, tops, qmax = CONTEXT_CASES[name]
    coefs = make()
    seed = sum(map(ord, name))
    q = np.random.default_rng(seed).integers(1, qmax + 1, 64)
    rha = np.ones(coefs.shape[0], bool)
    rha[tops] = False
    return coefs, q, rha


@pytest.mark.parametrize("name", list(CONTEXT_CASES))
def test_block_contexts_match_phase_a(name):
    """block_contexts, block by block from the block and its neighbours,
    gives what contexts.phase_a of the port and of the JAX package give
    for the whole plane: nz7x7, aavrg, lak, pixels, the DC prediction and
    both uncertainties; with segment-top rows, column 0, a row 0 whose
    flag says it has a row above (none in the plane), coefficients at
    +-2047 and +-32767 and quantizers up to 65535."""
    coefs, q, rha = _context_case(name)
    ct, jct = ColorTables(q), JColorTables(q)
    args = [np.asarray(a, np.int32) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y)]
    port = contexts.phase_a(torch.as_tensor(coefs),
                            *map(torch.as_tensor, args),
                            torch.as_tensor(rha))
    ref = jctx.phase_a(jnp.asarray(coefs), *(jnp.asarray(np.asarray(
        a, np.int32)) for a in (jct.quant,
                                jct.icos_idct_edge_8192_dequantized_x,
                                jct.icos_idct_edge_8192_dequantized_y)),
        jnp.asarray(rha))
    H, W = coefs.shape[:2]
    wrapped = 0
    for r in range(H):
        for c in range(W):
            got = block_contexts(neighbours(coefs, r, c),
                                 *(a.tolist() for a in args), c > 0,
                                 bool(rha[r]), r == 0)
            for k, v in got.items():
                want = port[k][r, c].numpy().astype(np.int64)
                assert np.array_equal(np.asarray(v, np.int64), want), \
                    (k, r, c)
                assert np.array_equal(want, np.asarray(ref[k][r, c],
                                                       np.int64)), (k, r, c)
            dq = np.asarray(neighbours(coefs, r, c)["here"]) * args[0]
            wrapped += bool((np.abs(dq) >= 1 << 20).any())
    # the dequantized coefficients shifted by 11 leave int32
    assert wrapped > 0 or name in ("segment_tops", "row0_has_above")


def test_walk_block_matches_the_slab():
    """The kernels' phase A and walk, block by block in Python, emit each
    block's live slots of the slab in order, and flag what the slab
    flags: every case above, two larger seeded planes and a plane whose
    contexts wrap int32 (a few hundred blocks in all)."""
    planes = [_case(name) for name in CASES]
    for seed, ci in ((7, 0), (8, 1)):
        coefs = _plane(seed, 9, 11)
        rng = np.random.default_rng(seed)
        for _ in range(4):      # 11- and 12-bit coefficients anywhere
            r, c, k = rng.integers(0, (9, 11, 64))
            coefs[r, c, k] = rng.choice([1500, -1800, 2500, -4000])
        rha = np.ones(9, bool)
        rha[[0, 4]] = False
        planes.append((coefs, ci, ColorTables(_tables(seed)), rha,
                       9 * 11 - 20))
    coefs, q, rha = _context_case("wrap_2047_q65535")
    planes.append((coefs, 1, ColorTables(q), rha, coefs[..., 0].size))
    blocks = 0
    for coefs, ci, ct, rha, size_limit in planes:
        idx, bit = _slab(coefs, ci, ct, rha, size_limit)
        plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha,
                               size_limit)
        for b in range(len(idx)):
            got_i, got_b, over = walk_block(plane, b)
            live = idx[b] != PAD
            assert got_i == idx[b][live].tolist(), b
            assert got_b == bit[b][live].tolist(), b
            assert over == (idx[b, 0] == S.COEF_OUT_OF_RANGE), b
        blocks += len(idx)
    assert blocks > 300


def test_parameter_block_is_the_tables():
    """The parameter block the wrappers pass: each table's offset and its
    strides but the last, as model/tables.py has them, in the order of
    csrc/symbolize.cu's Tab, then the nonzero bins, the zigzag order and
    the plane's noise thresholds, quantizers and Lakhani cosines; and the
    source's constants are the package's."""
    want = []
    for t in S.PARAM_TABLES:
        assert TABLE_STRIDES[t][-1] == 1
        want += [TABLE_OFFSETS[t]] + list(TABLE_STRIDES[t][:-1])
    ct = ColorTables(_tables(3))
    plane = S.plane_inputs(torch.as_tensor(_plane(3, 2, 3)), 0, ct,
                           np.array([False, True]), 6)
    prm = S.params(plane)
    assert prm.dtype == np.int32
    assert prm.tolist() == want + list(C.NONZERO_TO_BIN) + list(
        C.UNZIGZAG49) + list(ct.min_noise_threshold) + list(ct.quant) + list(
        ct.icos_idct_edge_8192_dequantized_x) + list(
        ct.icos_idct_edge_8192_dequantized_y)
    assert set(S.PARAM_TABLES) == set(TABLE_OFFSETS)
    src = open(cuda_build.source("symbolize")).read()
    enum = re.search(r"enum Tab \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == list(S.PARAM_NAMES) + ["kTabs"]
    for name, value in (("kMaxExponent", C.MAX_EXPONENT),
                        ("kCoefBits", C.COEF_BITS),
                        ("kNoiseFloor", C.RESIDUAL_NOISE_FLOOR),
                        ("kNumericLengthMax", C.NUMERIC_LENGTH_MAX),
                        ("kOutOfRange", S.COEF_OUT_OF_RANGE),
                        ("kTile", S.TILE_BLOCKS),
                        ("kStage", S.STAGE_SYMBOLS)):
        m = re.search(rf"constexpr int {name} = (-?\d+);", src)
        assert m and int(m.group(1)) == value, name
    for name in ("W1", "W2", "W3", "W5", "W6", "W7", "R2"):
        m = re.search(rf"constexpr uint32_t k{name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(C, name), name
    assert f"kUnzig = kNzBin + {len(C.NONZERO_TO_BIN)};" in src
    assert f"kNoise = kUnzig + {len(C.UNZIGZAG49)};" in src
    assert S.PLANE_TABLES == ("min_noise_threshold", "quant", "icos_x",
                              "icos_y")
    for a, b in (("kQuant", "kNoise"), ("kIcosX", "kQuant"),
                 ("kIcosY", "kIcosX"), ("kParams", "kIcosY")):
        assert f"{a} = {b} + 64;" in src
    # the launch functions get exactly this block
    args = S._plane_args(plane)
    n = args[-1]
    got = (ctypes.c_int32 * n).from_address(args[-2].value)
    assert list(got) == prm.tolist()


def _mask_route(coefs, ci, ct, rha, size_limit, rows=2):
    """The route the kernels replace: the slab in chunks of `rows` rows
    (with the row above as context), its live slots kept by a boolean
    mask, the rows counted, -1 for a row with a flagged block."""
    t = torch.as_tensor(coefs)
    H, W = coefs.shape[:2]
    args = [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)]
    r_ha = torch.as_tensor(rha)
    parts_i, parts_b, counts = [], [], []
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        lo = max(r0 - 1, 0)
        idx, bit = S.symbolize_slice(t[lo:r1], ci, *args, lo * W,
                                     size_limit, r_ha[lo:r1])
        idx, bit = idx[r0 - lo:], bit[r0 - lo:]
        live = idx != PAD
        over = (idx[..., 0] == S.COEF_OUT_OF_RANGE).any(dim=1)
        counts.append(torch.where(over, -1, live.sum(dim=(1, 2))))
        parts_i.append(idx[live])
        parts_b.append(bit[live])
    return torch.cat(parts_i), torch.cat(parts_b), torch.cat(counts)


@pytest.mark.parametrize("slab_blocks", [S.SLAB_BLOCKS, 7],
                         ids=["whole", "chunked"])
@pytest.mark.parametrize("name", list(CASES))
def test_route_equals_the_mask_route(name, slab_blocks, monkeypatch):
    """_symbolize_plane on the CPU (phase A once, symbol_counts_plain,
    offsets, the total, emit_symbols_plain) gives the idx, bit and row
    counts of the mask route, with the plain slab taken whole or in
    chunks of one row."""
    monkeypatch.setattr(S, "SLAB_BLOCKS", slab_blocks)
    coefs, ci, ct, rha, size_limit = _case(name)
    got = batch_encode._symbolize_plane(torch.as_tensor(coefs), ci, ct, rha,
                                        size_limit)
    want = _mask_route(coefs, ci, ct, rha, size_limit)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.uint8
    assert got[2].dtype == torch.int64
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[2] < 0).any() == (name == "past_eleven_bits")


def test_emit_plain_places_runs_at_their_offsets():
    """emit_symbols_plain puts block (r, c)'s run at offsets[r, c], for
    offsets that are not the packed ones (a gap after every block), and
    refuses offsets of the wrong type or shape."""
    coefs, ci, ct, rha, size_limit = _case("segment_tops")
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    counts, _ = S.symbol_counts(plane)
    n = counts.reshape(-1).to(torch.int64)
    offsets = (torch.cumsum(n + 3, 0) - n - 3).reshape(counts.shape)
    idx, bit = S.emit_symbols(plane, offsets, int((n + 3).sum()))
    slab_i, slab_b = _slab(coefs, ci, ct, rha, size_limit)
    for b, (o, k) in enumerate(zip(offsets.reshape(-1).tolist(),
                                   n.tolist())):
        live = slab_i[b] != PAD
        assert idx[o:o + k].tolist() == slab_i[b][live].tolist()
        assert bit[o:o + k].tolist() == slab_b[b][live].tolist()
    with pytest.raises(ValueError, match="offsets"):
        S.emit_symbols(plane, offsets.to(torch.int32), 10)
    with pytest.raises(ValueError, match="offsets"):
        S.emit_symbols(plane, offsets.reshape(-1), 10)


def test_wrappers_check_their_inputs_and_count_no_cpu_launch():
    """A CPU plane runs the plain versions and counts no launch; a plane
    of the wrong dtype, shape, layout, tables or model is refused, and so
    are outputs of the wrong type or length."""
    coefs, ci, ct, rha, size_limit = _case("luma")
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    before = (S.symbol_counts.launches, S.emit_symbols.launches)
    batch_encode._symbolize_plane(torch.as_tensor(coefs), ci, ct, rha,
                                  size_limit)
    assert (S.symbol_counts.launches, S.emit_symbols.launches) == before
    for bad in (plane._replace(coefs=plane.coefs.to(torch.int32)),
                plane._replace(coefs=plane.coefs[..., :32].contiguous()),
                plane._replace(coefs=plane.coefs.transpose(0, 1)),
                plane._replace(row_has_above=plane.row_has_above[1:]),
                plane._replace(row_has_above=plane.row_has_above.to(
                    torch.uint8)),
                plane._replace(ci=2),
                plane._replace(quant=np.ones(63, np.int32)),
                plane._replace(icos_y=np.ones((8, 8), np.int32)),
                plane._replace(min_noise_threshold=np.zeros(63, np.int32))):
        with pytest.raises(ValueError):
            S.symbol_counts(bad)
    counts, _ = S.symbol_counts(plane)
    n = counts.reshape(-1).to(torch.int64)
    offsets = (torch.cumsum(n, 0) - n).reshape(counts.shape)
    total = int(n.sum())
    for out in ((torch.empty(total, dtype=torch.int64),
                 torch.empty(total, dtype=torch.uint8)),
                (torch.empty(total - 1, dtype=torch.int32),
                 torch.empty(total - 1, dtype=torch.uint8))):
        with pytest.raises(ValueError, match="out"):
            S.emit_symbols(plane, offsets, total, out)
    out = (torch.empty(total, dtype=torch.int32),
           torch.empty(total, dtype=torch.uint8))
    got = S.emit_symbols(plane, offsets, total, out)
    assert all(g is o for g, o in zip(got, out))
    assert torch.equal(out[0], S.emit_symbols(plane, offsets, total)[0])


def _jax_slab(coefs, ci, q, rha, size_limit):
    jct = JColorTables(q)
    jargs = [jnp.asarray(np.asarray(a, np.int32)) for a in (
        jct.quant, jct.icos_idct_edge_8192_dequantized_x,
        jct.icos_idct_edge_8192_dequantized_y, jct.min_noise_threshold)]
    ji, jb = jsym.symbolize_slice(
        jnp.asarray(coefs), ci, *jargs, jnp.int32(0), jnp.int32(size_limit),
        jnp.asarray(rha))
    H, W = coefs.shape[:2]
    return (np.asarray(ji).reshape(H * W, -1),
            np.asarray(jb).reshape(H * W, -1))


@pytest.mark.parametrize("name", ["luma", "chroma", "segment_tops",
                                  "past_cut"])
def test_route_matches_jax(name):
    """The route's symbols of every block the JAX slab codes are that
    slab's live slots in order; the blocks it leaves out are block 0 of
    the rows past an early-EOF cut, which the port codes as the host does
    (test_route_matches_the_host_symbolizer)."""
    seed = CASES[name][0]
    coefs, ci, ct, rha, size_limit = _case(name)
    idx, bit, rows = batch_encode._symbolize_plane(
        torch.as_tensor(coefs), ci, ct, rha, size_limit)
    ji, jb = _jax_slab(coefs, ci, _tables(seed), rha, size_limit)
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    counts = S.symbol_counts_plain(plane)[0].numpy().reshape(-1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    jlive = ji != PAD
    H, W = coefs.shape[:2]
    extra = 0
    for b in range(H * W):
        got_i = idx[starts[b]:starts[b + 1]].numpy()
        got_b = bit[starts[b]:starts[b + 1]].numpy()
        if not jlive[b].any() and len(got_i):
            assert b % W == 0 and b >= size_limit
            extra += 1
            continue
        assert np.array_equal(got_i, ji[b][jlive[b]]), b
        assert np.array_equal(got_b, jb[b][jlive[b]]), b
    assert extra == (H - -(-size_limit // W) if name == "past_cut" else 0)
    assert rows.sum() == len(idx)


def _desc(data: bytes, k: int):
    """The encode description of a JPEG in k segments and its host jobs."""
    parsed, info, dec = api._parse(data, allow_four_colors=True)
    splits, _ = api._plan(dec, k)
    desc = api._describe(info, dec, splits)
    bounds = [th.luma_y_start for th in splits] + [info.cmpnfo[0].bcv]
    jobs = [(bounds[i], bounds[i + 1], i == len(splits) - 1)
            for i in range(len(splits))]
    return info, dec, desc, jobs


FILES = {
    "segments": (lambda: chip_smoke.make_photo(81, 96, 64), 4, None),
    "eleven_bits": (lambda: chip_smoke.make_photo(82, 48, 32), 1,
                    {(0, 1, 2, 9): 1500, (0, 0, 1, 3): -2047}),
    "past_cut": (lambda: (lambda d: d[:len(d) * 3 // 5])(
        chip_smoke.make_photo(83, 64, 48)), 1, None),
    "cmyk": (lambda: chip_smoke.make_photo(84, 48, 32, mode="CMYK"), 2,
             None),
}


@pytest.mark.skipif(not _native.available(), reason="needs the C library")
@pytest.mark.parametrize("name", list(FILES))
def test_route_matches_the_host_symbolizer(name):
    """Each segment's symbols from symbolize_images on the CPU (unframed
    lanes) are the host C symbolizer's for that segment: in several
    segments, with 11-bit AC coefficients (all 10 residual bits, the first
    pinned difference from the JAX slab), past an early-EOF cut (block 0
    of each row past it, the second) and for a 4-component JPEG (its
    fourth plane on the chroma model)."""
    make, k, plant = FILES[name]
    info, dec, desc, jobs = _desc(make(), k)
    if plant:
        desc["planes"] = [p.copy() for p in desc["planes"]]
        for (c, r, x, pos), v in plant.items():
            desc["planes"][c][r, x, pos] = v
    if name == "past_cut":
        assert dec.early_eof
    assert len(desc["planes"]) == (4 if name == "cmyk" else 3)
    img = host._native_image(info, desc["planes"], desc["max_coded_heights"],
                             desc["component_sizes"])
    idx, bit, owners = batch_encode.lanes(
        batch_encode.symbolize_images([desc], "cpu"), framed=False)
    assert [s for _, s in owners] == list(range(len(jobs)))
    for s, job in enumerate(jobs):
        want_i, want_b = _native.native_symbolize_segment(img, *job)
        n = len(want_i)
        assert np.array_equal(idx[s, :n].numpy(), want_i), s
        assert np.array_equal(bit[s, :n].numpy(), want_b), s
        assert (idx[s, n:] == PAD).all()


def test_past_eleven_bits_refuses_the_request():
    """A coded value past 11 bits: the route's row counts -1 and
    symbolize_images raises LeptonError naming the request."""
    _, _, desc, _ = _desc(chip_smoke.make_photo(85, 32, 16), 1)
    desc["planes"] = [p.copy() for p in desc["planes"]]
    desc["planes"][1][0, 1, 20] = 3000
    with pytest.raises(host.LeptonError, match="request 1: coefficient out "
                       "of range"):
        batch_encode.symbolize_images([_desc(chip_smoke.make_photo(
            86, 32, 16), 1)[2], desc], "cpu")


@pytest.mark.parametrize("slab_blocks", [S.SLAB_BLOCKS, 7],
                         ids=["whole", "chunked"])
def test_cpu_route_makes_the_slab_once(slab_blocks, monkeypatch):
    """On a CPU plane the route's count and emission share one pass of the
    slab: one _slab call a chunk, as the mask route made."""
    monkeypatch.setattr(S, "SLAB_BLOCKS", slab_blocks)
    calls = []
    real = S._slab

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(S, "_slab", counted)
    coefs, ci, ct, rha, size_limit = _case("segment_tops")
    batch_encode._symbolize_plane(torch.as_tensor(coefs), ci, ct, rha,
                                  size_limit)
    H, W = coefs.shape[:2]
    assert len(calls) == (1 if slab_blocks >= H * W else H)


@pytest.mark.parametrize("name", list(CASES))
def test_bound_counts_the_walks_reads(name):
    """chip_smoke.symbol_bytes, the bytes behind the symbol kernels'
    bound: symbol_counts reads each block's 128 B of coefficients and
    writes its count and flag (133 B a block); symbol_emit reads the
    coefficients and each block's offset and writes 5 B a symbol.  On the
    main batch (1,143,072 blocks, 74,883,248 symbols) that is 152.0 and
    529.9 MB, 0.0454 and 0.158 ms at 3.35 TB/s."""
    coefs, ci, ct, rha, size_limit = _case(name)
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    blocks = coefs.shape[0] * coefs.shape[1]
    symbols = int(S.symbol_counts_plain(plane)[0].sum())
    assert chip_smoke.symbol_bytes(blocks, symbols) == (
        blocks * 133, blocks * 136 + symbols * 5)
    main = chip_smoke.symbol_bytes(1143072, 74883248)
    assert [round(b / 1e6, 1) for b in main] == [152.0, 529.9]
    assert [round(chip_smoke.bound_ms(b, 0)[0], 4) for b in main] == [
        0.0454, 0.1582]


@pytest.mark.parametrize("kind", ["launch", "bounds"])
def test_trace_lets_a_kernel_failure_through(kind):
    """chip_smoke.trace_device reports "not measured" only for the
    profiler's own failures: a failure of the call it traces (a failed
    launch, a checked build's KernelBoundsError) ends the phase."""
    error = (RuntimeError("symbol_emit_launch failed") if kind == "launch"
             else cuda_build.KernelBoundsError("symbolize", 129, 0, 5, 78,
                                               78, per_lane=False))

    def call():
        raise error

    with pytest.raises(type(error)) as got:
        chip_smoke.trace_device(call)
    assert got.value is error
