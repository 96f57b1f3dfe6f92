"""Symbolization: coefficients to (branch, bit) streams, all blocks at once.

Port of lepton_tpu/kernels/symbolize.py::symbolize_slice (:103-309).  On
encode every symbol the token codec emits is a pure function of the (fully
known) coefficient planes: neighbor summaries, averages, Lakhani and DC
predictions all derive from coefficients, and the serial bookkeeping of
serialize_tokens (nz_left countdown, exponent unary, threshold so_far) is
prefix-computable.  So serialize_tokens (reference
src/vp8/encoder/encoder.cc:195-402, encode_one_edge :41-164) runs over all
blocks of a slice at once, the zigzag position axis too.

Layout: each block emits a fixed BLOCK_SLOTS-wide padded row of
(branch_index, bit); invalid slots carry idx == PAD.  Flattening
[rows, width, BLOCK_SLOTS] row-major and dropping the PAD slots gives the
exact serial emission order.

Slot budget per block.  Every coded value takes up to MAX_EXPONENT (11)
bits, as in the host codec (leptonc.c encode_block): legal baseline AC
coefficients take at most 10, but a JPEG whose Huffman data holds an
11-bit AC coefficient encodes on the host, so it does here too, with all
10 of its residual bits (the JAX package's slab keeps 9 and drops the
last).  A value past 11 bits has no code: the reference aborts encode
with COEFFICIENT_OUT_OF_RANGE (encoder.cc:124-126), and such a block's
first slot carries COEF_OUT_OF_RANGE for the caller to refuse the image.

  nz 7x7 tree         6
  49 interior coefs   49 x (11 exp + 1 sign + 10 residual) = 1078
  2 edges             2 x (3 tree + 7 x 22)                = 314
  DC                  11 exp + 1 sign + 10 residual        = 22
  total               1420

On the card no slab is made (photos fill about 5% of it) and phase A's
contexts are not materialized: two kernels of csrc/symbolize.cu take a
plane's coefficients (plane_inputs), compute each block's contexts in
shared memory from the block and its neighbours, and walk each block in
the same emission order, writing only the live symbols.  symbol_counts
gives each block's count and an over-range flag; the caller sums the
counts into offsets, and emit_symbols writes each block's symbols at its
offset (batch_encode.symbolize_images).  Each wrapper launches its kernel
for CUDA tensors and runs its plain version (symbol_counts_plain,
emit_symbols_plain: phase A over the plane, then the slab above, in chunks
of SLAB_BLOCKS blocks, and its live slots) for CPU tensors; on a CPU plane
the route makes the slab once for both (symbol_runs_plain).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..model.tables import TABLE_OFFSETS, TABLE_STRIDES
from . import cuda_build
from .contexts import bit_length, phase_a
from .vpx_coder import PAD

COEF_SLOTS = 22            # 11 exp + 1 sign + 10 residual
DC_SLOTS = 22              # 11 exp + 1 sign + 10 residual
COEF_OUT_OF_RANGE = -3     # first slot of a block with a value past 11 bits
EDGE_SLOTS = 3 + 7 * COEF_SLOTS
BLOCK_SLOTS = 6 + 49 * COEF_SLOTS + 2 * EDGE_SLOTS + DC_SLOTS

_OFF = {k: int(v) for k, v in TABLE_OFFSETS.items()}
_STR = {k: tuple(int(s) for s in v) for k, v in TABLE_STRIDES.items()}
_MAXE = C.MAX_EXPONENT
_I32 = torch.int32
_U8 = torch.uint8


def _bsr_prior(prior: torch.Tensor) -> torch.Tensor:
    """Bucketing of a prediction magnitude (blocks._bsr_best_prior):
    bit_length of |prior| clamped to 1023."""
    return bit_length(torch.clamp(torch.abs(prior), max=1023))


def _exp_block(active, length, exp_slice):
    """Unary exponent slots: bit (length != i) at exp_slice + i for
    i = 0..min(length, MAX_EXPONENT-1) (encoder.cc put-with-terminator).
    active/length/exp_slice: [...]; returns idx/bit [..., MAX_EXPONENT]."""
    i = torch.arange(_MAXE, dtype=_I32, device=length.device)
    valid = active[..., None] & (i <= length[..., None])
    idx = torch.where(valid, exp_slice[..., None] + i, PAD)
    bit = (length[..., None] != i).to(_U8)
    return idx, bit


def _res_block(active, length, abs_coef, res_slice):
    """Plain residual bits: slot j < COEF_BITS holds bit i = length-2-j at
    res_slice + i (encoder.cc:276-283 noise-floor bits)."""
    j = torch.arange(C.COEF_BITS, dtype=_I32, device=length.device)
    i = length[..., None] - 2 - j
    valid = active[..., None] & (i >= 0)
    safe_i = torch.clamp(i, min=0)
    idx = torch.where(valid, res_slice[..., None] + safe_i, PAD)
    bit = ((abs_coef[..., None] >> safe_i) & 1).to(_U8)
    return idx, bit


def _tree_bits(value, nbits, base, stride):
    """MSB-first binary-tree coding: bit (value>>i)&1 at
    base + i*stride + (value >> (i+1)) for i = nbits-1..0
    (encoder.cc:205-213 so_far accumulation)."""
    idxs, bits = [], []
    for i in range(nbits - 1, -1, -1):
        idxs.append(base + i * stride + (value >> (i + 1)))
        bits.append(((value >> i) & 1).to(_U8))
    return torch.stack(idxs, dim=-1), torch.stack(bits, dim=-1)


def symbolize_slice(coefs: torch.Tensor, ci: int, quant: torch.Tensor,
                    icos_x: torch.Tensor, icos_y: torch.Tensor,
                    min_noise_threshold: torch.Tensor,
                    row_block_offset: int, size_limit: int,
                    row_has_above: torch.Tensor = None):
    """Symbolize one component plane (or a slice of its rows).

    coefs: int16 [R, W, 64] raster coefficients.
    ci: color index (0 luma / 1 chroma).
    quant/icos_x/icos_y/min_noise_threshold: ColorTables arrays, int32 [64]
    on the device of coefs.
    row_has_above: bool [R]; False rows get no above-context (segment-top
    rows -- the is_top_row reset of lepton_codec.hh:173-181).  Default:
    every row but row 0.
    row_block_offset/size_limit: blocks with row_block_offset + flat_index
    >= size_limit emit nothing (early-EOF truncation bookkeeping), but the
    first block of each row always emits; a slice of rows passes its first
    block's plane index as row_block_offset.

    Returns (idx int32 [R, W, BLOCK_SLOTS], bit uint8 same): flattened
    row-major this is the exact serial emission order.
    """
    pa = phase_a(coefs, quant, icos_x, icos_y, row_has_above)
    return _slab(coefs, pa, ci, min_noise_threshold, row_block_offset,
                 size_limit, row_has_above)


def _slab(coefs: torch.Tensor, pa: dict, ci: int,
          min_noise_threshold: torch.Tensor, row_block_offset: int,
          size_limit: int, row_has_above: torch.Tensor = None):
    """symbolize_slice from phase A's contexts `pa` (phase_a's dict) of
    the same rows."""
    R, W = coefs.shape[0], coefs.shape[1]
    dev = coefs.device
    coefs32 = coefs.to(_I32)                             # [R, W, 64]
    nz_bin_lut = torch.as_tensor(C.NONZERO_TO_BIN, dtype=torch.int64,
                                 device=dev)
    unzig = torch.as_tensor(C.UNZIGZAG49, dtype=torch.int64, device=dev)
    unzig32 = unzig.to(_I32)
    has_left = (torch.arange(W, device=dev) > 0)[None, :]
    if row_has_above is None:
        has_above = (torch.arange(R, device=dev) > 0)[:, None]
    else:
        has_above = row_has_above.to(device=dev, dtype=torch.bool)[:, None]

    flat = torch.arange(R * W, dtype=torch.int64, device=dev).reshape(R, W)
    # a row codes blocks until one reaches size_limit, and always its
    # first: the host codec tests the limit after each block (leptonc.c
    # process_row, codec/driver._process_row), so a row that an early-EOF
    # cut leaves past the limit still codes block 0 (the JAX package's
    # slab does not, and its .lep differs from its host codec's there)
    block_live = ((row_block_offset + flat) < size_limit) | (
        torch.arange(W, device=dev) == 0)[None, :]

    nz7 = pa["nz7x7"].to(_I32)                           # [R, W]
    aavrg = pa["aavrg"]                                  # [R, W, 64]
    lak = pa["lak"]                                      # [R, W, 14]

    pieces_idx = []
    pieces_bit = []

    def emit(idx, bit):
        """idx/bit: [R, W, k] appended in serial order."""
        pieces_idx.append(torch.where(block_live[..., None], idx, PAD))
        pieces_bit.append(bit)

    # ---- 7x7 nonzero count, 6-bit binary tree (encoder.cc:200-213)
    nz_left_blk = torch.zeros_like(nz7)
    nz_left_blk[:, 1:] = nz7[:, :-1]
    nz_above_blk = torch.zeros_like(nz7)
    nz_above_blk[1:] = nz7[:-1]
    nz_ctx = torch.where(
        has_left & has_above, (nz_above_blk + nz_left_blk + 2) // 4,
        torch.where(has_above, (nz_above_blk + 1) // 2,
                    torch.where(has_left, (nz_left_blk + 1) // 2, 0)))
    s70, s71, s72, _ = _STR["nz_7x7"]
    nz_base = (_OFF["nz_7x7"] + ci * s70
               + nz_bin_lut[nz_ctx.long()].to(_I32) * s71)
    emit(*_tree_bits(nz7, 6, nz_base, s72))

    # ---- 49 interior coefficients, zigzag axis vectorized
    # (encoder.cc:216-285): nz_left via exclusive prefix count, the
    # "while nz_left" break is the active mask.
    e70, e71, e72, e73, _ = _STR["exp_7x7"]
    r70, r71, r72, _ = _STR["residual_noise"]
    res_base = _OFF["residual_noise"] + ci * r70
    sg0, sg1, _ = _STR["sign"]
    sign_base = _OFF["sign"] + ci * sg0

    czz = coefs32[..., unzig]                            # [R, W, 49]
    azz = torch.abs(czz)
    nonzero = (czz != 0).to(_I32)
    prefix = (torch.cumsum(nonzero, dim=-1) - nonzero).to(_I32)  # exclusive
    nz_left = nz7[..., None] - prefix                    # [R, W, 49]
    active = nz_left > 0
    length = bit_length(azz)
    bsr = _bsr_prior(aavrg[..., unzig])
    nnzb = nz_bin_lut[torch.clamp(nz_left, 0, 49).long()].to(_I32)
    zz_idx = torch.arange(49, dtype=_I32, device=dev)
    exp_slice = (_OFF["exp_7x7"] + ci * e70 + nnzb * e71
                 + zz_idx * e72 + bsr * e73)
    exp_i, exp_b = _exp_block(active, length, exp_slice)  # [R,W,49,11]
    sign_valid = active & (length > 0)
    sign_i = torch.where(sign_valid, sign_base, PAD)[..., None].to(_I32)
    sign_b = (czz >= 0).to(_U8)[..., None]
    res_slice = res_base + unzig32 * r71 + nnzb * r72
    res_i, res_b = _res_block(active, length, azz, res_slice)
    over = (length > _MAXE).any(-1)
    interior_i = torch.cat([exp_i, sign_i, res_i], dim=-1)
    interior_b = torch.cat([exp_b, sign_b, res_b], dim=-1)
    emit(interior_i.reshape(R, W, 49 * COEF_SLOTS),
         interior_b.reshape(R, W, 49 * COEF_SLOTS))
    del exp_i, exp_b, res_i, res_b, interior_i, interior_b

    nzm = czz != 0
    eob_x = torch.where(nzm, unzig32 & 7, 0).amax(-1)
    eob_y = torch.where(nzm, unzig32 >> 3, 0).amax(-1)

    # ---- edges: horizontal (coords 1..7) then vertical (8..56)
    # (encoder.cc:166-184, encode_one_edge :41-164)
    ex0, ex1, ex2, ex3, _ = _STR["exp_x"]
    expx_base = _OFF["exp_x"] + ci * ex0
    rt0, rt1, rt2, _ = _STR["residual_thresh"]
    rt_base = _OFF["residual_thresh"] + ci * rt0
    cap = (1 << C.RESIDUAL_NOISE_FLOOR) - 1
    mnt_all = min_noise_threshold.to(device=dev, dtype=_I32)

    for horizontal in (True, False):
        if horizontal:
            coords_np = np.arange(1, 8)
            zig15, tbl, est_eob, lak_lane0 = 0, "nz_8x1", eob_x, 0
        else:
            coords_np = np.arange(8, 64, 8)
            zig15, tbl, est_eob, lak_lane0 = 7, "nz_1x8", eob_y, 7
        coords = torch.as_tensor(coords_np, dtype=torch.int64, device=dev)
        coords32 = coords.to(_I32)
        ce = coefs32[..., coords]                        # [R, W, 7]
        ae = torch.abs(ce)
        nonzero_e = (ce != 0).to(_I32)
        cnt = nonzero_e.sum(-1).to(_I32)                 # [R, W]
        n0, n1, n2, n3, _ = _STR[tbl]
        nz_slice = (_OFF[tbl] + ci * n0 + est_eob * n1
                    + ((nz7 + 3) // 7) * n2)
        emit(*_tree_bits(cnt, 3, nz_slice, n3))

        eprefix = (torch.cumsum(nonzero_e, dim=-1) - nonzero_e).to(_I32)
        remaining = cnt[..., None] - eprefix             # [R, W, 7]
        active_e = remaining > 0
        length_e = bit_length(ae)
        bp = lak[..., lak_lane0:lak_lane0 + 7]
        bsr_e = _bsr_prior(bp)
        lane = torch.arange(7, dtype=_I32, device=dev)
        exp_slice_e = (expx_base + remaining * ex1
                       + (zig15 + lane) * ex2 + bsr_e * ex3)
        exp_i, exp_b = _exp_block(active_e, length_e, exp_slice_e)
        ctx1 = torch.where(bp == 0, 0, torch.where(bp > 0, 1, 2))
        sign_valid = active_e & (ce != 0)
        sign_i = torch.where(sign_valid, sign_base + ctx1 * sg1 + bsr_e,
                             PAD)[..., None].to(_I32)
        sign_b = (ce >= 0).to(_U8)[..., None]

        over |= (length_e > _MAXE).any(-1)
        # residual: threshold-contexted bits above the per-coord noise
        # floor (serial so_far chain, <= 10 bits), then plain noise bits
        # (encoder.cc:131-160)
        mt = mnt_all[coords]
        t1 = torch.clamp(torch.abs(bp) >> mt, max=255)
        t2 = torch.clamp(length_e - mt, max=C.RESIDUAL_NOISE_FLOOR)
        thresh_slice = rt_base + t1 * rt1 + t2 * rt2
        res_slice_e = res_base + coords32 * r71 + remaining * r72
        so_far = torch.ones_like(remaining)
        res_is, res_bs = [], []
        for j in range(C.COEF_BITS):
            i = length_e - 2 - j
            valid = active_e & (i >= 0)
            safe_i = torch.clamp(i, min=0)
            bit = (ae >> safe_i) & 1
            is_thresh = i >= mt
            idx = torch.where(is_thresh, thresh_slice + so_far,
                              res_slice_e + safe_i)
            res_is.append(torch.where(valid, idx, PAD))
            res_bs.append(bit.to(_U8))
            so_far = torch.where(valid & is_thresh,
                                 torch.clamp((so_far << 1) | bit, max=cap),
                                 so_far)
        res_i = torch.stack(res_is, dim=-1)
        res_b = torch.stack(res_bs, dim=-1)
        edge_i = torch.cat([exp_i, sign_i, res_i], dim=-1)
        edge_b = torch.cat([exp_b, sign_b, res_b], dim=-1)
        emit(edge_i.reshape(R, W, 7 * COEF_SLOTS),
             edge_b.reshape(R, W, 7 * COEF_SLOTS))

    # ---- DC last (encoder.cc:293-364): delta vs the pixel-domain
    # prediction, wrapped into [-1024, 1024] (model.hh:823-832)
    dc = coefs32[..., 0]
    delta = dc - pa["dc_pred"]
    max_value = 1 << (_MAXE - 1)
    adj = 2 * max_value + 1
    delta = torch.where(delta < -max_value, delta + adj, delta)
    delta = torch.where(delta > max_value, delta - adj, delta)
    a_dc = torch.abs(delta)
    length_dc = bit_length(a_dc)
    lm = torch.clamp(bit_length(torch.abs(pa["uncertainty"])),
                     max=C.NUMERIC_LENGTH_MAX - 1)
    lo = torch.clamp(bit_length(torch.abs(pa["uncertainty2"])), max=16)
    ed0, ed1, _ = _STR["exp_dc"]
    exp_slice_dc = _OFF["exp_dc"] + lm * ed0 + lo * ed1
    always = torch.ones((R, W), dtype=torch.bool, device=dev)
    exp_i, exp_b = _exp_block(always, length_dc, exp_slice_dc)
    unc2 = pa["uncertainty2"]
    sctx = torch.where(unc2 < 0, 1, torch.where(unc2 == 0, 3, 2))
    sign_i = torch.where(length_dc > 0, sign_base + sctx,
                         PAD)[..., None].to(_I32)
    sign_b = (delta >= 0).to(_U8)[..., None]
    rd0, _ = _STR["residual_noise_dc"]
    res_slice_dc = _OFF["residual_noise_dc"] + lm * rd0
    res_i, res_b = _res_block(always, length_dc, a_dc, res_slice_dc)
    emit(torch.cat([exp_i, sign_i, res_i], dim=-1),
         torch.cat([exp_b, sign_b, res_b], dim=-1))

    idx = torch.cat(pieces_idx, dim=-1).to(_I32)         # [R, W, BLOCK_SLOTS]
    bit = torch.cat(pieces_bit, dim=-1).to(_U8)
    over = block_live & (over | (length_dc > _MAXE))
    idx[..., 0] = torch.where(over, COEF_OUT_OF_RANGE, idx[..., 0])
    return idx, bit


# ---------------------------------------------------------------------------
# The symbol kernels (csrc/symbolize.cu): only the live symbols, no slab
# ---------------------------------------------------------------------------

# blocks of the plain versions' slab a call: bounds [rows, W, BLOCK_SLOTS]
# and its intermediates to about a gigabyte
SLAB_BLOCKS = 1 << 15
# csrc/symbolize.cu's kTile (blocks of one row a CTA takes) and kStage (the
# symbols symbol_emit stages in shared memory a round)
TILE_BLOCKS = 32
STAGE_SYMBOLS = 4096
# tables the walk indexes, in the order of csrc/symbolize.cu's Tab: each
# table's offset, then its strides but the last (which is 1)
PARAM_TABLES = ("nz_7x7", "nz_1x8", "nz_8x1", "residual_noise",
                "residual_noise_dc", "residual_thresh", "exp_7x7", "exp_x",
                "exp_dc", "sign")
PARAM_NAMES = tuple(
    name for t in PARAM_TABLES for name in
    [t.upper()] + [f"{t.upper()}_S{k}" for k in range(len(_STR[t]) - 1)])
# the plane's int32 [64] tables of the parameter block, after the tables,
# bins and zigzag order, in the source's order (kNoise, kQuant, kIcosX,
# kIcosY)
PLANE_TABLES = ("min_noise_threshold", "quant", "icos_x", "icos_y")


def table_params() -> np.ndarray:
    """The parameter block's tables part, int32 in PARAM_NAMES order,
    from model/tables.py's TABLE_OFFSETS and TABLE_STRIDES."""
    return np.array([v for t in PARAM_TABLES
                     for v in (_OFF[t],) + _STR[t][:-1]], np.int32)


def params(plane: "Plane") -> np.ndarray:
    """The kernels' whole parameter block (csrc/symbolize.cu Params):
    table_params(), the nonzero-count bins (50), the zigzag order of the
    7x7 interior (49), then the plane's PLANE_TABLES (64 each), int32."""
    return np.concatenate([
        table_params(), np.asarray(C.NONZERO_TO_BIN, np.int32),
        np.asarray(C.UNZIGZAG49, np.int32)]
        + [np.asarray(getattr(plane, k), np.int32) for k in PLANE_TABLES])


class Plane(NamedTuple):
    """One plane's inputs to the symbol kernels: its coefficients and row
    flags on one device, and its colour tables, model and size limit on
    the host."""
    coefs: torch.Tensor          # int16 [H, W, 64] raster
    row_has_above: torch.Tensor  # bool [H]
    quant: np.ndarray            # int32 [64] raster (ColorTables)
    icos_x: np.ndarray           # int32 [64]: icos_idct_edge_8192_dequantized_x
    icos_y: np.ndarray           # int32 [64]: ..._y
    min_noise_threshold: np.ndarray  # int32 [64]
    ci: int                      # 0 luma, 1 chroma model
    row_block_offset: int        # the plane index of block (0, 0)
    size_limit: int              # blocks past it code nothing but block 0
                                 # of a row (symbolize_slice)


def plane_inputs(coefs: torch.Tensor, ci: int, ct, row_has_above,
                 size_limit: int, row_block_offset: int = 0) -> Plane:
    """A whole plane (coefs int16 [H, W, 64] on its device) with the
    ColorTables `ct` and row_has_above (bool [H], or a tensor of it on the
    plane's device), as the symbol kernels and their plain versions take
    it."""
    rha = torch.as_tensor(row_has_above, device=coefs.device,
                          dtype=torch.bool)
    return Plane(coefs, rha, *(np.asarray(a, np.int32) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)),
        int(ci), int(row_block_offset), int(size_limit))


def check(plane: Plane) -> None:
    """Raise on a plane the kernels do not take."""
    H, W = plane.coefs.shape[:2]
    for name, dtype, shape in (("coefs", torch.int16, (H, W, 64)),
                               ("row_has_above", torch.bool, (H,))):
        t = getattr(plane, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, not "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != plane.coefs.device:
            raise ValueError(f"{name} must be on {plane.coefs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in PLANE_TABLES:
        if np.shape(getattr(plane, name)) != (64,):
            raise ValueError(f"{name} must be [64]")
    if not 0 <= plane.ci < C.BLOCK_TYPES:
        raise ValueError(f"ci must lie in [0, {C.BLOCK_TYPES})")
    if plane.coefs.device.type == "cuda":
        if plane.coefs.data_ptr() % 16:
            raise ValueError("coefs must be 16-byte aligned")
        if H > 65535:
            raise ValueError("a plane of more than 65535 rows")


def _slabs(plane: Plane):
    """(r0, r1, idx, bit) of the plain slab (_slab) of the plane's rows in
    chunks of about SLAB_BLOCKS blocks, each with the row above it as
    context and dropped; phase A (the contexts the kernels compute in
    shared memory) is taken once over the whole plane."""
    H, W = plane.coefs.shape[:2]
    dev = plane.coefs.device
    quant, icx, icy, mnt = (torch.as_tensor(getattr(plane, k), device=dev)
                            for k in ("quant", "icos_x", "icos_y",
                                      "min_noise_threshold"))
    pa = phase_a(plane.coefs, quant, icx, icy, plane.row_has_above)
    step = max(1, SLAB_BLOCKS // max(W, 1))
    for r0 in range(0, H, step):
        r1 = min(H, r0 + step)
        lo = max(r0 - 1, 0)
        idx, bit = _slab(plane.coefs[lo:r1], {k: v[lo:r1] for k, v in
                                              pa.items()},
                         plane.ci, mnt, plane.row_block_offset + lo * W,
                         plane.size_limit, plane.row_has_above[lo:r1])
        yield r0, r1, idx[r0 - lo:], bit[r0 - lo:]


def symbol_counts_plain(plane: Plane):
    """The symbol_counts kernel's plain PyTorch version: each block's live
    slots of symbolize_slice's slab, and whether its first slot carries
    COEF_OUT_OF_RANGE.  Returns (counts int32 [H, W], over bool [H, W])."""
    check(plane)
    counts, over = [], []
    for _, _, idx, _ in _slabs(plane):
        counts.append((idx != PAD).sum(-1, dtype=_I32))
        over.append(idx[..., 0] == COEF_OUT_OF_RANGE)
    return torch.cat(counts), torch.cat(over)


def symbol_runs_plain(plane: Plane):
    """Both plain versions' work from one pass of the slab: (counts int32
    [H, W], over bool [H, W], idx int32 [N], bit uint8 [N]), idx and bit
    every block's live slots in order, block after block.  The route on a
    CPU plane (batch_encode._count_plane) takes it once and hands it to
    emit_symbols_plain."""
    check(plane)
    counts, over, parts_i, parts_b = [], [], [], []
    for _, _, idx, bit in _slabs(plane):
        live = idx != PAD
        counts.append(live.sum(-1, dtype=_I32))
        over.append(idx[..., 0] == COEF_OUT_OF_RANGE)
        parts_i.append(idx[live])
        parts_b.append(bit[live])
    return (torch.cat(counts), torch.cat(over), torch.cat(parts_i),
            torch.cat(parts_b))


def _outputs(dev, total: int, out):
    """(idx int32 [total], bit uint8 [total]) on dev: `out` checked, or
    new tensors."""
    if out is None:
        return (torch.empty(total, dtype=_I32, device=dev),
                torch.empty(total, dtype=_U8, device=dev))
    for t, dtype in zip(out, (_I32, _U8)):
        if (t.dtype != dtype or tuple(t.shape) != (total,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"out must be contiguous int32 and uint8 "
                             f"[{total}] on {dev}")
    return out


def emit_symbols_plain(plane: Plane, offsets: torch.Tensor, total: int,
                       runs=None, out=None):
    """The symbol_emit kernel's plain PyTorch version: symbolize_slice's
    slab, its live slots compacted in order by a boolean mask, and block
    (r, c)'s run placed at offsets[r, c].  runs: symbol_runs_plain(plane)
    where the caller has it already; out: as emit_symbols takes it.
    Returns (idx int32 [total], bit uint8 [total]); an over-range block's
    first symbol is COEF_OUT_OF_RANGE."""
    check(plane)
    counts, _, idx, bit = symbol_runs_plain(plane) if runs is None else runs
    dev = plane.coefs.device
    n = counts.reshape(-1).to(torch.int64)
    first = torch.cumsum(n, 0) - n
    m = len(idx)
    pos = torch.repeat_interleave(offsets.reshape(-1) - first, n,
                                  output_size=m)
    pos += torch.arange(m, device=dev)
    out_i, out_b = _outputs(dev, total, out)
    out_i[pos] = idx
    out_b[pos] = bit
    return out_i, out_b


_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("symbolize")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            plane = [p, p] + [i64] * 4 + [i, p, i]
            lib.symbol_counts_launch.argtypes = plane + [p, p, p]
            lib.symbol_counts_launch.restype = i
            lib.symbol_emit_launch.argtypes = plane + [p, p, p, i64, p]
            lib.symbol_emit_launch.restype = i
            lib.symbolize_error_string.argtypes = [i]
            lib.symbolize_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _plane_args(plane: Plane) -> list:
    """The launch functions' leading arguments: the plane's tensors, its
    geometry, its model and its parameter block (a host array)."""
    H, W = plane.coefs.shape[:2]
    prm = params(plane)
    # the pointer keeps the array alive through the call
    return [plane.coefs.data_ptr(), plane.row_has_above.data_ptr(),
            H, W, plane.row_block_offset, plane.size_limit, plane.ci,
            prm.ctypes.data_as(ctypes.c_void_p), len(prm)]


def _launch(lib, fn, wrapper, args: list, stream: int) -> None:
    with cuda_build.bounds(lib, stream, per_lane=False):
        err = fn(*args, stream)
        cuda_build.count_launch(wrapper)
        if err:
            raise RuntimeError(f"{fn.__name__} failed: "
                               + lib.symbolize_error_string(err).decode())


def symbol_counts(plane: Plane):
    """Each block's count of live symbols and whether it codes a value past
    11 bits (which has no code: the image is refused).  Returns (counts
    int32 [H, W], over bool [H, W]).  CUDA tensors launch the
    symbol_counts kernel (csrc/symbolize.cu), which computes phase A
    itself from the coefficients; CPU tensors run symbol_counts_plain."""
    check(plane)
    if plane.coefs.device.type == "cpu":
        return symbol_counts_plain(plane)
    dev = plane.coefs.device
    H, W = plane.coefs.shape[:2]
    counts = torch.empty((H, W), dtype=_I32, device=dev)
    over = torch.empty((H, W), dtype=torch.bool, device=dev)
    lib = _get_lib()
    _launch(lib, lib.symbol_counts_launch, symbol_counts,
            _plane_args(plane) + [counts.data_ptr(), over.data_ptr()],
            torch.cuda.current_stream(dev).cuda_stream)
    return counts, over


symbol_counts.launches = 0


def emit_symbols(plane: Plane, offsets: torch.Tensor, total: int,
                 out=None):
    """Each block's live symbols in emission order, block (r, c)'s at
    offsets[r, c] (int64 [H, W], as an exclusive sum of symbol_counts
    gives them) of outputs of `total` symbols: `out`, a pair of
    contiguous int32 and uint8 [total] tensors on the plane's device
    (views of a batch's outputs), or new ones.  Returns (idx int32
    [total], bit uint8 [total]); the first symbol of a block that codes a
    value past 11 bits is COEF_OUT_OF_RANGE.  CUDA tensors launch the
    symbol_emit kernel (csrc/symbolize.cu); CPU tensors run
    emit_symbols_plain."""
    check(plane)
    H, W = plane.coefs.shape[:2]
    if (offsets.dtype != torch.int64 or tuple(offsets.shape) != (H, W)
            or offsets.device != plane.coefs.device
            or not offsets.is_contiguous()):
        raise ValueError(f"offsets must be contiguous int64 [{H}, {W}] on "
                         f"{plane.coefs.device}")
    if plane.coefs.device.type == "cpu":
        return emit_symbols_plain(plane, offsets, total, out=out)
    dev = plane.coefs.device
    idx, bit = _outputs(dev, total, out)
    lib = _get_lib()
    _launch(lib, lib.symbol_emit_launch, emit_symbols,
            _plane_args(plane) + [offsets.data_ptr(), idx.data_ptr(),
                                  bit.data_ptr(), total],
            torch.cuda.current_stream(dev).cuda_stream)
    return idx, bit


emit_symbols.launches = 0
