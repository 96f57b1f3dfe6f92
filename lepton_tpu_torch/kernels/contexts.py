"""Phase A: every model context of every block, as tensor programs.

Port of the blockwise composition of lepton_tpu/kernels/contexts.py
(phase_a_reference, :270-282) with the segment-top handling of its planar
form (row_has_above, :383-386).  Every context the token codec needs --
neighbor summaries, aavrg averages, Lakhani DCT predictions, the
pixel-domain DC prediction -- is a pure function of the (fully known)
coefficients, so it runs over all blocks at once.

All arithmetic is the JAX package's: int32 tensors that wrap like the
reference's C ints, uint16 masking in aavrg, int16 stores of pixels and
edges, and the same floor divisions of magnitudes.  Torch sums of int32
promote to int64; they are cast back, which wraps the same way.
"""
from __future__ import annotations

import torch

from .. import constants as C

_I32 = torch.int32


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """bit_length of an int32 tensor, 0 where v <= 0 (32 - clz(v) for
    v > 0).  frexp of the exact float64 value gives the exponent."""
    _, e = torch.frexp(v.to(torch.float64))
    return torch.where(v > 0, e.to(_I32), torch.zeros((), dtype=_I32,
                                                       device=v.device))


def _shift_rows(x: torch.Tensor) -> torch.Tensor:
    """out[r] = x[r - 1] along dim 0, zeros in row 0 (the above neighbor)."""
    out = torch.zeros_like(x)
    out[1:] = x[:-1]
    return out


def _shift_cols(x: torch.Tensor) -> torch.Tensor:
    """out[:, c] = x[:, c - 1], zeros in column 0 (the left neighbor)."""
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def _has_above(row_has_above, H: int, device) -> torch.Tensor:
    """bool [H]: rows whose above-context exists (default: all but row 0)."""
    if row_has_above is None:
        return torch.arange(H, device=device) > 0
    return row_has_above.to(device=device, dtype=torch.bool)


def _idct_rows(c: torch.Tensor, ignore_dc: bool) -> torch.Tensor:
    """Horizontal pass: c is int32 [..., 8, 8] dequantized coefficients."""
    if ignore_dc:
        c = c.clone()
        c[..., 0, 0] = 0
    x0 = (c[..., :, 0] << 11) + 128
    x1 = c[..., :, 4] << 11
    x2, x3, x4 = c[..., :, 6], c[..., :, 2], c[..., :, 1]
    x5, x6, x7 = c[..., :, 7], c[..., :, 5], c[..., :, 3]
    x8 = C.W7 * (x4 + x5)
    x4, x5 = x8 + C.W1MW7 * x4, x8 - C.W1PW7 * x5
    x8 = C.W3 * (x6 + x7)
    x6, x7 = x8 - C.W3MW5 * x6, x8 - C.W3PW5 * x7
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = C.W6 * (x3 + x2)
    x2, x3 = x1 - C.W2PW6 * x2, x1 + C.W2MW6 * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (C.R2 * (x4 + x5) + 128) >> 8
    x4 = (C.R2 * (x4 - x5) + 128) >> 8
    return torch.stack([
        (x7 + x1) >> 8, (x3 + x2) >> 8, (x0 + x4) >> 8, (x8 + x6) >> 8,
        (x8 - x6) >> 8, (x0 - x4) >> 8, (x3 - x2) >> 8, (x7 - x1) >> 8,
    ], dim=-1)


def _idct_cols(inter: torch.Tensor) -> torch.Tensor:
    y0 = (inter[..., 0, :] << 8) + 8192
    y1 = inter[..., 4, :] << 8
    y2, y3, y4 = inter[..., 6, :], inter[..., 2, :], inter[..., 1, :]
    y5, y6, y7 = inter[..., 7, :], inter[..., 5, :], inter[..., 3, :]
    y8 = C.W7 * (y4 + y5) + 4
    y4, y5 = (y8 + C.W1MW7 * y4) >> 3, (y8 - C.W1PW7 * y5) >> 3
    y8 = C.W3 * (y6 + y7) + 4
    y6, y7 = (y8 - C.W3MW5 * y6) >> 3, (y8 - C.W3PW5 * y7) >> 3
    y8 = y0 + y1
    y0 = y0 - y1
    y1 = C.W6 * (y3 + y2) + 4
    y2, y3 = (y1 - C.W2PW6 * y2) >> 3, (y1 + C.W2MW6 * y3) >> 3
    y1 = y4 + y6
    y4 = y4 - y6
    y6 = y5 + y7
    y5 = y5 - y7
    y7 = y8 + y3
    y8 = y8 - y3
    y3 = y0 + y2
    y0 = y0 - y2
    y2 = (C.R2 * (y4 + y5) + 128) >> 8
    y4 = (C.R2 * (y4 - y5) + 128) >> 8
    return torch.stack([
        (y7 + y1) >> 11, (y3 + y2) >> 11, (y0 + y4) >> 11, (y8 + y6) >> 11,
        (y8 - y6) >> 11, (y0 - y4) >> 11, (y3 - y2) >> 11, (y7 - y1) >> 11,
    ], dim=-2)


def idct_blocks(coefs: torch.Tensor, quant: torch.Tensor,
                ignore_dc: bool = True) -> torch.Tensor:
    """Fixed-point IDCT (idct.cc:36-160).  coefs int16/int32 [..., 64]
    raster, quant int32 [64].  Returns int16 pixels [..., 64] scaled by 8
    (the scalar IDCT stores int16: the cast wraps)."""
    c = (coefs.to(_I32) * quant.to(_I32)).reshape(coefs.shape[:-1] + (8, 8))
    out = _idct_cols(_idct_rows(c, ignore_dc))
    return out.reshape(coefs.shape[:-1] + (64,)).to(torch.int16)


def _div2_toward_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.sign(v) * (torch.abs(v) >> 1)


def neighbor_summaries(coefs: torch.Tensor, quant: torch.Tensor):
    """Per-block outgoing edge pixels + nonzero counts, all blocks at once.

    coefs: int16 [H, W, 64] raster.  Returns (nz7x7 uint8 [H, W],
    edges int16 [H, W, 16], pixels int16 [H, W, 64]) matching
    NeighborSummary (block_context.hh)."""
    pixels = idct_blocks(coefs, quant, ignore_dc=True).to(_I32)
    dc = coefs[..., 0].to(_I32)
    q0 = quant[0].to(_I32)
    px = pixels.reshape(pixels.shape[:-1] + (8, 8))
    # vertical (right edge): col 7, delta vs col 6
    vcur = px[..., :, 7]
    vert = dc[..., None] * q0 + vcur + 1024 + _div2_toward_zero(
        vcur - px[..., :, 6])
    # horizontal (bottom edge): row 7, delta vs row 6
    hcur = px[..., 7, :]
    horiz = dc[..., None] * q0 + hcur + 1024 + _div2_toward_zero(
        hcur - px[..., 6, :])
    edges = torch.cat([vert, horiz], dim=-1).to(torch.int16)
    grid = coefs.reshape(coefs.shape[:-1] + (8, 8))
    nz7 = (grid[..., 1:, 1:] != 0).sum(dim=(-1, -2)).to(torch.uint8)
    return nz7, edges, pixels.to(torch.int16)


def aavrg_all(coefs: torch.Tensor, row_has_above=None) -> torch.Tensor:
    """Weighted neighbor-abs averages for every block and coefficient.

    coefs int16 [H, W, 64] -> int32 [H, W, 64]; edge rows/cols follow the
    reduced-neighbor formulas (model.hh:852-871) with uint16 truncation."""
    a = torch.abs(coefs.to(_I32))
    H, W = a.shape[0], a.shape[1]
    left = _shift_cols(a)
    above = _shift_rows(a)
    aboveleft = _shift_rows(left)
    has_left = (torch.arange(W, device=a.device) > 0)[None, :, None]
    has_above = _has_above(row_has_above, H, a.device)[:, None, None]
    both = ((13 * (left + above) + 6 * aboveleft) & 0xFFFF) >> 5
    zero = torch.zeros_like(a)
    return torch.where(has_left & has_above, both,
                       torch.where(has_left, left,
                                   torch.where(has_above, above, zero)))


def lak_all(coefs: torch.Tensor, icos_x: torch.Tensor, icos_y: torch.Tensor,
            row_has_above=None) -> torch.Tensor:
    """Lakhani predictions for the 14 edge coefficients of every block
    (model.hh:1033-1071).

    Returns int32 [H, W, 14]: lanes 0..6 horizontal (coords 1..7),
    lanes 7..13 vertical (coords 8..56)."""
    c = coefs.to(_I32).reshape(coefs.shape[:-1] + (8, 8))
    H, W = c.shape[0], c.shape[1]
    dev = c.device
    above = _shift_rows(c)
    left = _shift_cols(c)
    has_above = _has_above(row_has_above, H, dev)[:, None, None]
    has_left = (torch.arange(W, device=dev) > 0)[None, :, None]
    # (-1)^(i+1): the neighbor's coefficients enter with alternating sign
    sign = torch.tensor([-1, 1, -1, 1, -1, 1, -1, 1], dtype=_I32, device=dev)

    def predict(x, a, icos):
        # x's own entry 0 never enters: the block's edge coefficient is
        # what is being predicted
        # pred = a0*icos0 - sum_{i>=1} icos_i*(x_i + s_i*a_i), truncated
        # toward zero by icos0: sign * (|pred| // icos0) as the JAX package
        # divides (floor of a magnitude)
        s = (icos[:, 1:] * (x[..., 1:] + sign[1:] * a[..., 1:])).sum(-1)
        pred = a[..., 0] * icos[:, 0] - s.to(_I32)
        den = icos[:, 0]
        return torch.sign(pred) * torch.div(torch.abs(pred), den,
                                            rounding_mode="floor")

    # horizontal: band b in 1..7 runs down column b of here and above
    x_h = c[..., :, 1:8].transpose(-1, -2)              # [H, W, 7band, 8]
    a_h = above[..., :, 1:8].transpose(-1, -2)
    icosx = icos_x.to(_I32).reshape(8, 8)[1:8]          # [7band, 8]
    pred_h = torch.where(has_above, predict(x_h, a_h, icosx), 0)
    # vertical: band 8k runs along row k of here and left
    icosy = icos_y.to(_I32).reshape(8, 8)[1:8]
    pred_v = torch.where(has_left, predict(c[..., 1:8, :], left[..., 1:8, :],
                                           icosy), 0)
    return torch.cat([pred_h, pred_v], dim=-1).to(_I32)


def dc_predictions(coefs: torch.Tensor, quant: torch.Tensor,
                   edges: torch.Tensor, pixels: torch.Tensor,
                   row_has_above=None):
    """Pixel-domain DC prediction for every block (model.hh:674-784).

    edges: int16 [H, W, 16] neighbor summaries (from neighbor_summaries).
    Returns (predicted_dc, uncertainty, uncertainty2) int32 [H, W]."""
    H, W = coefs.shape[0], coefs.shape[1]
    dev = coefs.device
    px = pixels.to(_I32).reshape(H, W, 8, 8)
    q0 = quant[0].to(_I32)
    left_edges = _shift_cols(edges).to(_I32)
    above_edges = _shift_rows(edges).to(_I32)
    has_left = (torch.arange(W, device=dev) > 0)[None, :]
    has_above = _has_above(row_has_above, H, dev)[:, None]

    # left estimates (the int16 cast wraps as the scalar code stores it)
    a_l = px[..., :, 0] + 1024
    b_l = left_edges[..., 0:8] - _div2_toward_zero(px[..., :, 0]
                                                   - px[..., :, 1])
    est_l = (b_l - a_l).to(torch.int16).to(_I32)
    # above estimates
    a_a = px[..., 0, :] + 1024
    b_a = above_edges[..., 8:16] - _div2_toward_zero(px[..., 0, :]
                                                     - px[..., 1, :])
    est_a = (b_a - a_a).to(torch.int16).to(_I32)

    big = 1 << 30
    l_mask = has_left[..., None]
    a_mask = has_above[..., None]
    any_mask = has_left | has_above
    mins = torch.minimum(torch.where(l_mask, est_l, big).amin(-1),
                         torch.where(a_mask, est_a, big).amin(-1))
    maxs = torch.maximum(torch.where(l_mask, est_l, -big).amax(-1),
                         torch.where(a_mask, est_a, -big).amax(-1))
    sum_l = torch.where(l_mask, est_l, 0).sum(-1).to(_I32)
    sum_a = torch.where(a_mask, est_a, 0).sum(-1).to(_I32)
    # avg_h = first-eight estimates (left if present else above)
    avg_h = torch.where(has_left, sum_l, sum_a)
    avg_v = torch.where(has_left & has_above, sum_a, avg_h)
    overall = (avg_h + avg_v) >> 1
    uncertainty = torch.where(any_mask, (maxs - mins) >> 3, 0).to(_I32)
    dh = avg_h - overall
    dv = avg_v - overall
    far = torch.where(torch.abs(dh) < torch.abs(dv), dh, dv)
    uncertainty2 = torch.where(any_mask, far >> 3, 0).to(_I32)
    avgmed = torch.where(any_mask, overall, 0)
    pred = (torch.sign(avgmed) * torch.div(torch.abs(avgmed), q0,
                                           rounding_mode="floor") + 4) >> 3
    return pred.to(_I32), uncertainty, uncertainty2


def block_bit_cost(coefs: torch.Tensor) -> torch.Tensor:
    """Rough per-block compressed-cost estimate (vp8_encoder.cc:156-189
    aligned_block_cost): 16 + sum(1 + 2*bitlength(|coef|))."""
    blen = bit_length(torch.abs(coefs.to(_I32)))
    return (16 + (1 + 2 * blen).sum(-1)).to(_I32)


def phase_a(coefs: torch.Tensor, quant: torch.Tensor,
            icos_x: torch.Tensor, icos_y: torch.Tensor,
            row_has_above: torch.Tensor = None):
    """Full phase-A bundle for one component plane.

    coefs int16 [H, W, 64] raster; quant, icos_x, icos_y int32 [64] on the
    same device.  row_has_above: optional bool [H] marking rows whose
    above-context is present; segment-top rows get False (the is_top_row
    reset of lepton_codec.hh:173-181).  Default: every row but the first.
    Returns the dict of lepton_tpu.kernels.contexts.phase_a."""
    nz7, edges, pixels = neighbor_summaries(coefs, quant)
    aavrg = aavrg_all(coefs, row_has_above)
    lak = lak_all(coefs, icos_x, icos_y, row_has_above)
    pred, unc, unc2 = dc_predictions(coefs, quant, edges, pixels,
                                     row_has_above)
    cost = block_bit_cost(coefs)
    return dict(nz7x7=nz7, edges=edges, pixels=pixels, aavrg=aavrg,
                lak=lak, dc_pred=pred, uncertainty=unc, uncertainty2=unc2,
                cost=cost)
