"""Neighbor-context computations for the scalar token codec, and the
per-color derived quantization tables.

Copy of lepton_tpu/model/context.py (:1-293), exact integer ports of the
reference's context machinery:
  - fixed-point IDCT (idct.cc:36-160, scalar path; the SSE/AVX paths compute
    identical values)
  - per-color derived tables (model.hh:247-289 set_quantization_table)
  - aavrg / Lakhani / DC-pixel prediction (model.hh:852-1071, 674-784)
  - NeighborSummary edge pixels (block_context.hh:17-95)

All arithmetic replicates C semantics: int32 wraparound in the IDCT,
uint16 truncation in aavrg, truncation-toward-zero divisions.  The device
path computes the same contexts for all blocks at once
(kernels/contexts.py); ColorTables feeds both, and the scalar functions
serve the Python segment codec (codec/blocks.py), its reference.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C

_I32 = np.int32


def trunc_div(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


class ColorTables:
    """Per-color derived quantization tables (model.hh:210-309)."""

    def __init__(self, qtable_zigzag):
        # qtable arrives in zigzag (DQT) order; store raster-indexed
        q = np.asarray(qtable_zigzag, dtype=np.int64)
        self.quant = q[C.RASTER_TO_ZIGZAG]  # quantization_table_[raster]
        quant = self.quant
        icos_lin = np.zeros(64, dtype=np.int64)
        icos_x = np.zeros(64, dtype=np.int64)
        icos_y = np.zeros(64, dtype=np.int64)
        for pixel_row in range(8):
            for i in range(8):
                icos_lin[pixel_row * 8 + i] = (
                    C.ICOS_IDCT_LINEAR_8192_SCALED[pixel_row * 8 + i] * quant[i])
                icos_x[pixel_row * 8 + i] = (
                    C.ICOS_BASE_8192_SCALED[i * 8] * quant[i * 8 + pixel_row])
                icos_y[pixel_row * 8 + i] = (
                    C.ICOS_BASE_8192_SCALED[i * 8] * quant[pixel_row * 8 + i])
        self.icos_idct_linear_8192_dequantized = icos_lin
        self.icos_idct_edge_8192_dequantized_x = icos_x
        self.icos_idct_edge_8192_dequantized_y = icos_y

        freqmax = (C.FREQMAX + quant - 1)
        nz = quant != 0
        freqmax[nz] = freqmax[nz] // quant[nz]
        self.freqmax = freqmax
        self.bitlen_freqmax = np.array(
            [int(v).bit_length() for v in freqmax], dtype=np.int64)
        self.min_noise_threshold = np.maximum(
            self.bitlen_freqmax - C.RESIDUAL_NOISE_FLOOR, 0)


def idct_block(coef_raster: np.ndarray, quant: np.ndarray,
               ignore_dc: bool) -> np.ndarray:
    """Fixed-point 8x8 IDCT -> int16 pixels scaled by 8 (idct.cc:36-160).

    coef_raster: int array of 64 raster-order coefficients.
    quant: raster-order quantization table.
    """
    with np.errstate(over="ignore"):
        c = coef_raster.astype(np.int64) * quant
        c = c.reshape(8, 8).astype(_I32)
        if ignore_dc:
            c = c.copy()
            c[0, 0] = 0
        # Horizontal pass over rows
        x0 = ((c[:, 0] << 11) + 128).astype(_I32)
        x1 = (c[:, 4] << 11).astype(_I32)
        x2, x3, x4, x5, x6, x7 = (c[:, 6], c[:, 2], c[:, 1],
                                  c[:, 7], c[:, 5], c[:, 3])
        x8 = (C.W7 * (x4 + x5)).astype(_I32)
        x4 = (x8 + C.W1MW7 * x4).astype(_I32)
        x5 = (x8 - C.W1PW7 * x5).astype(_I32)
        x8 = (C.W3 * (x6 + x7)).astype(_I32)
        x6 = (x8 - C.W3MW5 * x6).astype(_I32)
        x7 = (x8 - C.W3PW5 * x7).astype(_I32)
        x8 = (x0 + x1).astype(_I32)
        x0 = (x0 - x1).astype(_I32)
        x1 = (C.W6 * (x3 + x2)).astype(_I32)
        x2 = (x1 - C.W2PW6 * x2).astype(_I32)
        x3 = (x1 + C.W2MW6 * x3).astype(_I32)
        x1 = (x4 + x6).astype(_I32)
        x4 = (x4 - x6).astype(_I32)
        x6 = (x5 + x7).astype(_I32)
        x5 = (x5 - x7).astype(_I32)
        x7 = (x8 + x3).astype(_I32)
        x8 = (x8 - x3).astype(_I32)
        x3 = (x0 + x2).astype(_I32)
        x0 = (x0 - x2).astype(_I32)
        x2 = ((C.R2 * (x4 + x5) + 128) >> 8).astype(_I32)
        x4 = ((C.R2 * (x4 - x5) + 128) >> 8).astype(_I32)
        inter = np.empty((8, 8), dtype=_I32)
        inter[:, 0] = (x7 + x1) >> 8
        inter[:, 1] = (x3 + x2) >> 8
        inter[:, 2] = (x0 + x4) >> 8
        inter[:, 3] = (x8 + x6) >> 8
        inter[:, 4] = (x8 - x6) >> 8
        inter[:, 5] = (x0 - x4) >> 8
        inter[:, 6] = (x3 - x2) >> 8
        inter[:, 7] = (x7 - x1) >> 8
        # Vertical pass over columns
        y0 = ((inter[0] << 8) + 8192).astype(_I32)
        y1 = (inter[4] << 8).astype(_I32)
        y2, y3, y4 = inter[6], inter[2], inter[1]
        y5, y6, y7 = inter[7], inter[5], inter[3]
        y8 = (C.W7 * (y4 + y5) + 4).astype(_I32)
        y4 = ((y8 + C.W1MW7 * y4) >> 3).astype(_I32)
        y5 = ((y8 - C.W1PW7 * y5) >> 3).astype(_I32)
        y8 = (C.W3 * (y6 + y7) + 4).astype(_I32)
        y6 = ((y8 - C.W3MW5 * y6) >> 3).astype(_I32)
        y7 = ((y8 - C.W3PW5 * y7) >> 3).astype(_I32)
        y8 = (y0 + y1).astype(_I32)
        y0 = (y0 - y1).astype(_I32)
        y1 = (C.W6 * (y3 + y2) + 4).astype(_I32)
        y2 = ((y1 - C.W2PW6 * y2) >> 3).astype(_I32)
        y3 = ((y1 + C.W2MW6 * y3) >> 3).astype(_I32)
        y1 = (y4 + y6).astype(_I32)
        y4 = (y4 - y6).astype(_I32)
        y6 = (y5 + y7).astype(_I32)
        y5 = (y5 - y7).astype(_I32)
        y7 = (y8 + y3).astype(_I32)
        y8 = (y8 - y3).astype(_I32)
        y3 = (y0 + y2).astype(_I32)
        y0 = (y0 - y2).astype(_I32)
        y2 = ((C.R2 * (y4 + y5) + 128) >> 8).astype(_I32)
        y4 = ((C.R2 * (y4 - y5) + 128) >> 8).astype(_I32)
        out = np.empty((8, 8), dtype=_I32)
        out[0] = (y7 + y1) >> 11
        out[1] = (y3 + y2) >> 11
        out[2] = (y0 + y4) >> 11
        out[3] = (y8 + y6) >> 11
        out[4] = (y8 - y6) >> 11
        out[5] = (y0 - y4) >> 11
        out[6] = (y3 - y2) >> 11
        out[7] = (y7 - y1) >> 11
    return out.reshape(64).astype(np.int16)


def set_horizontal(pixels: np.ndarray, quant0: int, dc: int) -> np.ndarray:
    """Outgoing bottom-edge pixels (block_context.hh set_horizontal).

    pixels: int16[64] IDCT output without DC.  Returns int16[8].
    """
    cur = pixels[56:64].astype(np.int64)
    prev = pixels[48:56].astype(np.int64)
    delta = cur - prev
    half = np.sign(delta) * (np.abs(delta) >> 1)  # round toward zero
    return (dc * quant0 + cur + 128 * 8 + half).astype(np.int16)


def set_vertical(pixels: np.ndarray, quant0: int, dc: int) -> np.ndarray:
    """Outgoing right-edge pixels (block_context.hh set_vertical)."""
    cur = pixels[7::8].astype(np.int64)
    prev = pixels[6::8].astype(np.int64)
    delta = cur - prev
    half = np.sign(delta) * (np.abs(delta) >> 1)
    return (dc * quant0 + cur + 128 * 8 + half).astype(np.int16)


def compute_aavrg(coord: int, left, above, aboveleft) -> int:
    """Weighted neighbor-abs average (model.hh:852-871).

    left/above/aboveleft are the neighbors' raster coefficient arrays or
    None when absent.  Exact uint16 truncation replicated.
    """
    total = 0
    if left is not None:
        total += abs(int(left[coord]))
    if above is not None:
        total += abs(int(above[coord]))
    if left is not None and above is not None:
        total *= 13
        total += 6 * abs(int(aboveleft[coord]))
        return (total & 0xFFFF) >> 5
    return total


def compute_aavrg_vec(coords: np.ndarray, left, above, aboveleft) -> np.ndarray:
    """Vectorized compute_aavrg over an array of raster coords."""
    if left is not None and above is not None:
        total = (np.abs(left[coords].astype(np.int64))
                 + np.abs(above[coords].astype(np.int64))) * 13
        total += 6 * np.abs(aboveleft[coords].astype(np.int64))
        return (total & 0xFFFF) >> 5
    if left is not None:
        return np.abs(left[coords].astype(np.int64))
    if above is not None:
        return np.abs(above[coords].astype(np.int64))
    return np.zeros(len(coords), dtype=np.int64)


def compute_lak(coord: int, here, above, left, color: "ColorTables") -> int:
    """Lakhani DCT continuity prediction for edge coefficients
    (model.hh:1033-1071).  Returns 0 when the needed neighbor is absent.
    """
    band = coord
    if (band & 7) and band < 8:
        # top edge: use above neighbor, walk down the column
        if above is None:
            return 0
        neighbor = above
        idxs = band + np.arange(8) * 8
        icos = color.icos_idct_edge_8192_dequantized_x[band * 8: band * 8 + 8]
    elif (band & 7) == 0 and band >= 8:
        if left is None:
            return 0
        neighbor = left
        idxs = band + np.arange(8)
        icos = color.icos_idct_edge_8192_dequantized_y[band: band + 8]
    else:
        return 0
    coeffs_x = here[idxs].astype(np.int64).copy()
    coeffs_x[0] = 0
    coeffs_a = neighbor[idxs].astype(np.int64)
    pred = int(coeffs_a[0] * icos[0])
    sign = np.where(np.arange(1, 8) & 1, 1, -1)
    pred -= int(np.sum(icos[1:] * (coeffs_x[1:] + sign * coeffs_a[1:])))
    return trunc_div(pred, int(icos[0]))


def adv_predict_dc_pix(here_raster: np.ndarray, color: "ColorTables",
                       left_summary, above_summary):
    """Pixel-domain DC prediction (model.hh:674-784).

    left_summary/above_summary: int16[16] NeighborSummary edge pixels of the
    left/above neighbor (or None).  Returns
    (predicted_dc, uncertainty, uncertainty2, pixels_sans_dc).
    """
    q = color.quant
    pixels = idct_block(here_raster, q, True)
    uncertainty = 0
    uncertainty2 = 0
    avgmed = 0
    has_left = left_summary is not None
    has_above = above_summary is not None
    if has_left or has_above:
        px = pixels.astype(np.int64)
        estimates = []
        if has_left:
            a = px[0::8] + 1024
            pixel_delta = px[0::8] - px[1::8]
            half = np.sign(pixel_delta) * (np.abs(pixel_delta) >> 1)
            b = left_summary[0:8].astype(np.int64) - half
            est = (b - a).astype(np.int16).astype(np.int64)
            estimates.append(est)
        if has_above:
            a = px[0:8] + 1024
            pixel_delta = px[0:8] - px[8:16]
            half = np.sign(pixel_delta) * (np.abs(pixel_delta) >> 1)
            b = above_summary[8:16].astype(np.int64) - half
            est = (b - a).astype(np.int16).astype(np.int64)
            estimates.append(est)
        dc_estimates = np.concatenate(estimates)
        min_dc = int(dc_estimates.min())
        max_dc = int(dc_estimates.max())
        if len(estimates) == 2:
            avg_h = int(estimates[0].sum())
            avg_v = int(estimates[1].sum())
        else:
            avg_h = avg_v = int(estimates[0].sum())
        overall_avg = (avg_h + avg_v) >> 1
        avgmed = overall_avg
        uncertainty = (max_dc - min_dc) >> 3
        avg_h -= avgmed
        avg_v -= avgmed
        far_afield_value = avg_v
        if abs(avg_h) < abs(avg_v):
            far_afield_value = avg_h
        uncertainty2 = far_afield_value >> 3
    predicted = (trunc_div(avgmed, int(q[0])) + 4) >> 3
    return predicted, uncertainty, uncertainty2, pixels


def adv_predict_or_unpredict_dc(saved_dc: int, recover_original: bool,
                                predicted_val: int) -> int:
    """DC delta wraparound (model.hh:823-832)."""
    max_value = 1 << (C.MAX_EXPONENT - 1)
    min_value = -max_value
    adjustment_factor = 2 * max_value + 1
    retval = saved_dc + (predicted_val if recover_original else -predicted_val)
    if retval < min_value:
        retval += adjustment_factor
    if retval > max_value:
        retval -= adjustment_factor
    return retval
