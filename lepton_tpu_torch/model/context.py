"""Per-color derived quantization tables.

Copy of ColorTables from lepton_tpu/model/context.py (reference
model.hh:210-309 set_quantization_table).  The scalar context functions of
that module are not needed: the port computes contexts for all blocks at
once in kernels/contexts.py.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C


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
