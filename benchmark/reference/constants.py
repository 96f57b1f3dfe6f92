"""Format-level constant tables shared by the whole codec.

These are *format constants* of the Lepton bitstream (reference:
src/vp8/model/jpeg_meta.hh, src/vp8/model/model.hh:35-47).  They are part of
the on-disk format contract: any implementation that wants bit-exact
interchange with lepton files must use identical tables.

Verbatim copy of lepton_tpu/constants.py: the port keeps its own host layers.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Model table shape parameters (reference model.hh:35-47 "TableParams")
# ---------------------------------------------------------------------------
MAX_EXPONENT = 11
BLOCK_TYPES = 2
NUM_NONZEROS_BINS = 10
BSR_BEST_PRIOR_MAX = 11
COEF_BANDS = 64
ENTROPY_NODES = 15
RESIDUAL_NOISE_FLOOR = 7
COEF_BITS = MAX_EXPONENT - 1
NUMERIC_LENGTH_MAX = 12

# ---------------------------------------------------------------------------
# Zigzag orderings (reference jpeg_meta.hh:13-45, aligned_block.hh)
# zigzag_to_raster[z] = raster index of the z'th zigzag coefficient
# raster_to_zigzag[r] = zigzag position of raster coefficient r
# ---------------------------------------------------------------------------
ZIGZAG_TO_RASTER = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

RASTER_TO_ZIGZAG = np.zeros(64, dtype=np.int32)
RASTER_TO_ZIGZAG[ZIGZAG_TO_RASTER] = np.arange(64, dtype=np.int32)

# The order in which the interior 7x7 coefficients are coded
# (reference jpeg_meta.hh:35 "unzigzag49"): raster index of the k'th coded
# 7x7 coefficient, k in [0, 49).
UNZIGZAG49 = np.array([
    9, 10,
    17, 25, 18, 11,
    12, 19, 26, 33, 41, 34,
    27, 20, 13, 14, 21, 28,
    35, 42, 49, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

# ---------------------------------------------------------------------------
# Fixed-point DCT basis tables (reference jpeg_meta.hh:48-70)
# ---------------------------------------------------------------------------
ICOS_BASE_8192_SCALED = np.array([
    8192,  8192,  8192,  8192,  8192,  8192,  8192,  8192,
    11363,  9633,  6436,  2260, -2260, -6436, -9633, -11363,
    10703,  4433, -4433, -10703, -10703, -4433,  4433, 10703,
    9633, -2260, -11363, -6436,  6436, 11363,  2260, -9633,
    8192, -8192, -8192,  8192,  8192, -8192, -8192,  8192,
    6436, -11363,  2260,  9633, -9633, -2260, 11363, -6436,
    4433, -10703, 10703, -4433, -4433, 10703, -10703,  4433,
    2260, -6436,  9633, -11363, 11363, -9633,  6436, -2260], dtype=np.int64)

ICOS_IDCT_LINEAR_8192_SCALED = np.array([
    1024,  1420,  1338,  1204,  1024,   805,   554,   283,
    1024,  1204,   554,  -283, -1024, -1420, -1338,  -805,
    1024,   805,  -554, -1420, -1024,   283,  1338,  1204,
    1024,   283, -1338,  -805,  1024,  1204,  -554, -1420,
    1024,  -283, -1338,   805,  1024, -1204,  -554,  1420,
    1024,  -805,  -554,  1420, -1024,  -283,  1338, -1204,
    1024, -1204,   554,   283, -1024,  1420, -1338,   805,
    1024, -1420,  1338, -1204,  1024,  -805,   554,  -283], dtype=np.int64)

# Frequency maxima per raster coefficient (reference model.hh:264-274)
FREQMAX = np.array([
    1024, 931, 985, 968, 1020, 968, 1020, 1020,
    932, 858, 884, 840, 932, 838, 854, 854,
    985, 884, 871, 875, 985, 878, 871, 854,
    967, 841, 876, 844, 967, 886, 870, 837,
    1020, 932, 985, 967, 1020, 969, 1020, 1020,
    969, 838, 878, 886, 969, 838, 969, 838,
    1020, 854, 871, 870, 1010, 969, 1020, 1020,
    1020, 854, 854, 838, 1020, 838, 1020, 838], dtype=np.int64)

# nonzero_to_bin[NUM_NONZEROS_BINS-1] row: maps a count 0..49 into a bin
# (reference jpeg_meta.hh:72, row index 9).
NONZERO_TO_BIN = np.array([
    0, 1, 2, 3, 4, 4, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8,
    8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9],
    dtype=np.int32)

# IDCT fixed-point constants (reference idct.cc:14-31 "idct_local")
W1 = 2841
W2 = 2676
W3 = 2408
W5 = 1609
W6 = 1108
W7 = 565
W1PW7 = W1 + W7
W1MW7 = W1 - W7
W2PW6 = W2 + W6
W2MW6 = W2 - W6
W3PW5 = W3 + W5
W3MW5 = W3 - W5
R2 = 181

# vpx_norm: leading-zero count LUT for a uint8 range value
# (reference boolwriter.hh:69-86)
VPX_NORM = np.zeros(256, dtype=np.int32)
VPX_NORM[0] = 0
for _v in range(1, 256):
    _n = 0
    _x = _v
    while _x < 128:
        _x <<= 1
        _n += 1
    VPX_NORM[_v] = _n
del _v, _n, _x

# Mux framing (reference src/io/MuxReader.hh)
MUX_MAX_STREAM_ID = 16
MUX_EOF_MARKER = bytes([0xFF, 0xFE, 0xFF])

# Container magic values (reference jpgcoder.cc:549-553)
LEPTON_HEADER = bytes([0xCF, 0x84])
ZLEPTON_HEADER = bytes([0xCE, 0xB6])
UJG_HEADER = b"UJ"

MAX_NUM_THREADS = 8


def bit_length(v: int) -> int:
    """Number of bits needed to represent non-negative v (0 -> 0)."""
    return int(v).bit_length()
