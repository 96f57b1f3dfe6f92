"""UJG raw-coefficient codec: the non-arithmetic baseline format.

Reference: SimpleComponentEncoder/Decoder (src/lepton/simple_{en,de}coder.*)
with the 'UJ' container magic.  The CMP payload is a 4-byte LE batch size
followed by per-component blocks of raw int16 coefficients in the
reference's "aligned" storage order, interleaved in 1600-block batches
round-robin by least component progress.

Copy of lepton_tpu/container/ujg.py (79 lines).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import constants as C

# The reference's SIMD-friendly within-block storage order
# (aligned_block.hh:31-42 aligned_to_raster): 49 interior coefs in lepton
# zigzag order, then DC, then the top row, then the left column.
ALIGNED_TO_RASTER = np.concatenate([
    C.UNZIGZAG49,
    np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 48, 56],
             dtype=np.int32)])
RASTER_TO_ALIGNED = np.zeros(64, dtype=np.int32)
RASTER_TO_ALIGNED[ALIGNED_TO_RASTER] = np.arange(64, dtype=np.int32)

BATCH_SIZE = 1600


def _least_progress_cmp(cur, target):
    cmp = 0
    progress = cur[0] / target[0] if target[0] else 1.0
    for i in range(1, len(target)):
        if target[0] and target[i] and cur[i] != target[i]:
            p = cur[i] / target[i]
            if p < progress:
                cmp = i
                progress = p
    return cmp


def encode_raw(planes: List[np.ndarray]) -> bytes:
    """Raw coefficient payload (simple_encoder.cc:16-52)."""
    out = bytearray()
    out += BATCH_SIZE.to_bytes(4, "little")
    aligned = [np.ascontiguousarray(
        p.reshape(-1, 64)[:, ALIGNED_TO_RASTER], dtype="<i2")
        for p in planes]
    target = [a.shape[0] for a in aligned]
    cur = [0] * len(planes)
    while True:
        cmp = _least_progress_cmp(cur, target)
        if cur[cmp] == target[cmp]:
            break
        n = min(BATCH_SIZE, target[cmp] - cur[cmp])
        out += aligned[cmp][cur[cmp]:cur[cmp] + n].tobytes()
        cur[cmp] += n
    return bytes(out)


def decode_raw(data: bytes, shapes) -> List[np.ndarray]:
    """Inverse of encode_raw; shapes = [(bcv, bch), ...]."""
    batch = int.from_bytes(data[:4], "little")
    pos = 4
    target = [h * w for h, w in shapes]
    cur = [0] * len(shapes)
    aligned = [np.zeros((t, 64), dtype="<i2") for t in target]
    while True:
        cmp = _least_progress_cmp(cur, target)
        if cur[cmp] == target[cmp]:
            break
        n = min(batch, target[cmp] - cur[cmp])
        nbytes = n * 128
        aligned[cmp][cur[cmp]:cur[cmp] + n] = np.frombuffer(
            data[pos:pos + nbytes], dtype="<i2").reshape(n, 64)
        pos += nbytes
        cur[cmp] += n
    return [a[:, RASTER_TO_ALIGNED].reshape(h, w, 64).astype(np.int16)
            for a, (h, w) in zip(aligned, shapes)]
