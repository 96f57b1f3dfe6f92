"""The adaptive probability model: ~720k branches in one flat arena.

Copy of lepton_tpu/model/tables.py (struct Model, reference
src/vp8/model/model.hh:60-156): the same table order, offsets and strides,
so a branch index means the same branch in both packages, and the scalar
codec's Model with save_model and load_model (:50-93).
"""
from __future__ import annotations

import numpy as np

from .. import constants as C

# (name, shape) in struct declaration order
TABLE_SHAPES = [
    ("nz_7x7", (C.BLOCK_TYPES, 26, 6, 32)),
    ("nz_1x8", (C.BLOCK_TYPES, 8, 8, 3, 4)),
    ("nz_8x1", (C.BLOCK_TYPES, 8, 8, 3, 4)),
    ("residual_noise", (C.BLOCK_TYPES, C.COEF_BANDS, 10, C.COEF_BITS)),
    ("residual_noise_dc", (C.NUMERIC_LENGTH_MAX, C.COEF_BITS)),
    ("residual_thresh", (C.BLOCK_TYPES, 1 << (1 + C.RESIDUAL_NOISE_FLOOR),
                         1 + C.RESIDUAL_NOISE_FLOOR, 1 << C.RESIDUAL_NOISE_FLOOR)),
    ("exp_7x7", (C.BLOCK_TYPES, C.NUM_NONZEROS_BINS, 49,
                 C.NUMERIC_LENGTH_MAX, C.MAX_EXPONENT)),
    ("exp_x", (C.BLOCK_TYPES, C.NUM_NONZEROS_BINS, 15,
               C.NUMERIC_LENGTH_MAX, C.MAX_EXPONENT)),
    ("exp_dc", (C.NUMERIC_LENGTH_MAX, 17, C.MAX_EXPONENT)),
    ("sign", (C.BLOCK_TYPES, 4, C.NUMERIC_LENGTH_MAX)),
]

TABLE_OFFSETS = {}
_off = 0
for _name, _shape in TABLE_SHAPES:
    TABLE_OFFSETS[_name] = _off
    _off += int(np.prod(_shape))
ARENA_SIZE = _off
del _off, _name, _shape

TABLE_STRIDES = {
    name: tuple(int(s) for s in
                np.cumprod((shape[1:] + (1,))[::-1])[::-1])
    for name, shape in TABLE_SHAPES
}


class Model:
    """Per-segment adaptive model state (each thread-segment owns a copy).

    The arena holds (false_count, true_count) pairs plus the cached
    probability byte, all reset to the identity (1, 1, 128) at segment start
    (reference lepton_codec.hh:173-181 reset_thread_model_state), or set to
    a trained template's bytes (LEPTON_COMPRESSION_MODEL).
    """

    __slots__ = ("raw", "arena")

    def __init__(self):
        # bytearray backing enables the fast scalar hot loop; the numpy view
        # shares the same memory for vectorized ops and serialization.
        self.raw = bytearray(ARENA_SIZE * 3)
        self.arena = np.frombuffer(self.raw, dtype=np.uint8).reshape(
            ARENA_SIZE, 3)
        self.reset()

    def reset(self):
        self.arena[:, 0] = 1
        self.arena[:, 1] = 1
        self.arena[:, 2] = 128

    def index(self, table: str, *idx: int) -> int:
        strides = TABLE_STRIDES[table]
        base = TABLE_OFFSETS[table]
        for i, s in zip(idx, strides):
            base += i * s
        return base


def save_model(model: Model, path: str) -> None:
    """Raw model dump (serialize_model, model.cc:205: struct bytes ==
    this arena layout)."""
    with open(path, "wb") as f:
        f.write(bytes(model.raw))


def load_model(model: Model, path: str) -> None:
    """load_model (model.cc:407): read raw branch bytes back."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) != len(model.raw):
        raise ValueError("model size mismatch")
    model.raw[:] = data


# one branch of the coder arena: fc | tc << 8 | prob << 16 (int32)
IDENTITY_BRANCH = 1 | (1 << 8) | (128 << 16)
