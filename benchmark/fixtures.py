"""The benchmark's images, made from the run's seed with numpy and PIL.

make_photo is a frozen copy of lepton_tpu_torch/bench.py's (:113 as of
the benchmark's first commit): the same pixels and the same JPEG bytes for
the same seed (benchmark/tests hold it to the original).  A
configuration's file names its generator, its sizes and its quality;
images() makes a cell's images from --seed with it.
"""
from __future__ import annotations

import io

import numpy as np


def _jpeg(pixels: np.ndarray, mode: str, quality: int,
          progressive: bool = False) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(pixels, mode).save(buf, "JPEG", quality=quality,
                                       subsampling=2, progressive=progressive)
    return buf.getvalue()


def make_photo(seed, w: int, h: int, quality: int = 90,
               progressive: bool = False, mode: str = "RGB") -> bytes:
    """A phone-photo-like JPEG (q90, 4:2:0): smooth gradients and shading,
    hard-edged patches, mild sensor noise, all from a numpy seed; baseline
    or progressive, RGB or (the same picture's three channels and their
    mean as K) CMYK."""
    rng = np.random.default_rng(seed)
    s = w / 4032.0
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        gx, gy, amp = rng.uniform(-70, 70, 3)
        fx, fy = rng.uniform(150, 700, 2) * s
        px, py = rng.uniform(0, 6.28, 2)
        img[..., c] = (128 + gx * xx / w + gy * yy / h
                       + amp * np.sin(xx / fx + px) * np.cos(yy / fy + py))
    for _ in range(60):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        ww, hh = (rng.integers(40, 900, 2) * s).astype(int) + 1
        img[y0:y0 + hh, x0:x0 + ww] += rng.uniform(-45, 45, 3).astype(
            np.float32)
    img += rng.normal(0, 5.0, (h, w, 3)).astype(np.float32)
    pixels = np.clip(img, 0, 255).astype(np.uint8)
    if mode == "CMYK":
        pixels = np.concatenate([pixels, pixels.mean(-1, keepdims=True,
                                                     dtype=np.float32)
                                 .astype(np.uint8)], -1)
    return _jpeg(pixels, mode, quality, progressive)


def image_seed(seed: int) -> int:
    """The run's seed as numpy takes it (any whole number, kept to 64
    bits)."""
    return int(seed) % (1 << 64)


def images(config: dict, seed: int, n: int) -> list:
    """The first n images of a configuration for this seed, made by the
    generator that its "images" entry names: benchmark/generators/<name>.py,
    whose make(spec, seed, n) returns the JPEG bytes."""
    import importlib
    spec = config["images"]
    gen = importlib.import_module(f"benchmark.generators.{spec['generator']}")
    return gen.make(spec, image_seed(seed), n)
