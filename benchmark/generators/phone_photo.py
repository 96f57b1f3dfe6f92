"""12 MP phone photos: make_photo([seed, k], width, height, quality),
baseline, or progressive (libjpeg's simple progression, as PIL writes it)
where the configuration's images have "progressive": true."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..fixtures import make_photo

THREADS = 8       # photos made at once; each one's bytes are as alone


def make(spec: dict, seed: int, n: int) -> list:
    with ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(
            lambda k: make_photo([seed, k], spec["width"], spec["height"],
                                 spec["quality"],
                                 spec.get("progressive", False)),
            range(n)))
