"""bulk_encode: one caller, a closed loop of api.batch_compress_device on
one batch of the cell's images (traffic: batch_images)."""
from __future__ import annotations

import time


def images_needed(traffic: dict) -> int:
    return traffic["batch_images"]


def _encode(ctx, batch):
    return lambda st: ctx.api.batch_compress_device(
        batch, ctx.num_segments, ctx.device, st, version=ctx.version,
        allow_progressive=ctx.allow_progressive)


def setup(ctx):
    batch = ctx.images
    warm = ctx.caller.call("encode", "lep", range(len(batch)),
                           _encode(ctx, batch))
    if warm.error:
        raise RuntimeError(f"the warm call failed: {warm.error}")
    return batch


def window(ctx, batch, seconds: float, records: list) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        records.append(ctx.caller.call("encode", "lep", range(len(batch)),
                                       _encode(ctx, batch)))
