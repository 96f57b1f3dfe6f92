"""bulk_decode: one caller, a closed loop of api.batch_decompress_device
on the .lep files of one batch of the cell's images (traffic:
batch_images), which the program encodes in set-up."""
from __future__ import annotations

import time


def images_needed(traffic: dict) -> int:
    return traffic["batch_images"]


def _decode(ctx, leps):
    return lambda st: ctx.api.batch_decompress_device(leps, ctx.device, st)


def setup(ctx):
    made = ctx.caller.call(
        "encode", "lep", range(len(ctx.images)),
        lambda st: ctx.api.batch_compress_device(
            ctx.images, ctx.num_segments, ctx.device, st,
            version=ctx.version, allow_progressive=ctx.allow_progressive))
    if made.error:
        raise RuntimeError(f"the set-up encode failed: {made.error}")
    leps = made.outputs
    warm = ctx.caller.call("decode", "jpeg", range(len(leps)),
                           _decode(ctx, leps))
    if warm.error:
        raise RuntimeError(f"the warm call failed: {warm.error}")
    ctx.setup_records.append(made)
    return leps


def window(ctx, leps, seconds: float, records: list) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        records.append(ctx.caller.call("decode", "jpeg", range(len(leps)),
                                       _decode(ctx, leps)))
