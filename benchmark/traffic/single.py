"""single: one caller, a closed loop that alternates one upload
(api.compress_device of image k) and one read (api.decompress_device of
the .lep of image k), k cycling over a pool of the cell's images
(traffic: pool_images).  The pool's .lep files are the program's, made in
set-up; the window's uploads of image k are held to them and to the
reference."""
from __future__ import annotations

import time


def images_needed(traffic: dict) -> int:
    return traffic["pool_images"]


def _upload(ctx, k):
    return lambda st: [ctx.api.compress_device(
        ctx.images[k], ctx.num_segments, ctx.device, version=ctx.version,
        allow_progressive=ctx.allow_progressive, stats=st)]


def _read(ctx, leps, k):
    return lambda st: [ctx.api.decompress_device(leps[k], ctx.device,
                                                 stats=st)]


def setup(ctx):
    leps = []
    for k in range(len(ctx.images)):
        made = ctx.caller.call("upload", "lep", [k], _upload(ctx, k))
        if made.error:
            raise RuntimeError(f"the set-up upload {k} failed: {made.error}")
        ctx.setup_records.append(made)
        leps.append(made.outputs[0])
    for k in range(min(len(leps), ctx.traffic["warm_reads"])):
        warm = ctx.caller.call("read", "jpeg", [k], _read(ctx, leps, k))
        if warm.error:
            raise RuntimeError(f"the warm read {k} failed: {warm.error}")
    return leps


def window(ctx, leps, seconds: float, records: list) -> None:
    end = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < end:
        records.append(ctx.caller.call("upload", "lep", [k],
                                       _upload(ctx, k)))
        records.append(ctx.caller.call("read", "jpeg", [k],
                                       _read(ctx, leps, k)))
        k = (k + 1) % len(leps)
