"""reemit_concurrency.decode_x: the native scan coder's seconds a second
of re-emit, the stats' recode_native_s (the program's spans
re-emit.native, summed over the threads they run on) over recode_s (the
span re-emit, the calling thread's wall), each summed over the window's
batch decodes that carry both: below 1.0 while requests are re-emitted
one after another (the merge and the loop between scans are outside the
native spans), up to the threads' count when they run at once."""


def read(run):
    reqs = [r for r in run.of("decode")
            if all(isinstance(r.stats.get(k), (int, float))
                   for k in ("recode_native_s", "recode_s"))]
    seconds = sum(r.stats["recode_s"] for r in reqs)
    if not seconds:
        return None
    return sum(r.stats["recode_native_s"] for r in reqs) / seconds
