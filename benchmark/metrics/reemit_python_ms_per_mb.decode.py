"""reemit_python_ms_per_mb.decode: the re-emit's time outside the native
segment pool and scan calls, the stats' recode_s less recode_native_s
(the program's spans re-emit and re-emit.native), summed over the
window's batch decodes that carry both, over their JPEG MB."""


def read(run):
    reqs = [r for r in run.of("decode")
            if all(isinstance(r.stats.get(k), (int, float))
                   for k in ("recode_s", "recode_native_s"))]
    mb = sum(run.jpeg_mb(r) for r in reqs)
    if not reqs or not mb:
        return None
    return sum((r.stats["recode_s"] - r.stats["recode_native_s"]) * 1e3
               for r in reqs) / mb
