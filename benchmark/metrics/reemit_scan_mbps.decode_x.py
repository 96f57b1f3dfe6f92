"""reemit_scan_mbps.decode_x: the native scan coder's rate a CPU second,
the stats' recode_scan_bytes (the entropy-coded bytes of the scans that
the mode-X re-emit regenerated, before the merge) over recode_native_s
(the program's spans re-emit.native), each summed over the window's batch
decodes that carry both, 1e6 B to an MB."""


def read(run):
    reqs = [r for r in run.of("decode")
            if all(isinstance(r.stats.get(k), (int, float))
                   for k in ("recode_scan_bytes", "recode_native_s"))]
    seconds = sum(r.stats["recode_native_s"] for r in reqs)
    if not seconds:
        return None
    return sum(r.stats["recode_scan_bytes"] for r in reqs) / seconds / 1e6
