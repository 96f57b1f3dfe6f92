"""d2h_gbps.decode: the planes' copy rate to the host, the stats'
d2h_bytes (coefficients and flags copied) over d2h_s (the program's span
reader.d2h), each summed over the window's batch decodes that carry both,
1e9 B to a GB."""


def read(run):
    reqs = [r for r in run.of("decode")
            if all(isinstance(r.stats.get(k), (int, float))
                   for k in ("d2h_bytes", "d2h_s"))]
    seconds = sum(r.stats["d2h_s"] for r in reqs)
    if not seconds:
        return None
    return sum(r.stats["d2h_bytes"] for r in reqs) / seconds / 1e9
