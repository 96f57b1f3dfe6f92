"""coder_roofline_pct.encode: the least time of the coder's work by bytes
(roofline.coder_bytes: the stats' symbols, and the stream bytes and lanes
of the .lep outputs by their mux) over the coder's CUDA-event time (the
stats' coder_ms), summed over the window's batch encodes."""
from benchmark.roofline import coder_bytes, least_ms


def read(run):
    least = ms = 0.0
    for r in run.of("encode"):
        st = r.stats
        if not all(isinstance(st.get(k), (int, float))
                   for k in ("symbols", "coder_ms")):
            continue
        lanes = [run.lanes(i) for i in r.images]
        if None in lanes:
            continue
        least += least_ms(coder_bytes(
            st["symbols"], sum(len(b) for ls in lanes for b in ls),
            sum(map(len, lanes))))
        ms += st["coder_ms"]
    return 100.0 * least / ms if ms else None
