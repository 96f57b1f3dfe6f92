"""reader_roofline_pct.decode: the least time of the reader's work by
bytes (roofline.reader_bytes: the stream bytes of the .lep inputs by their
mux, the blocks of their JPEGs) over the reader kernel's CUDA-event time
(the stats' vpx_decoder_ms), summed over the window's batch decodes."""
from benchmark.roofline import least_ms, reader_bytes


def read(run):
    least = ms = 0.0
    for r in run.of("decode"):
        kernel = r.stats.get("vpx_decoder_ms")
        if isinstance(kernel, list):
            kernel = sum(kernel)
        lanes = [run.lanes(i) for i in r.images]
        if not isinstance(kernel, (int, float)) or None in lanes:
            continue
        least += least_ms(reader_bytes(
            sum(len(b) for ls in lanes for b in ls),
            sum(run.blocks(i) for i in r.images)))
        ms += kernel
    return 100.0 * least / ms if ms else None
