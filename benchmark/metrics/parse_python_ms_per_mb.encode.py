"""parse_python_ms_per_mb.encode: the parse's time outside the native
Huffman scan decodes, the stats' parse_s less huffman_s (the program's
spans parse and parse.huffman), summed over the window's batch encodes
that carry both, over their JPEG MB: the parse's time holding the GIL."""


def read(run):
    reqs = [r for r in run.of("encode")
            if all(isinstance(r.stats.get(k), (int, float))
                   for k in ("parse_s", "huffman_s"))]
    mb = sum(run.jpeg_mb(r) for r in reqs)
    if not reqs or not mb:
        return None
    return sum((r.stats["parse_s"] - r.stats["huffman_s"]) * 1e3
               for r in reqs) / mb
