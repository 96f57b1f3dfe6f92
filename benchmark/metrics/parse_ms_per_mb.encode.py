"""parse_ms_per_mb.encode: the stats' parse_s (host parse and Huffman
decode) summed over the window's batch encodes, over their JPEG MB."""
from benchmark.metrics._common import ms_per_mb


def read(run):
    return ms_per_mb(run, "encode", "parse_s", 1e3)
