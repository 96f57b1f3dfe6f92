"""recode_ms_per_mb.decode: the stats' recode_s (the host Huffman
re-emit) summed over the window's batch decodes, over their JPEG MB."""
from benchmark.metrics._common import ms_per_mb


def read(run):
    return ms_per_mb(run, "decode", "recode_s", 1e3)
