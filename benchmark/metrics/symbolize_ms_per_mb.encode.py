"""symbolize_ms_per_mb.encode: the stats' symbolize_s summed over the
window's batch encodes, over their JPEG MB."""
from benchmark.metrics._common import ms_per_mb


def read(run):
    return ms_per_mb(run, "encode", "symbolize_s", 1e3)
