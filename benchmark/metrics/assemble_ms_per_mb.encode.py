"""assemble_ms_per_mb.encode: the stats' assemble_s (lane assembly, the
program's span coder.lanes) summed over the window's batch encodes, over
their JPEG MB."""
from benchmark.metrics._common import ms_per_mb


def read(run):
    return ms_per_mb(run, "encode", "assemble_s", 1e3)
