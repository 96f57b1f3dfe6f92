"""stage_ms_per_mb.encode: the stats' stage_s (the program's span
symbolize.stage: the host copies of the coefficients into pinned memory)
summed over the window's batch encodes, over their JPEG MB."""
from benchmark.metrics._common import ms_per_mb


def read(run):
    return ms_per_mb(run, "encode", "stage_s", 1e3)
