"""device_idle_pct.decode: the share of the traced window in which no
operation ran on the device (torch.profiler), in the batch-decode cells."""
from benchmark.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
