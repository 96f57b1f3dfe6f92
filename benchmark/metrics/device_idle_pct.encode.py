"""device_idle_pct.encode: the share of the traced window in which no
operation ran on the device (torch.profiler), in the batch-encode cells."""
from benchmark.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
