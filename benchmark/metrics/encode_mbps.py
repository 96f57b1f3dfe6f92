"""encode_mbps: JPEG MB that api.batch_compress_device took to .lep in
the window, over the window (host clock)."""
from benchmark.metrics._common import mbps


def read(run):
    return mbps(run, "encode")
