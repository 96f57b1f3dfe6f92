"""decode_mbps: JPEG MB that api.batch_decompress_device gave back in the
window, over the window (host clock)."""
from benchmark.metrics._common import mbps


def read(run):
    return mbps(run, "decode")
