"""Arithmetic that several metric readers share."""
from __future__ import annotations


def mbps(run, label: str):
    """JPEG MB of the window's requests of one label over the window."""
    reqs = [r for r in run.requests if r.label == label]
    if not reqs:
        return None
    return sum(run.jpeg_mb(r) for r in reqs if not r.error) / run.window_s


def ms_per_mb(run, label: str, key: str, scale: float):
    """A stats key summed over the requests of one label (times `scale`
    to ms), over their JPEG MB."""
    reqs = [r for r in run.of(label) if isinstance(r.stats.get(key),
                                                   (int, float))]
    mb = sum(run.jpeg_mb(r) for r in reqs)
    if not reqs or not mb:
        return None
    return sum(r.stats[key] * scale for r in reqs) / mb


def idle_pct(run):
    """The device's idle share of the traced window, from the trace."""
    t = run.trace
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
