"""The traced run's device trace, and the host spans that name its gaps.

Tracer runs torch.profiler (CPU and CUDA activity) over the measured
window.  In that window the benchmark opens its own host spans: one around
each call into the program's entry points (the traffic drivers), and one
around each call into a layer, by wrapping the program's layer functions
that benchmark/spans.json lists (module:attribute, by layer name) for as
long as the trace runs.  A listed function the program no longer has is
left out and named on stderr.

reduce() is the busy-share arithmetic of chip_smoke.trace_device (the
union of the device intervals) as of the benchmark's first commit, and
adds what the result line's breakdown carries: the device operations by
time, and the idle gaps between device operations by the innermost host
span open over them.
"""
from __future__ import annotations

import bisect
import functools
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX = "bench:"
OUTSIDE = "outside any span"
TOP = 10


def span(name: str):
    """A host span of the trace (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(PREFIX + name)


def _wrap(fn, name: str):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


class Tracer:
    """torch.profiler over a window, with the layer spans of spans.json."""

    def __init__(self, spans_file: str = os.path.join(HERE, "spans.json")):
        with open(spans_file) as f:
            self.targets = json.load(f)
        self.wrapped = []
        self.prof = None

    def _wrap_layers(self) -> None:
        for name, targets in self.targets.items():
            for target in targets:
                module_name, attr = target.split(":")
                try:
                    module = importlib.import_module(module_name)
                    fn = getattr(module, attr)
                except (ImportError, AttributeError) as e:
                    print(f"trace: no span {name} at {target} ({e})",
                          file=sys.stderr)
                    continue
                setattr(module, attr, _wrap(fn, name))
                self.wrapped.append((module, attr, fn))

    def _unwrap(self) -> None:
        for module, attr, fn in reversed(self.wrapped):
            setattr(module, attr, fn)
        self.wrapped = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._wrap_layers()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        try:
            self.prof.stop()
        finally:
            self._unwrap()
        return reduce(rows(self.prof), wall)


def rows(prof) -> list:
    """(start us, end us, name, on the device, is a host span's copy) of
    each traced event, read from the profiler's raw results: building its
    FunctionEvent tree takes minutes on a window of a hundred thousand
    events."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        note = getattr(e, "is_user_annotation", None)
        out.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                    e.device_type() == DeviceType.CUDA,
                    bool(note()) if note else False))
    return out


def _union(spans) -> list:
    """The union of (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _flatten(spans, lo: float, hi: float) -> list:
    """Nested (start, end, name) spans as (start, end, innermost name)
    pieces that tile [lo, hi]; time under no span is OUTSIDE."""
    pieces, stack, cur = [], [], lo
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if end > cur:
                pieces.append((cur, end, top))
                cur = end
        if s > cur:
            pieces.append((cur, s, stack[-1][1] if stack else OUTSIDE))
            cur = s
        stack.append((e, name))
    while stack:
        end, top = stack.pop()
        if end > cur:
            pieces.append((cur, end, top))
            cur = end
    if hi > cur:
        pieces.append((cur, hi, OUTSIDE))
    return pieces


def _attribute(gaps, pieces) -> dict:
    """Seconds of each name's pieces that the gaps cover (both sorted and
    each free of overlaps within itself); times in microseconds."""
    by_name = {}
    starts = [p[0] for p in pieces]
    for a, b in gaps:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, name = pieces[i]
            cover = min(b, e) - max(a, s)
            if cover > 0:
                by_name[name] = by_name.get(name, 0.0) + cover / 1e6
            i += 1
    return by_name


def reduce(events, wall_s: float) -> dict:
    """busy_s (the union of the device intervals), window_s (the traced
    window's wall), the device operations' seconds by name (top TOP) and
    the idle gaps' seconds by the innermost host span open over them (top
    TOP), from rows(); busy_s None where the trace holds no device time."""
    # a host span's copy on the device's timeline is no device operation
    device = [(a, b, name) for a, b, name, cuda, note in events
              if cuda and not note and not name.startswith(PREFIX)]
    out = {"busy_s": None, "window_s": wall_s, "device_ops": [],
           "idle_gaps": []}
    if not device:
        return out
    busy = _union((a, b) for a, b, _ in device)
    out["busy_s"] = sum(b - a for a, b in busy) / 1e6
    ops = {}
    for a, b, name in device:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    out["device_ops"] = [[k, v] for k, v in sorted(
        ops.items(), key=lambda kv: -kv[1])[:TOP]]
    host = [(a, b, name[len(PREFIX):]) for a, b, name, cuda, _ in events
            if not cuda and name.startswith(PREFIX)]
    lo = min(e[0] for e in events)
    hi = max(e[1] for e in events)
    gaps = ([(lo, busy[0][0])]
            + [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
            + [(busy[-1][1], hi)])
    by_name = _attribute([g for g in gaps if g[1] > g[0]],
                         _flatten(_nested(host), lo, hi))
    out["idle_gaps"] = [[k, v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    return out


def _nested(spans) -> list:
    """Spans that nest: a span that overlaps an earlier one without lying
    inside it (another thread's) is dropped."""
    out, stack = [], []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1] <= s:
            stack.pop()
        if stack and e > stack[-1]:
            continue
        stack.append(e)
        out.append((s, e, name))
    return out
