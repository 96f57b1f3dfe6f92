"""Stage-level timing harness (reference TimingHarness, jpgcoder.hh:25-56).

The reference records one first-write-wins microsecond timestamp per
(stage, thread) cell in a 20-stage x MAX_NUM_THREADS matrix and prints
it at exit; this is that matrix, plus a span summary derived from
*_BEGIN/_END event pairs.  Enabled via LEPTON_TIMING or the -timing=
flag (cli); survives the jail (pure userspace clock reads).

The matrix and print_timing are a copy of lepton_tpu/util/timing.py.  The
port adds the one carrier of a device call's stage times, the open call (a
context variable): call() opens an entry point's call, part() a part of it
with a dict of its own, in_call() carries it onto a pool thread.  span()
adds a stage's seconds to a key of the call's stats, add() a count,
timed() a launch's CUDA-event ms; outside a call they write nothing.  A
span also marks NAME_BEGIN/NAME_END (and a reference stage's
_STARTED/_FINISHED) for -timing=, and, while torch.profiler records, opens
a record_function range "lepton:NAME".  No torch import: the profiler and
CUDA events are read through sys.modules, so the host path never loads it.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

# the reference's exact stage vocabulary (jpgcoder.hh:26-46)
STAGES = [
    "TS_MAIN", "TS_MODEL_INIT_BEGIN", "TS_MODEL_INIT", "TS_ACCEPT",
    "TS_THREAD_STARTED", "TS_READ_STARTED", "TS_READ_FINISHED",
    "TS_JPEG_DECODE_STARTED", "TS_JPEG_DECODE_FINISHED",
    "TS_STREAM_MULTIPLEX_STARTED", "TS_STREAM_MULTIPLEX_FINISHED",
    "TS_THREAD_WAIT_STARTED", "TS_THREAD_WAIT_FINISHED",
    "TS_ARITH_STARTED", "TS_ARITH_FINISHED",
    "TS_JPEG_RECODE_STARTED", "TS_JPEG_RECODE_FINISHED",
    "TS_STREAM_FLUSH_STARTED", "TS_STREAM_FLUSH_FINISHED", "TS_DONE",
]
_STAGE_IDX = {n: i for i, n in enumerate(STAGES)}
MAX_THREADS = 8

# first-write-wins timestamp matrix [thread][stage], 0.0 = unset
_matrix: List[List[float]] = [[0.0] * len(STAGES)
                              for _ in range(MAX_THREADS)]
_events: List[Tuple[str, float]] = []
_enabled = bool(os.environ.get("LEPTON_TIMING"))


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


# span-event cap: a long-lived serving process with timing enabled must
# not grow the event log without bound (the first-write-wins matrix --
# the reference's semantics -- is fixed-size and unaffected)
_MAX_EVENTS = 1 << 20


def mark(stage: str, thread: int = 0) -> None:
    if not _enabled:
        return
    now = time.perf_counter()
    i = _STAGE_IDX.get(stage)
    if i is not None and 0 <= thread < MAX_THREADS \
            and _matrix[thread][i] == 0.0:
        _matrix[thread][i] = now
    if len(_events) < _MAX_EVENTS:
        _events.append((stage, now))


def print_timing(file=None) -> None:
    """Reference print_results format: STAGE (thread) seconds-from-
    first, per populated cell, followed by the span summary."""
    file = file or sys.stderr
    cells = [(t, i, ts) for t in range(MAX_THREADS)
             for i, ts in enumerate(_matrix[t]) if ts > 0.0]
    if not cells and not _events:
        return
    t0 = min([ts for _, _, ts in cells]
             + [t for _, t in _events[:1]])
    for t in range(MAX_THREADS):
        for i, name in enumerate(STAGES):
            ts = _matrix[t][i]
            if ts > 0.0:
                file.write(f"{name}\t({t})\t{ts - t0:.6f}\n")
    spans: Dict[str, float] = {}
    # spans of one name may overlap (pool threads): a sum of ends less
    # begins is their total whichever begin an end is paired with
    begins: Dict[str, List[float]] = {}
    for name, t in _events:
        if name.endswith("_BEGIN"):
            begins.setdefault(name[:-6], []).append(t)
        elif name.endswith("_END") and begins.get(name[:-4]):
            base = name[:-4]
            spans[base] = spans.get(base, 0.0) + (t - begins[base].pop())
    for name, dt in sorted(spans.items(), key=lambda kv: -kv[1]):
        file.write(f"  [{name}] {dt * 1e3:.2f} ms\n")


def reset() -> None:
    _events.clear()
    for row in _matrix:
        for i in range(len(row)):
            row[i] = 0.0


def snapshot():
    """Capture the matrix + event log, so a scoped activity (e.g. the
    pre-jail warm-up roundtrip) can be discarded with restore() without
    also wiping marks recorded before it (TS_MAIN, read stages)."""
    return [row[:] for row in _matrix], _events[:]


def restore(snap) -> None:
    matrix, events = snap
    for row, src in zip(_matrix, matrix):
        row[:] = src
    _events[:] = events


# the open call of this context: (its stats dict, its call id, its deferred
# CUDA events)
_call: contextvars.ContextVar = contextvars.ContextVar("lepton_call",
                                                       default=None)
_call_ids = itertools.count(1)
_profiler = None        # torch.autograd.profiler, once torch is loaded
PREFIX = "lepton:"


def _recording():
    """torch.autograd.profiler while torch.profiler records, else None."""
    global _profiler
    if _profiler is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        _profiler = torch.autograd.profiler
    return _profiler if _profiler._is_profiler_enabled else None


def add(key: str, value) -> None:
    """Add value to the open call's stats[key] (nothing outside a call)."""
    c = _call.get()
    if c is not None:
        c[0][key] = c[0].get(key, 0) + value


def in_call(fn):
    """fn made to run on a pool thread as a part of the call open on this
    thread: each run has the call's id and a stats dict of its own, and
    returns (fn's result or None, the exception it raised or None, that
    dict), which this thread then adds to the call's stats.  So no two
    threads write one dict, and no update is lost."""
    c = _call.get()

    def run(*args):
        own = {}
        token = _call.set(None if c is None else (own, c[1], []))
        try:
            return fn(*args), None, own
        except Exception as e:
            return None, e, own
        finally:
            _call.reset(token)
    return run


def timed(fn, dev, key: str, host: bool = False, name: Optional[str] = None,
          defer: bool = False):
    """fn(), with its time in ms added to the open call's stats[key]: by
    CUDA events around it on a CUDA device, then a wait for the end event;
    off the card by the host clock where host is True, else not at all.
    Outside a call fn() alone, with no event.  defer: the events are kept
    with the call in place of the wait, and settle() adds their time once
    the caller has synchronised.  name: a span around fn."""
    if name is not None:
        with span(name):
            return timed(fn, dev, key, host, defer=defer)
    c = _call.get()
    if c is None or (dev.type != "cuda" and not host):
        return fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        r = fn()
        add(key, (time.perf_counter() - t) * 1e3)
        return r
    cuda = sys.modules["torch"].cuda
    start = cuda.Event(enable_timing=True)
    end = cuda.Event(enable_timing=True)
    start.record()
    r = fn()
    end.record()
    if defer:
        c[2].append((key, start, end))
    else:
        end.synchronize()
        add(key, start.elapsed_time(end))
    return r


def settle() -> None:
    """Add the time of the open call's deferred events (timed) to its
    stats, by key; their work must have ended."""
    c = _call.get()
    if c is not None:
        for key, start, end in c[2]:
            add(key, start.elapsed_time(end))
        c[2].clear()


class span:
    """One stage on the thread that opens it: adds its host-clock seconds
    to the open call's stats[key] (no key or no call, no write), marks
    NAME_BEGIN/NAME_END and the reference stage's
    STAGE_STARTED/STAGE_FINISHED under -timing=, and while torch.profiler
    records opens record_function("lepton:" + name) with the args
    "call=<id>" and "image=<i>".  Under -timing= a span with `args`
    ("k=v ...", a scan's number and kind, say) marks "NAME ARGS", so that
    its summary line tells such spans apart; the profiler's range keeps
    NAME alone (it drops a range's args string)."""

    __slots__ = ("name", "key", "stage", "image", "stats", "args", "_rf",
                 "_t")

    def __init__(self, name: str, key: Optional[str] = None,
                 stage: Optional[str] = None, image: Optional[int] = None,
                 args: Optional[str] = None):
        self.name, self.key, self.stage = name, key, stage
        self.image, self.args, self._rf = image, args, None

    def _label(self) -> str:
        return f"{self.name} {self.args}" if self.args else self.name

    def __enter__(self):
        c = _call.get()
        self.stats = None if c is None else c[0]
        if _enabled:
            mark(self._label() + "_BEGIN")
            if self.stage:
                mark(self.stage + "_STARTED")
        prof = _recording()
        if prof is not None:
            args = [] if c is None else [f"call={c[1]}"]
            if self.image is not None:
                args.append(f"image={self.image}")
            self._rf = prof.record_function(PREFIX + self.name,
                                            " ".join(args) or None)
            self._rf.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if _enabled:
            if self.stage:
                mark(self.stage + "_FINISHED")
            mark(self._label() + "_END")
        if self.key is not None and self.stats is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + dt
        return False


class part:
    """A part of the call open on this thread (of a new call where none
    is open) whose spans, counters and clocks write into `stats`; it opens
    no span.  A mesh's device thread opens one with its own dict, and so
    does a caller that times a stage below the entry points."""

    __slots__ = ("stats", "id", "_token")

    def __init__(self, stats: dict):
        c = _call.get()
        self.stats, self.id = stats, next(_call_ids) if c is None else c[1]

    def __enter__(self):
        self._token = _call.set((self.stats, self.id, []))
        return self

    def __exit__(self, *exc):
        _call.reset(self._token)
        return False


class call(part):
    """A device entry point's call: its stats dict and a new call id for
    the spans inside it (on this thread and in this context), under the
    span entry.<entry>."""

    __slots__ = ("_span",)

    def __init__(self, stats: dict, entry: str):
        self.stats, self.id = stats, next(_call_ids)
        self._span = span("entry." + entry)

    def __enter__(self):
        super().__enter__()
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._span.__exit__(*exc)
        finally:
            super().__exit__(*exc)
        return False
