"""Stage-level timing harness (reference TimingHarness, jpgcoder.hh:25-56).

The reference records one first-write-wins microsecond timestamp per
(stage, thread) cell in a 20-stage x MAX_NUM_THREADS matrix and prints
it at exit; this is that matrix, plus a span summary derived from
*_BEGIN/_END event pairs.  Enabled via LEPTON_TIMING or the -timing=
flag (cli); survives the jail (pure userspace clock reads).

Copy of lepton_tpu/util/timing.py (120 lines).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

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


class stage:
    """Context manager marking STAGE_BEGIN/STAGE_END edges."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        mark(self.name + "_BEGIN")
        return self

    def __exit__(self, *exc):
        mark(self.name + "_END")
        return False


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
    begins: Dict[str, float] = {}
    for name, t in _events:
        if name.endswith("_BEGIN"):
            begins[name[:-6]] = t
        elif name.endswith("_END") and name[:-4] in begins:
            base = name[:-4]
            spans[base] = spans.get(base, 0.0) + (t - begins.pop(base))
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
