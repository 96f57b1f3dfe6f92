"""The host's one thread pool, for the GIL-dropping native calls: the host
codec's segments, a batch encode's images and a batch decode's mode-X
requests, a job each.  At most 8 workers, one on a one-CPU host; its
threads are spawned before the jail (_warm_pool), and a forked child never
queues work on its parent's pool (_own_pool).  A job never waits on this
pool, which could leave every thread waiting: so a mode-Z re-emit, whose
segments take the pool, runs on the calling thread.
"""
from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from . import timing

_MAX_WORKERS = None
_POOL = None
_POOL_PID = None


def _own_pool():
    """The warm pool if this process spawned it.  A forked child (the
    jailed parse and host-fallback children) inherits the pool object but
    none of its threads, and work queued there would wait forever."""
    global _POOL
    if _POOL is not None and _POOL_PID != os.getpid():
        _POOL = None
    return _POOL


def _warm_pool() -> None:
    """Pre-spawn the worker pool with live stacks: thread creation mmaps a
    stack, which the stage-2 jail bans, so jailed transcodes must reuse
    threads spawned before the jail (the reference likewise spawns its
    GenericWorkers before installing seccomp, generic_worker.cc:97-100)."""
    global _MAX_WORKERS, _POOL, _POOL_PID
    if _MAX_WORKERS is None:
        _MAX_WORKERS = min(8, os.cpu_count() or 1)
    if _MAX_WORKERS <= 1 or _own_pool() is not None:
        return
    _POOL = ThreadPoolExecutor(max_workers=_MAX_WORKERS)
    _POOL_PID = os.getpid()
    barrier = threading.Barrier(_MAX_WORKERS + 1, timeout=10)

    def _spin():
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            pass

    futs = [_POOL.submit(_spin) for _ in range(_MAX_WORKERS)]
    try:
        barrier.wait()
    except threading.BrokenBarrierError:
        pass
    for f in futs:
        f.result()


def _workers(n: int) -> int:
    """The threads map runs n jobs on: at most 8, and one on a one-CPU
    host, where a pool only adds switches (the reference likewise lowers
    its worker count, jpgcoder.cc:3861-3945)."""
    global _MAX_WORKERS
    if _MAX_WORKERS is None:
        _MAX_WORKERS = min(8, os.cpu_count() or 1)
    return max(1, min(_MAX_WORKERS, n))


def map(fn, jobs, workers: Optional[int] = None) -> list:
    """[(fn(job) or None, the exception it raised or None)] of each job, in
    job order, run as parts of the call open on this thread: each job's
    stats are added to the call's, in job order (timing.in_call).  The
    jobs run at once on `workers` threads (default _workers(len(jobs))) of
    the warm pool, or of a pool made for them.  On one worker they run in
    turn on this thread, and the first that raises ends the map: the list
    stops at its (None, error)."""
    jobs = list(jobs)
    workers = _workers(len(jobs)) if workers is None else workers
    if workers == 1:
        done = []
        for job in jobs:
            try:
                done.append((fn(job), None))
            except Exception as e:
                return done + [(None, e)]
        return done
    own = _own_pool()
    with contextlib.nullcontext(own) if own is not None \
            else ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(timing.in_call(fn), jobs))
    for *_, part in parts:
        for key, value in part.items():
            timing.add(key, value)
    return [(got, err) for got, err, _ in parts]


def results(done) -> list:
    """The results of map's list, in job order; the first error raised."""
    for _, err in done:
        if err is not None:
            raise err
    return [got for got, _ in done]
