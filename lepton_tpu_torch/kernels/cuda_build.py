"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source csrc/<name>.cu with a plain C interface, compiled
for sm_90a into build/lib<name>.so at first use (or ahead of time with
build()); the headers csrc/*.cuh are shared.  Nothing here runs at import
time, so the CPU tests import every module without a CUDA toolchain.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable

from .._native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each build
ptxas_report: Dict[str, str] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    return (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")


def stale(name: str) -> bool:
    """True when build/lib<name>.so is missing or older than its sources."""
    so = so_path(name)
    if not os.path.exists(so):
        return True
    deps = [source(name)] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile each csrc/<name>.cu into build/lib<name>.so, one nvcc per
    source, all started together; each goes to a temporary name first and
    is renamed when done.  Returns the seconds each build took."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    try:
        for name in names:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, tmp)
        took = {}
        for name, (proc, tmp) in jobs.items():
            _, err = proc.communicate()
            took[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source(name)}:\n{err[-4000:]}")
            ptxas_report[name] = err
            os.replace(tmp, so_path(name))
        return took
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """The kernel library, built first if it is missing or older than its
    sources."""
    with _lock:
        if name not in _libs:
            if stale(name):
                build([name])
            _libs[name] = ctypes.CDLL(so_path(name))
        return _libs[name]


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter (wrapper.<attr>).  The
    mesh routes (parallel/mesh.py) launch from one thread a device, so the
    add holds a lock."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
