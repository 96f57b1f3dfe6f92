"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source csrc/<name>.cu with a plain C interface, compiled
for sm_90a into build/lib<name>.so at first use (or ahead of time with
build()); the headers csrc/*.cuh are shared.  Nothing here runs at import
time, so the CPU tests import every module without a CUDA toolchain.

Every source also has a bounds-checked build, build/lib<name>_checked.so,
compiled from the same file with CHECKED_FLAGS added (csrc/checked.cuh:
each LEP_CHECK / LEP_OK site records the first index of a launch that
leaves its buffer).  load() takes it when LEPTON_TORCH_CHECKED_KERNELS=1
is set as the library is first loaded; the default build and its flags
are untouched by it.  In a checked build each wrapper launches inside
bounds(), which reads the record after the launch and raises
KernelBoundsError (sanitize.py card, chip_smoke.py phase 19).
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import re
import threading
import time
from typing import Dict, Iterable, Optional

from .._native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CHECKED_FLAGS = ["-DLEPTON_CHECKED", "-lineinfo"]
CHECKED_ENV = "LEPTON_TORCH_CHECKED_KERNELS"
# every kernel source of the port
SOURCES = ("branch_probs", "vpx_coder", "ans_coder", "vpx_decoder",
           "decode_roofline")

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each build, by
# library stem (variant())
ptxas_report: Dict[str, str] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
# one launch at a time a checked library, from its launch to its record
_bounds_locks: Dict[str, threading.Lock] = {}
_SITE = re.compile(r"\bLEP_(?:CHECK|OK)\((\w+),")


def checked() -> bool:
    """True when LEPTON_TORCH_CHECKED_KERNELS=1 asks for the checked
    builds."""
    return os.environ.get(CHECKED_ENV) == "1"


def _pick(is_checked: Optional[bool]) -> bool:
    return checked() if is_checked is None else is_checked


def variant(name: str, is_checked: Optional[bool] = None) -> str:
    """The library stem of a build of csrc/<name>.cu: name, or
    name_checked for the bounds-checked build (default: as
    LEPTON_TORCH_CHECKED_KERNELS says)."""
    return f"{name}_checked" if _pick(is_checked) else name


def nvcc_flags(is_checked: Optional[bool] = None) -> list:
    """NVCC_FLAGS, with CHECKED_FLAGS added for the checked build."""
    return NVCC_FLAGS + CHECKED_FLAGS if _pick(is_checked) else \
        list(NVCC_FLAGS)


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def so_path(name: str, is_checked: Optional[bool] = None) -> str:
    return os.path.join(BUILD_DIR, f"lib{variant(name, is_checked)}.so")


def check_sites(name: str) -> Dict[int, str]:
    """{line: site} of every bounds check in csrc/<name>.cu (each LEP_CHECK
    or LEP_OK call sits on one line; the device records __LINE__)."""
    with open(source(name)) as f:
        return {i: m.group(1) for i, text in enumerate(f, 1)
                for m in _SITE.finditer(text)}


class KernelBoundsError(RuntimeError):
    """A checked build's record of a launch's first index outside its
    buffer: the kernel, its check site (the source's file and line), the
    CTA (the lane, for a kernel of one CTA a lane) and thread, the index
    and the limit."""

    def __init__(self, kernel: str, line: int, cta: int, thread: int,
                 index: int, limit: int, per_lane: bool = True):
        self.kernel, self.line, self.cta, self.thread = (kernel, line, cta,
                                                         thread)
        self.index, self.limit = index, limit
        self.site = check_sites(kernel).get(line, "?")
        self.file = os.path.relpath(source(kernel),
                                    os.path.dirname(os.path.dirname(CSRC)))
        self.lane = cta if per_lane else None
        who = f"lane {cta}" if per_lane else f"CTA {cta}"
        super().__init__(
            f"{kernel}: index {index} outside [0, {limit}) at check "
            f"{self.site} ({self.file}:{line}), {who}, thread {thread}")


def _nvcc() -> str:
    return (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")


def stale(name: str, is_checked: Optional[bool] = None) -> bool:
    """True when build/lib<name>.so (or lib<name>_checked.so) is missing or
    older than its sources."""
    so = so_path(name, is_checked)
    if not os.path.exists(so):
        return True
    deps = [source(name)] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def build(names: Iterable[str], variants=None) -> Dict[str, float]:
    """Compile each csrc/<name>.cu into build/lib<name>.so, and for a
    variant True into build/lib<name>_checked.so, one nvcc a (source,
    variant), all started together; each goes to a temporary name first
    and is renamed when done.  variants: the builds of each source
    (default: the one LEPTON_TORCH_CHECKED_KERNELS asks for).  Returns the
    seconds each build took, by library stem (variant())."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    try:
        for name in names:
            for is_checked in (checked(),) if variants is None else variants:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen(
                    [_nvcc(), *nvcc_flags(is_checked), "-o", tmp,
                     source(name)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                jobs[(name, is_checked)] = (proc, tmp)
        took = {}
        for (name, is_checked), (proc, tmp) in jobs.items():
            _, err = proc.communicate()
            stem = variant(name, is_checked)
            took[stem] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source(name)} ({stem}):\n"
                    f"{err[-4000:]}")
            ptxas_report[stem] = err
            os.replace(tmp, so_path(name, is_checked))
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
    sources: the checked build when LEPTON_TORCH_CHECKED_KERNELS=1 (its
    lep_check_take declared, and lib.checked_name set), else the
    default one (lib.checked_name None)."""
    is_checked = checked()
    stem = variant(name, is_checked)
    with _lock:
        if stem not in _libs:
            if stale(name, is_checked):
                build([name], (is_checked,))
            lib = ctypes.CDLL(so_path(name, is_checked))
            lib.checked_name = name if is_checked else None
            if is_checked:
                lib.lep_check_take.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p]
                lib.lep_check_take.restype = ctypes.c_int
                _bounds_locks[name] = threading.Lock()
            _libs[stem] = lib
        return _libs[stem]


def take_violation(lib: ctypes.CDLL, stream: int,
                   per_lane: bool = True) -> Optional[KernelBoundsError]:
    """After a launch of a checked build on `stream`: wait for it, read and
    clear its record, and return the KernelBoundsError it holds (None when
    every index stayed inside its buffer)."""
    rec = (ctypes.c_longlong * 6)()
    rc = lib.lep_check_take(rec, stream)
    if rc:
        raise RuntimeError(f"{lib.checked_name}: reading the bounds record "
                           f"failed with CUDA error {rc}")
    hit, line, cta, thread, index, limit = rec
    if not hit:
        return None
    return KernelBoundsError(lib.checked_name, line, cta, thread, index,
                             limit, per_lane)


@contextlib.contextmanager
def bounds(lib: ctypes.CDLL, stream: int, per_lane: bool = True):
    """Around a wrapper's launch of `lib` on `stream`: nothing for a
    default build; for a checked build, one launch of the library at a
    time, and KernelBoundsError raised after the launch when its record
    holds a violation.  per_lane: the kernel runs one CTA a lane.  A
    library that load() did not give (a probe's own build) counts as a
    default build."""
    name = getattr(lib, "checked_name", None)
    if name is None:
        yield
        return
    with _bounds_locks[name]:
        yield
        e = take_violation(lib, stream, per_lane)
        if e is not None:
            raise e


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter (wrapper.<attr>).  The
    mesh routes (parallel/mesh.py) launch from one thread a device, so the
    add holds a lock."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
