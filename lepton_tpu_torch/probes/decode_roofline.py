"""Probes of the dependent chains a token read is made of, on the card.

Port of tools/decode_roofline.py (_mk_kernel :36-78, launched at :82 in
run): a dependent arena read-modify-write chain, the same chain K = 2, 4,
8 ways interleaved, a 12-op dependent ALU chain, and the two mixed (one
RMW then the 12 ALU ops, the shape of one decoder read).  The kernel is
csrc/decode_roofline.cu, built with nvcc at first use into build/ and
bound with ctypes (kernels/cuda_build.py); every chain runs on one thread,
with the arena in device memory (ROWS rows of 128 int32, 2 MB, the
decoders' case) or in shared memory (SHARED_ROWS rows, 128 KB).  probe
launches it for a CUDA device; probe_plain is the same arithmetic as a
plain loop, for a small n_iter, and what probe runs for the CPU.
chip_smoke.py times the chains and holds their checksums against
probe_plain.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..kernels import cuda_build

ROWS = 4096
SHARED_ROWS = 256           # 128 KB: the largest power of two under 227 KB
LANES = 128
IDENTITY = 0x010180
KINDS = {"rmw": 0, "alu": 1, "mixed": 2}
ALU_OPS = 12

_lib = None
_lock = threading.Lock()


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("decode_roofline")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.decode_roofline_launch.argtypes = [i, i, i, i, i, p, p, p]
            lib.decode_roofline_launch.restype = i
            lib.decode_roofline_error_string.argtypes = [i]
            lib.decode_roofline_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _rows(shared: bool) -> int:
    return SHARED_ROWS if shared else ROWS


def probe(kind: str, n_iter: int, K: int = 1, shared: bool = False,
          device="cuda") -> torch.Tensor:
    """Run one chain on the card: `kind` in KINDS, K interleaved chains
    (rmw only: 1, 2, 4 or 8), n_iter steps of each, the arena in shared
    memory or not.  Returns the checksum, int32 [1] on the device (the
    launch is asynchronous; time it with CUDA events).  device="cpu" runs
    probe_plain."""
    if kind not in KINDS or (K != 1 and (kind != "rmw" or K not in (2, 4, 8))):
        raise ValueError(f"no probe {kind!r} with K = {K}")
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.tensor([probe_plain(kind, n_iter, K, shared)],
                            dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no probe for device {dev}")
    lib = _get_lib()
    rows = _rows(shared)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    arena = None if shared or kind == "alu" else torch.empty(
        (rows, LANES), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with cuda_build.bounds(lib, stream, per_lane=False):
        rc = lib.decode_roofline_launch(
            KINDS[kind], K, int(shared), n_iter, rows,
            None if arena is None else arena.data_ptr(), out.data_ptr(),
            stream)
        probe.launches += 1
        if rc:
            raise RuntimeError("decode_roofline launch failed: "
                               + lib.decode_roofline_error_string(rc)
                               .decode())
    return out


probe.launches = 0


def _wrap32(v: int) -> int:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def probe_plain(kind: str, n_iter: int, K: int = 1,
                shared: bool = False) -> int:
    """The kernel's arithmetic as a plain loop on a CPU tensor arena:
    the checksum the probe's kernel writes."""
    rows = _rows(shared)
    arena = torch.full((rows, LANES), IDENTITY, dtype=torch.int32)

    def rmw(x, i):
        row, off = (x + i) & (rows - 1), x & (LANES - 1)
        v = int(arena[row, off])
        arena[row, off] = v + 1
        return (x + v) & 0xFFFF

    def alu(x, i):
        for _ in range(ALU_OPS):
            x = _wrap32(((x * 5) ^ (x >> 3)) + i)
        return x

    if kind == "rmw":
        xs = [7 * (k + 1) for k in range(K)]
        for i in range(n_iter):
            xs = [rmw(x, i) for x in xs]
        return _wrap32(sum(xs))
    x = 7
    for i in range(n_iter):
        if kind == "mixed":
            x = rmw(x, i)
        x = alu(x, i)
    return x
