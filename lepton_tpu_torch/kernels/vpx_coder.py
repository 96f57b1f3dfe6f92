"""Phase B: per-segment adaptive VPX bool coding, in two stages.

Port of lepton_tpu/kernels/pallas_coder.py (_coder_kernel :44-173 and its
host side encode_streams_pallas / finalize :176-235), in the shape of the
JAX package's main path (_twopass_fused_jit, batch_encode.py:242-264):

  1. the probability stage, kernels/branch_probs.py (vpx_scan
     .model_probs_sorted): each symbol's probability, all branches at once;
  2. the walk, vpx_walk (vpx_scan.arith_pass): vpx_write over each lane's
     (probability, bit) stream, one serial coder a lane in registers.  Its
     kernel is csrc/vpx_coder.cu, built with nvcc at first use into build/
     and bound with ctypes (kernels/cuda_build.py).

encode_streams chains the two; each stage launches its kernel for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.
encode_streams_plain is the whole function's plain version, a lockstep
walk over a model arena per lane, independent of the grouping.

Symbol encoding (vpx_scan.py:29-30): idx >= 0 -> adaptive branch in the
model arena; idx == FIXED_PROB -> probability 128, no model update
(marker/stop bits); idx == PAD -> no-op lane padding.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from ..model.tables import ARENA_SIZE
from ..util import timing
from . import branch_probs as bp
from . import cuda_build

PAD = -1
FIXED_PROB = -2

_lib = None
_lock = threading.Lock()


def build_symbol_streams(segments):
    """Pad per-segment (idx, bit) arrays into [S, L] with the marker bit
    prepended and the 32 stop bits appended (vpx_start/stop_encode).
    Copy of lepton_tpu/kernels/vpx_scan.py::build_symbol_streams."""
    full = []
    for idx, bit in segments:
        idx = np.asarray(idx, dtype=np.int32)
        bit = np.asarray(bit, dtype=np.uint8)
        fi = np.concatenate([[FIXED_PROB], idx,
                             np.full(32, FIXED_PROB, dtype=np.int32)])
        fb = np.concatenate([[0], bit, np.zeros(32, dtype=np.uint8)])
        full.append((fi, fb))
    L = max(len(i) for i, _ in full)
    S = len(full)
    idxs = np.full((S, L), PAD, dtype=np.int32)
    bits = np.zeros((S, L), dtype=np.uint8)
    for s, (i, b) in enumerate(full):
        idxs[s, :len(i)] = i
        bits[s, :len(b)] = b
    return idxs, bits


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("vpx_coder")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.vpx_walk_launch.argtypes = [p, p, p, i64, i64, p, i64, p, p]
            lib.vpx_walk_launch.restype = i
            lib.vpx_walk_error_string.argtypes = [i]
            lib.vpx_walk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_low(idx: torch.Tensor) -> None:
    """The coder's own check; the probability stage checks the rest."""
    if idx.numel() and int(idx.min()) < FIXED_PROB:
        raise ValueError(f"idx must lie in [{FIXED_PROB}, {ARENA_SIZE})")


def default_cap(L: int) -> int:
    """Initial output bytes per lane (pallas_coder.py:188-190)."""
    return max(2048, L // 4 + 2048)


def encode_streams(idx: torch.Tensor, bit: torch.Tensor,
                   template: Optional[torch.Tensor] = None):
    """Encode S padded symbol streams idx int32 [S, L], bit uint8 [S, L].

    template: optional int32 [ARENA_SIZE] start arena in the coder layout
    (model.tables.arena_from_template); default: every branch (1, 1, 128).
    Returns (bytes uint8 [S, cap], nbytes int32 [S]) on the input's device,
    with nbytes <= cap.  The probability stage runs once; the walk reruns
    alone when a lane outgrows cap.  Stats of the open call: the
    probability stage's (branch_probs) and, on CUDA tensors, walk_ms."""
    _check_low(idx)
    probs, _ = bp.branch_probs(idx, bit, template, "vpx")
    return timing.timed(lambda: vpx_walk(idx, bit, probs), idx.device,
                        "walk_ms", name="coder.walk")


def vpx_walk(idx: torch.Tensor, bit: torch.Tensor, probs: torch.Tensor):
    """vpx_write over each lane's (probs, bit), PAD slots (idx == PAD)
    skipped: probs uint8 [S, L] as branch_probs gives them.  Returns
    (bytes uint8 [S, cap], nbytes int32 [S]), cap at least default_cap(L)
    and at least the longest lane.  CUDA tensors run the kernel,
    relaunched alone with a larger buffer while a lane overflows; CPU
    tensors run the plain version."""
    if idx.dim() != 2 or bit.shape != idx.shape or probs.shape != idx.shape:
        raise ValueError("idx, bit and probs must all be [S, L]")
    if (idx.dtype != torch.int32 or bit.dtype != torch.uint8
            or probs.dtype != torch.uint8):
        raise TypeError("idx must be int32, bit and probs uint8")
    if bit.device != idx.device or probs.device != idx.device:
        raise ValueError("idx, bit and probs must be on one device")
    S, L = idx.shape
    cap = default_cap(L)
    if idx.device.type == "cpu":
        return bp.grow(lambda c: vpx_walk_plain(idx, bit, probs, c), cap)
    if idx.device.type != "cuda":
        raise ValueError(f"no VPX coder for device {idx.device}")
    dev = idx.device
    if S == 0:
        return (torch.empty((0, cap), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    idx, bit, probs = idx.contiguous(), bit.contiguous(), probs.contiguous()
    lib = _get_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(c):
        out = torch.empty((S, c), dtype=torch.uint8, device=dev)
        nbytes = torch.empty(S, dtype=torch.int32, device=dev)
        with cuda_build.bounds(lib, stream):
            err = lib.vpx_walk_launch(idx.data_ptr(), bit.data_ptr(),
                                      probs.data_ptr(), S, L, out.data_ptr(),
                                      c, nbytes.data_ptr(), stream)
            cuda_build.count_launch(vpx_walk)
            if err:
                raise RuntimeError("vpx_coder launch failed: "
                                   + lib.vpx_walk_error_string(err).decode())
        return out, nbytes

    return bp.grow(launch, cap)


vpx_walk.launches = 0


def vpx_walk_plain(idx: torch.Tensor, bit: torch.Tensor, probs: torch.Tensor,
                   cap: Optional[int] = None):
    """The walk kernel's plain PyTorch version: the arith_pass chain
    (vpx_scan.py:630-665) as a lockstep loop over symbol positions,
    vectorised over lanes, in int64 with & 0xFFFFFFFF for the uint32
    lowvalue.  Emitted bytes and their carry flags are recorded per step
    and the carries resolved on the host at the end, in emission order.
    Returns (bytes uint8 [S, cap], nbytes int32 [S]): with cap given, the
    bytes past it are dropped and nbytes still counts them, as the kernel
    does; by default cap is max(default_cap(L), the longest lane)."""
    S, L = idx.shape
    dev = idx.device
    i64 = torch.int64
    norm = torch.as_tensor(C.VPX_NORM, dtype=i64, device=dev)
    low = torch.zeros(S, dtype=i64, device=dev)
    rng = torch.full((S,), 255, dtype=i64, device=dev)
    count = torch.full((S,), -24, dtype=i64, device=dev)
    emits = torch.zeros((L, S), dtype=torch.bool, device=dev)
    bytes_ = torch.zeros((L, S), dtype=torch.uint8, device=dev)
    carries = torch.zeros((L, S), dtype=torch.bool, device=dev)
    valid_t = idx.t() != PAD
    bit_t = bit.t() != 0
    prob_t = probs.t().to(i64)
    for t in range(L):
        valid = valid_t[t]
        b = bit_t[t]
        split = 1 + (((rng - 1) * prob_t[t]) >> 8)
        low2 = torch.where(b, (low + split) & 0xFFFFFFFF, low)
        rng2 = torch.where(b, rng - split, split)
        shift = norm[rng2]
        count2 = count + shift
        emit = (count2 >= 0) & valid
        offset = shift - count2
        emits[t] = emit
        carries[t] = emit & (((low2 << torch.clamp(offset - 1, min=0))
                              >> 31) & 1).bool()
        bytes_[t] = ((low2 >> torch.clamp(24 - offset, 0, 31))
                     & 0xFF).to(torch.uint8)
        low_emit = ((low2 << torch.clamp(offset, min=0)) & 0xFFFFFF) \
            << torch.clamp(count2, min=0)
        low_noemit = (low2 << shift) & 0xFFFFFFFF
        low = torch.where(valid, torch.where(emit, low_emit, low_noemit), low)
        rng = torch.where(valid, rng2 << shift, rng)
        count = torch.where(valid, torch.where(emit, count2 - 8, count2),
                            count)

    emits, bytes_, carries = (x.t().cpu().numpy()
                              for x in (emits, bytes_, carries))
    nbytes = emits.sum(axis=1).astype(np.int32)
    if cap is None:
        cap = max(default_cap(L), int(nbytes.max()) if S else 0)
    out = np.zeros((S, cap), dtype=np.uint8)
    for s in range(S):
        bs = bytes_[s][emits[s]]
        for k in np.flatnonzero(carries[s][emits[s]]):
            # +1 at position k-1, rippling back through 0xFF bytes
            j = int(k) - 1
            while j >= 0 and bs[j] == 0xFF:
                bs[j] = 0
                j -= 1
            bs[j] += 1
        out[s, :min(len(bs), cap)] = bs[:cap]
    return (torch.from_numpy(out).to(dev),
            torch.from_numpy(nbytes).to(dev))


def encode_streams_plain(idx: torch.Tensor, bit: torch.Tensor,
                         template: Optional[torch.Tensor] = None):
    """The whole coder's plain PyTorch version, same contract as
    encode_streams: the probabilities of a lockstep walk over a model arena
    per lane (branch_probs.arena_probs_plain, no grouping), then
    vpx_walk_plain."""
    _check_low(idx)
    return vpx_walk_plain(idx, bit,
                          bp.arena_probs_plain(idx, bit, template, "vpx"))


def finalize(out: torch.Tensor, nbytes: torch.Tensor) -> List[bytes]:
    """Per-lane stream bytes plus the stop-byte rule (pallas_coder.py:228):
    a stream ending in 110xxxxx gets a trailing zero byte."""
    nb = nbytes.cpu().numpy()
    host = out[:, :int(nb.max())].cpu().numpy() if len(nb) else None
    streams = []
    for s, n in enumerate(nb):
        bs = host[s, :n].tobytes()
        if bs and (bs[-1] & 0xE0) == 0xC0:
            bs += b"\x00"
        streams.append(bs)
    return streams
