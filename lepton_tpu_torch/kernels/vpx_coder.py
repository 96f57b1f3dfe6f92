"""Phase B: per-segment adaptive VPX bool coding, one serial coder per lane.

Port of lepton_tpu/kernels/pallas_coder.py (_coder_kernel :44-173 and its
host side encode_streams_pallas / finalize :176-235).  The kernel is
csrc/vpx_coder.cu, built with nvcc at first use into build/ and bound with
ctypes (kernels/cuda_build.py).  encode_streams launches it for CUDA
tensors and runs the plain PyTorch version, encode_streams_plain, only for
CPU tensors.

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
from ..model.tables import ARENA_SIZE, IDENTITY_BRANCH
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
            lib.vpx_coder_launch.argtypes = [p, p, i64, i64, p, p, i, p,
                                             i64, p, p]
            lib.vpx_coder_launch.restype = i
            lib.vpx_coder_error_string.argtypes = [i]
            lib.vpx_coder_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(idx: torch.Tensor, bit: torch.Tensor,
           template: Optional[torch.Tensor]) -> None:
    if idx.dim() != 2 or bit.shape != idx.shape:
        raise ValueError("idx and bit must both be [S, L]")
    if idx.dtype != torch.int32 or bit.dtype != torch.uint8:
        raise TypeError("idx must be int32 and bit uint8")
    if bit.device != idx.device:
        raise ValueError("idx and bit must be on one device")
    # the kernel indexes the arena with idx unchecked
    if idx.numel() and (int(idx.min()) < FIXED_PROB
                        or int(idx.max()) >= ARENA_SIZE):
        raise ValueError(f"idx must lie in [{FIXED_PROB}, {ARENA_SIZE})")
    if template is not None and (
            template.shape != (ARENA_SIZE,) or template.dtype != torch.int32
            or template.device != idx.device):
        raise ValueError(f"template must be int32 [{ARENA_SIZE}] on "
                         f"{idx.device}")


def default_cap(L: int) -> int:
    """Initial output bytes per lane (pallas_coder.py:188-190)."""
    return max(2048, L // 4 + 2048)


def encode_streams(idx: torch.Tensor, bit: torch.Tensor,
                   template: Optional[torch.Tensor] = None):
    """Encode S padded symbol streams idx int32 [S, L], bit uint8 [S, L].

    template: optional int32 [ARENA_SIZE] start arena in the coder layout
    (model.tables.arena_from_template); default: every branch (1, 1, 128).
    Returns (bytes uint8 [S, cap], nbytes int32 [S]) on the input's device,
    with nbytes <= cap: a lane that outgrows cap relaunches the kernel with
    room for it.  CUDA tensors run the kernel; CPU tensors run the plain
    version."""
    _check(idx, bit, template)
    if idx.device.type == "cpu":
        return encode_streams_plain(idx, bit, template)
    if idx.device.type != "cuda":
        raise ValueError(f"no VPX coder for device {idx.device}")
    idx, bit = idx.contiguous(), bit.contiguous()
    S, L = idx.shape
    dev = idx.device
    nbytes = torch.zeros(S, dtype=torch.int32, device=dev)
    cap = default_cap(L)
    if S == 0:
        return torch.empty((0, cap), dtype=torch.uint8, device=dev), nbytes
    lib = _get_lib()
    # scratch: one model arena per lane, filled by the kernel itself
    arena = torch.empty((S, ARENA_SIZE), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    while True:
        out = torch.empty((S, cap), dtype=torch.uint8, device=dev)
        err = lib.vpx_coder_launch(
            idx.data_ptr(), bit.data_ptr(), S, L,
            None if template is None else template.data_ptr(),
            arena.data_ptr(), ARENA_SIZE, out.data_ptr(), cap,
            nbytes.data_ptr(), stream)
        encode_streams.launches += 1
        if err:
            raise RuntimeError("vpx_coder launch failed: "
                               + lib.vpx_coder_error_string(err).decode())
        need = int(nbytes.max())
        if need <= cap:
            return out, nbytes
        cap = need


encode_streams.launches = 0


def _branch_update(fc, tc, obs):
    """Branch::record_obs_and_update (branch.hh:82-100) on int64 tensors of
    pre-observation counts; returns the packed fc | tc<<8 | prob<<16 with
    the prob wrapped to 8 bits like the host's uint8 store (the tc == 0
    corner that only templates reach yields 256)."""
    ovf = torch.where(obs, tc == 0xFF, fc == 0xFF)
    never = ovf & torch.where(obs, fc == 1, tc == 1)
    nfc = torch.where(obs, fc, fc + 1)
    ntc = torch.where(obs, tc + 1, tc)
    nprob = (nfc << 8) // (fc + tc + 1)
    hfc = torch.where(obs, (1 + fc) >> 1, 129)
    htc = torch.where(obs, 129, (1 + tc) >> 1)
    nfc = torch.where(ovf, hfc, nfc)
    ntc = torch.where(ovf, htc, ntc)
    nprob = torch.where(ovf, (hfc << 8) // (hfc + htc), nprob)
    nfc = torch.where(never, torch.where(obs, 1, 0xFF), nfc)
    ntc = torch.where(never, torch.where(obs, 0xFF, 1), ntc)
    nprob = torch.where(never, torch.where(obs, 0, 255), nprob)
    return nfc | (ntc << 8) | ((nprob & 0xFF) << 16)


def encode_streams_plain(idx: torch.Tensor, bit: torch.Tensor,
                         template: Optional[torch.Tensor] = None):
    """The kernel's plain PyTorch version, same contract as encode_streams.

    A lockstep loop over symbol positions, vectorized over segments, in
    int64 with & 0xFFFFFFFF for the uint32 lowvalue (like
    vpx_scan.encode_streams, vpx_scan.py:52-116).  Each step gathers and
    scatters one branch per lane of the [S, ARENA_SIZE] arena.  Emitted
    bytes and their carry flags are recorded per step, and the carries are
    resolved on the host at the end, in emission order."""
    _check(idx, bit, template)
    S, L = idx.shape
    dev = idx.device
    i64 = torch.int64
    if template is None:
        arena = torch.full((S, ARENA_SIZE), IDENTITY_BRANCH, dtype=i64,
                           device=dev)
    else:
        arena = template.to(i64).expand(S, ARENA_SIZE).clone()
    norm = torch.as_tensor(C.VPX_NORM, dtype=i64, device=dev)
    seg = torch.arange(S, device=dev)
    low = torch.zeros(S, dtype=i64, device=dev)
    rng = torch.full((S,), 255, dtype=i64, device=dev)
    count = torch.full((S,), -24, dtype=i64, device=dev)
    emits = torch.zeros((L, S), dtype=torch.bool, device=dev)
    bytes_ = torch.zeros((L, S), dtype=torch.uint8, device=dev)
    carries = torch.zeros((L, S), dtype=torch.bool, device=dev)
    idx_t = idx.t().to(i64)
    bit_t = bit.t() != 0
    for t in range(L):
        i = idx_t[t]
        b = bit_t[t]
        valid = i != PAD
        adaptive = i >= 0
        safe = torch.clamp(i, min=0)
        packed = arena[seg, safe]
        prob = torch.where(adaptive, (packed >> 16) & 0xFF, 128)
        split = 1 + (((rng - 1) * prob) >> 8)
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
        new = _branch_update(packed & 0xFF, (packed >> 8) & 0xFF, b)
        # in place: one branch per lane changes per step
        arena[seg, safe] = torch.where(adaptive, new, packed)

    emits, bytes_, carries = (x.t().cpu().numpy()
                              for x in (emits, bytes_, carries))
    nbytes = emits.sum(axis=1).astype(np.int32)
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
        out[s, :len(bs)] = bs
    return (torch.from_numpy(out).to(dev),
            torch.from_numpy(nbytes).to(dev))


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
