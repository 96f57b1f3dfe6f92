"""Phase B of container v3: per-segment rANS coding, in two stages.

Port of the v3 phase B of lepton_tpu/kernels/batch_encode.py
(_ansenc_packed_jit :378-428) and of its host side (_finalize_ans_lane
:431-437, vpx_scan.finalize_ans_streams :826-852), in its two stages:

  1. the probability stage, kernels/branch_probs.py with the adv rule
     (vpx_scan.model_probs_sorted(update="adv"), :525-609), which also
     flags a lane that codes a 0 bit at probability 0 (freq 0);
  2. the reverse walk, ans_walk (vpx_scan.ans_pass, :744-823), one serial
     coder a lane in registers.  Its kernel is csrc/ans_coder.cu, built
     with nvcc at first use into build/ and bound with ctypes
     (kernels/cuda_build.py).

encode_streams_ans chains the two; each stage launches its kernel for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.
encode_streams_ans_plain is the whole function's plain version, over a
model arena per lane, independent of the grouping.

A v3 lane is unframed: no marker bit and no stop bits, just the segment's
live symbols (idx >= 0: an adaptive branch of the arena).  Each symbol is
coded with its branch's probability before the update, and the branch
then takes the adv rule (model.branch.adv_update_branch).  The stream is
coder/ans.py's ANSWriter.finish: pairs (second = symbol 2k, first =
symbol 2k + 1, the sentinel (1, prob 1) after an odd count), walked in
reverse after 4 nop pairs by two 64-bit rANS states, then the states'
flush; the words are reversed, written little-endian, and followed by
ANS_PARITY_TAIL.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np
import torch

from ..coder.ans import ANS_PARITY_TAIL
from ..model.tables import ARENA_SIZE
from . import branch_probs as bp
from . import cuda_build
from .branch_probs import branch_update_adv
from .vpx_coder import FIXED_PROB

RANS64_L = 1 << 31
NOP_PAIRS = 4
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1

_lib = None
_lock = threading.Lock()
_tables = {}


def next_state_adv(device) -> torch.Tensor:
    """Every branch's next state under the adv rule, int64 [1 << 17]:
    index (tc << 8 | fc) << 1 | bit, that is (packed & 0xFFFF) << 1 | bit."""
    state = torch.arange(1 << 17, device=device)
    return branch_update_adv(state >> 1 & 0xFF, state >> 9 & 0xFF,
                             (state & 1) != 0)


def enc_table() -> np.ndarray:
    """The walk kernel's reciprocal table, uint64 [512, 3]: for each pair
    value v = bit << 8 | prob, (m, x_max, l | start_inv << 32) with
    freq = 256 - prob for a 1 bit and prob for a 0 bit, start = prob for a
    1 bit and 0 for a 0 bit, x_max = (RANS64_L >> 8 << 32) * freq,
    start_inv = start | (256 - freq) << 16, and (m, l) such that
    x // freq == (mulhi(m, x) + x) >> l for every 64-bit x: the low 64
    bits of 2^(64 + l) // freq + 1 with l = ceil(log2(freq)).  Copy of
    _native/leptonc.c RANS_DIV / ANS_ENC_LUT (init_rans_div).  The
    (0 bit, prob 0) entry, freq 0, is made for freq 1 and never used: the
    probability stage refuses such a lane first."""
    table = np.zeros((512, 3), np.uint64)
    for v in range(512):
        b, p = v >> 8, v & 0xFF
        freq = max(256 - p if b else p, 1)
        start = p if b else 0
        lg = (freq - 1).bit_length()
        m = ((1 << (64 + lg)) // freq + 1) & _MASK64
        x_max = (RANS64_L >> 8 << 32) * freq
        table[v] = (m, x_max, lg | (start | (256 - freq) << 16) << 32)
    return table


def _table(dev: torch.device) -> torch.Tensor:
    if dev not in _tables:
        _tables[dev] = torch.from_numpy(enc_table().view(np.int64)).to(dev)
    return _tables[dev]


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("ans_coder")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.ans_walk_launch.argtypes = [p, p, i64, i64, p, p, p, i64, p,
                                            p]
            lib.ans_walk_launch.restype = i
            lib.ans_walk_error_string.argtypes = [i]
            lib.ans_walk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_low(idx: torch.Tensor) -> None:
    """The coder's own check; the probability stage checks the rest."""
    if idx.numel() and int(idx.min()) < FIXED_PROB:
        raise ValueError(f"idx must lie in [{FIXED_PROB}, {ARENA_SIZE})")


def default_cap(L: int) -> int:
    """Initial output words per lane: the bytes of vpx_coder.default_cap."""
    return max(512, L // 16 + 512)


def encode_streams_ans(idx: torch.Tensor, bit: torch.Tensor,
                       nsyms: torch.Tensor,
                       template: Optional[torch.Tensor] = None, stats=None):
    """rANS-code S unframed symbol lanes: idx int32 [S, L], bit uint8
    [S, L], of which lane s codes its first nsyms[s] (int32 [S]).

    template: optional int32 [ARENA_SIZE] start arena in the coder layout
    (model.tables.arena_from_template); default: every branch (1, 1, 128).
    Returns (words int32 [S, cap], nwords int32 [S]) on the input's device:
    each lane's emitted words then its 4 flush words, in emission order,
    as uint32 bit patterns, with nwords <= cap.  The probability stage
    runs once; the walk reruns alone when a lane outgrows cap.
    finalize_ans makes the lane bytes.  A lane that codes a 0 bit at
    probability 0 raises ValueError.  stats: optional dict that receives
    the probability stage's (branch_probs) and, on CUDA tensors,
    walk_ms."""
    _check_low(idx)
    probs, zero = bp.branch_probs(idx, bit, template, "adv", nsyms, stats)
    if bool(zero.any()):
        _raise_zero_freq(torch.nonzero(zero).flatten().tolist())
    return bp.timed(lambda: ans_walk(probs, bit, nsyms), idx.device, stats,
                    "walk_ms")


def _raise_zero_freq(lanes) -> None:
    raise ValueError(f"lanes {[int(s) for s in lanes]} code a 0 bit at "
                     "probability 0 (a template branch with prob byte 0): "
                     "freq 0 has no rANS code")


def ans_walk(probs: torch.Tensor, bit: torch.Tensor, nsyms: torch.Tensor):
    """The reverse rANS walk of each lane's first nsyms (probs, bit): probs
    uint8 [S, L] as branch_probs gives them, bit uint8 [S, L], nsyms int32
    [S].  Returns (words int32 [S, cap], nwords int32 [S]), cap at least
    default_cap(L) and at least the longest lane.  CUDA tensors run the
    kernel, relaunched alone with a larger buffer while a lane overflows;
    CPU tensors run the plain version."""
    if probs.dim() != 2 or bit.shape != probs.shape:
        raise ValueError("probs and bit must both be [S, L]")
    if nsyms.shape != (probs.shape[0],):
        raise ValueError("nsyms must be [S]")
    if (probs.dtype != torch.uint8 or bit.dtype != torch.uint8
            or nsyms.dtype != torch.int32):
        raise TypeError("probs and bit must be uint8, nsyms int32")
    if bit.device != probs.device or nsyms.device != probs.device:
        raise ValueError("probs, bit and nsyms must be on one device")
    S, L = probs.shape
    cap = default_cap(L)
    if probs.device.type == "cpu":
        return bp.grow(lambda c: ans_walk_plain(probs, bit, nsyms, c), cap)
    if probs.device.type != "cuda":
        raise ValueError(f"no ANS coder for device {probs.device}")
    dev = probs.device
    if S == 0:
        return (torch.empty((0, cap), dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    probs, bit, nsyms = probs.contiguous(), bit.contiguous(), \
        nsyms.contiguous()
    lib = _get_lib()
    table = _table(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(c):
        out = torch.empty((S, c), dtype=torch.int32, device=dev)
        nwords = torch.empty(S, dtype=torch.int32, device=dev)
        with cuda_build.bounds(lib, stream):
            err = lib.ans_walk_launch(probs.data_ptr(), bit.data_ptr(), S,
                                      L, nsyms.data_ptr(), table.data_ptr(),
                                      out.data_ptr(), c, nwords.data_ptr(),
                                      stream)
            cuda_build.count_launch(ans_walk)
            if err:
                raise RuntimeError("ans_coder launch failed: "
                                   + lib.ans_walk_error_string(err).decode())
        return out, nwords

    return bp.grow(launch, cap)


ans_walk.launches = 0


def _put(x, start, freq, active):
    """Rans64EncPut on int64 states (all < 2^63) of the active lanes:
    returns (x', emitted, word).  The renormalisation test compares
    x >> 32 with freq << 23: x with freq << 55 overflows int64 at
    freq 256."""
    emit = active & ((x >> 32) >= (freq << 23))
    word = x & _MASK32
    x = torch.where(emit, x >> 32, x)
    nx = ((x // freq) << 8) + x % freq + start
    return torch.where(active, nx, x), emit, word


def ans_walk_plain(probs: torch.Tensor, bit: torch.Tensor,
                   nsyms: torch.Tensor, cap: Optional[int] = None):
    """The walk kernel's plain PyTorch version: the reverse walk in int64
    with plain // and %, one pair step a lane at a time, lane s at pair
    npairs_s + 3 - j in step j, and the emitted words gathered on the host
    in emission order.  Returns (words int32 [S, cap], nwords int32 [S]):
    with cap given, the words past it are dropped and nwords still counts
    them, as the kernel does; by default cap is max(default_cap(L), the
    longest lane).  Raises ValueError on a 0 bit at probability 0."""
    S, L = probs.shape
    dev = probs.device
    i64 = torch.int64
    seg = torch.arange(S, device=dev)
    n = nsyms.to(i64)
    bits = (bit != 0).to(i64)
    # (start, freq) of every pair's two slots; an odd count's last pair
    # holds the sentinel (bit 1, prob 1) in its first slot
    P = max((L + 1) // 2, 1)
    pad = 2 * P - L
    b2 = torch.nn.functional.pad(bits, (0, pad)).view(S, P, 2)
    p2 = torch.nn.functional.pad(probs.to(i64), (0, pad),
                                 value=128).view(S, P, 2)
    sentinel = torch.arange(2 * P, device=dev).view(1, P, 2) == n.view(S, 1,
                                                                       1)
    b2 = torch.where(sentinel, 1, b2)
    p2 = torch.where(sentinel, 1, p2)
    start = torch.where(b2 != 0, p2, 0)
    freq = torch.where(b2 != 0, 256 - p2, p2)
    coded = sentinel | (torch.arange(2 * P, device=dev).view(1, P, 2)
                        < n.view(S, 1, 1))
    zero = ((freq == 0) & coded).flatten(1).any(1)
    if bool(zero.any()):
        _raise_zero_freq(torch.nonzero(zero).flatten())

    npairs = (n + 1) // 2
    x1 = torch.full((S,), RANS64_L, dtype=i64, device=dev)
    x2 = x1.clone()
    steps = int(npairs.max()) + NOP_PAIRS if S else 0
    emits, words = [], []
    for j in range(steps):
        k = npairs + (NOP_PAIRS - 1) - j
        active = k >= 0
        real = active & (k < npairs)
        kk = k.clamp(0, P - 1)
        st = start[seg, kk]
        fr = freq[seg, kk]
        # slot 1 is the first symbol of the pair (state s1), slot 0 the
        # second (state s2); nop pairs and finished lanes code 0 at 128
        st = torch.where(real[:, None], st, 0)
        fr = torch.where(real[:, None], fr, 128)
        x1, e1, w1 = _put(x1, st[:, 1], fr[:, 1], active)
        x2, e2, w2 = _put(x2, st[:, 0], fr[:, 0], active)
        emits.append(torch.stack([e1, e2]))
        words.append(torch.stack([w1, w2]))
    flush = torch.stack([x1 >> 32, x1 & _MASK32, x2 >> 32, x2 & _MASK32], 1)
    if steps:
        # [S, 2 * steps] in emission order: s1's word before s2's, per step
        emits = torch.stack(emits).permute(2, 0, 1).reshape(S, -1)
        words = torch.stack(words).permute(2, 0, 1).reshape(S, -1)
    else:
        emits = torch.zeros((S, 0), dtype=torch.bool, device=dev)
        words = torch.zeros((S, 0), dtype=i64, device=dev)
    emits, words, flush = (x.cpu().numpy() for x in (emits, words, flush))
    lanes = [np.concatenate([words[s][emits[s]], flush[s]])
             for s in range(S)]
    nwords = np.asarray([len(w) for w in lanes], np.int32)
    if cap is None:
        cap = max(default_cap(L), int(nwords.max()) if S else 0)
    out = np.zeros((S, cap), np.uint32)
    for s, w in enumerate(lanes):
        out[s, :min(len(w), cap)] = w[:cap]
    return (torch.from_numpy(out.view(np.int32)).to(dev),
            torch.from_numpy(nwords).to(dev))


def encode_streams_ans_plain(idx: torch.Tensor, bit: torch.Tensor,
                             nsyms: torch.Tensor,
                             template: Optional[torch.Tensor] = None):
    """The whole coder's plain PyTorch version, same contract as
    encode_streams_ans: the probabilities of a lockstep walk over a model
    arena per lane (branch_probs.arena_probs_plain, no grouping), then
    ans_walk_plain."""
    _check_low(idx)
    probs = bp.arena_probs_plain(idx, bit, template, "adv", nsyms)
    return ans_walk_plain(probs, bit, nsyms)


def finalize_ans(words: torch.Tensor, nwords: torch.Tensor) -> List[bytes]:
    """Per-lane v3 stream bytes: the emitted and flush words reversed,
    little-endian, then ANS_PARITY_TAIL (ANSWriter.finish)."""
    nw = nwords.cpu().numpy()
    host = (words[:, :int(nw.max())].cpu().numpy().view(np.uint32)
            if len(nw) else None)
    return [host[s, :n][::-1].astype("<u4").tobytes() + ANS_PARITY_TAIL
            for s, n in enumerate(nw)]
