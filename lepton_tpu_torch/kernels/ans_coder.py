"""Phase B of container v3: per-segment rANS coding, one serial coder a lane.

Port of the v3 phase B of lepton_tpu/kernels/batch_encode.py
(_ansenc_packed_jit :378-428, that is vpx_scan.model_probs_sorted with the
adv update rule, :525-609, plus vpx_scan.ans_pass, :744-823) and of its
host side (_finalize_ans_lane :431-437, vpx_scan.finalize_ans_streams
:826-852).  The kernel is csrc/ans_coder.cu, built with nvcc at first use
into build/ and bound with ctypes (kernels/cuda_build.py).
encode_streams_ans launches it for CUDA tensors and runs the plain PyTorch
version, encode_streams_ans_plain, only for CPU tensors.

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

from ..model.tables import ARENA_SIZE, IDENTITY_BRANCH
from . import cuda_build
from .vpx_coder import FIXED_PROB

RANS64_L = 1 << 31
NOP_PAIRS = 4
# The reference's finish copies one word past what its encoder wrote
# (finish - pptr + 1, ans_bool_writer.hh:108-109), landing on the last nop
# pair's raw bytes: every v3 encoder appends this tail (copy of
# lepton_tpu/coder/ans.py ANS_PARITY_TAIL, :25-30).
ANS_PARITY_TAIL = b"\x00\x80\x00\x80"
_MASK32 = 0xFFFFFFFF

_lib = None
_lock = threading.Lock()


def branch_update_adv(fc, tc, obs):
    """The adv rule (model.branch.adv_update_branch) on int64 tensors of
    pre-observation counts; returns the packed fc | tc<<8 | prob<<16."""
    val = torch.where(obs, tc, fc)
    ovf = val == 0xFF
    nfc = torch.where(ovf, torch.where(obs, (fc + 1) >> 1, 129),
                      torch.where(obs, fc, fc + 1))
    ntc = torch.where(ovf, torch.where(obs, 129, (tc + 1) >> 1),
                      torch.where(obs, tc + 1, tc))
    nprob = (((nfc << 8) // (nfc + ntc)) & 0xFF) | 1
    return nfc | (ntc << 8) | (nprob << 16)


def next_state_adv(device) -> torch.Tensor:
    """Every branch's next state under the adv rule, int64 [1 << 17]:
    index (tc << 8 | fc) << 1 | bit, that is (packed & 0xFFFF) << 1 | bit."""
    state = torch.arange(1 << 17, device=device)
    return branch_update_adv(state >> 1 & 0xFF, state >> 9 & 0xFF,
                             (state & 1) != 0)


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("ans_coder")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.ans_coder_launch.argtypes = [p, p, i64, i64, p, p, p, i, p,
                                             p, i64, p, p]
            lib.ans_coder_launch.restype = i
            lib.ans_coder_error_string.argtypes = [i]
            lib.ans_coder_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(idx, bit, nsyms, template) -> None:
    if idx.dim() != 2 or bit.shape != idx.shape:
        raise ValueError("idx and bit must both be [S, L]")
    if nsyms.shape != (idx.shape[0],):
        raise ValueError("nsyms must be [S]")
    if (idx.dtype != torch.int32 or bit.dtype != torch.uint8
            or nsyms.dtype != torch.int32):
        raise TypeError("idx and nsyms must be int32 and bit uint8")
    if bit.device != idx.device or nsyms.device != idx.device:
        raise ValueError("idx, bit and nsyms must be on one device")
    # the kernel indexes the arena with idx unchecked
    if idx.numel() and (int(idx.min()) < FIXED_PROB
                        or int(idx.max()) >= ARENA_SIZE):
        raise ValueError(f"idx must lie in [{FIXED_PROB}, {ARENA_SIZE})")
    if nsyms.numel() and (int(nsyms.min()) < 0
                          or int(nsyms.max()) > idx.shape[1]):
        raise ValueError("nsyms must lie in [0, L]")
    if template is not None and (
            template.shape != (ARENA_SIZE,) or template.dtype != torch.int32
            or template.device != idx.device):
        raise ValueError(f"template must be int32 [{ARENA_SIZE}] on "
                         f"{idx.device}")


def default_cap(L: int) -> int:
    """Initial output words per lane: the bytes of vpx_coder.default_cap."""
    return max(512, L // 16 + 512)


def encode_streams_ans(idx: torch.Tensor, bit: torch.Tensor,
                       nsyms: torch.Tensor,
                       template: Optional[torch.Tensor] = None):
    """rANS-code S unframed symbol lanes: idx int32 [S, L], bit uint8
    [S, L], of which lane s codes its first nsyms[s] (int32 [S]).

    template: optional int32 [ARENA_SIZE] start arena in the coder layout
    (model.tables.arena_from_template); default: every branch (1, 1, 128).
    Returns (words int32 [S, cap], nwords int32 [S]) on the input's device:
    each lane's emitted words then its 4 flush words, in emission order,
    as uint32 bit patterns, with nwords <= cap (a lane that outgrows cap
    relaunches the kernel with room for it).  finalize_ans makes the lane
    bytes.  CUDA tensors run the kernel; CPU tensors run the plain
    version."""
    _check(idx, bit, nsyms, template)
    if idx.device.type == "cpu":
        return encode_streams_ans_plain(idx, bit, nsyms, template)
    if idx.device.type != "cuda":
        raise ValueError(f"no ANS coder for device {idx.device}")
    idx, bit, nsyms = idx.contiguous(), bit.contiguous(), nsyms.contiguous()
    S, L = idx.shape
    dev = idx.device
    nwords = torch.zeros(S, dtype=torch.int32, device=dev)
    cap = default_cap(L)
    if S == 0:
        return torch.empty((0, cap), dtype=torch.int32, device=dev), nwords
    lib = _get_lib()
    # scratch: one model arena and one probability row per lane, each
    # written by the kernel before it is read
    arena = torch.empty((S, ARENA_SIZE), dtype=torch.int32, device=dev)
    probs = torch.empty((S, max(L, 1)), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    while True:
        out = torch.empty((S, cap), dtype=torch.int32, device=dev)
        err = lib.ans_coder_launch(
            idx.data_ptr(), bit.data_ptr(), S, L, nsyms.data_ptr(),
            None if template is None else template.data_ptr(),
            arena.data_ptr(), ARENA_SIZE, probs.data_ptr(), out.data_ptr(),
            cap, nwords.data_ptr(), stream)
        encode_streams_ans.launches += 1
        if err:
            raise RuntimeError("ans_coder launch failed: "
                               + lib.ans_coder_error_string(err).decode())
        nw = nwords.cpu()
        if int(nw.min()) < 0:
            _raise_zero_freq(np.flatnonzero(nw.numpy() < 0))
        need = int(nw.max())
        if need <= cap:
            return out, nwords
        cap = need


encode_streams_ans.launches = 0


def _raise_zero_freq(lanes) -> None:
    raise ValueError(f"lanes {[int(s) for s in lanes]} code a 0 bit at "
                     "probability 0 (a template branch with prob byte 0): "
                     "freq 0 has no rANS code")


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


def encode_streams_ans_plain(idx: torch.Tensor, bit: torch.Tensor,
                             nsyms: torch.Tensor,
                             template: Optional[torch.Tensor] = None):
    """The kernel's plain PyTorch version, same contract as
    encode_streams_ans.

    A lockstep loop over symbol positions, vectorised over lanes, gathers
    and scatters one branch a lane of the [S, ARENA_SIZE] arena and
    records probs [S, L] (the adv next-state table of next_state_adv).
    Then the reverse walk runs in int64, one pair step a lane at a time,
    lane s at pair npairs_s + 3 - j in step j, and the emitted words are
    gathered on the host in emission order."""
    _check(idx, bit, nsyms, template)
    S, L = idx.shape
    dev = idx.device
    i64 = torch.int64
    if template is None:
        arena = torch.full((S, ARENA_SIZE), IDENTITY_BRANCH, dtype=i64,
                           device=dev)
    else:
        arena = template.to(i64).expand(S, ARENA_SIZE).clone()
    nxt = next_state_adv(dev)
    seg = torch.arange(S, device=dev)
    n = nsyms.to(i64)
    bits = (bit != 0).to(i64)
    probs = torch.full((S, L), 128, dtype=i64, device=dev)
    idx_t = idx.t().to(i64)
    for t in range(L):
        i = idx_t[t]
        adaptive = (i >= 0) & (t < n)
        safe = i.clamp(min=0)
        packed = arena[seg, safe]
        probs[:, t] = torch.where(adaptive, (packed >> 16) & 0xFF, 128)
        new = nxt[((packed & 0xFFFF) << 1) | bits[:, t]]
        # in place: one branch per lane changes per step
        arena[seg, safe] = torch.where(adaptive, new, packed)
    del arena

    # (start, freq) of every pair's two slots; an odd count's last pair
    # holds the sentinel (bit 1, prob 1) in its first slot
    P = max((L + 1) // 2, 1)
    pad = 2 * P - L
    b2 = torch.nn.functional.pad(bits, (0, pad)).view(S, P, 2)
    p2 = torch.nn.functional.pad(probs, (0, pad), value=128).view(S, P, 2)
    sentinel = torch.arange(2 * P, device=dev).view(1, P, 2) == n.view(S, 1,
                                                                       1)
    b2 = torch.where(sentinel, 1, b2)
    p2 = torch.where(sentinel, 1, p2)
    start = torch.where(b2 != 0, p2, 0)
    freq = torch.where(b2 != 0, 256 - p2, p2)
    zero = (freq == 0).flatten(1).any(1)
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
    cap = max(default_cap(L), int(nwords.max()) if S else 0)
    out = np.zeros((S, cap), np.uint32)
    for s, w in enumerate(lanes):
        out[s, :len(w)] = w
    return (torch.from_numpy(out.view(np.int32)).to(dev),
            torch.from_numpy(nwords).to(dev))


def finalize_ans(words: torch.Tensor, nwords: torch.Tensor) -> List[bytes]:
    """Per-lane v3 stream bytes: the emitted and flush words reversed,
    little-endian, then ANS_PARITY_TAIL (ANSWriter.finish)."""
    nw = nwords.cpu().numpy()
    host = (words[:, :int(nw.max())].cpu().numpy().view(np.uint32)
            if len(nw) else None)
    return [host[s, :n][::-1].astype("<u4").tobytes() + ANS_PARITY_TAIL
            for s, n in enumerate(nw)]
