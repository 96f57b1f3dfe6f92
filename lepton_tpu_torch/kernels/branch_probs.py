"""The probability stage of both encode coders: the probability each symbol
is coded with, computed for every branch at once.

Port of lepton_tpu/kernels/vpx_scan.py::model_probs_sorted (:525-609), the
first stage of the JAX package's two-pass phase B (v1/v2:
_twopass_fused_jit, batch_encode.py:242-264; v3: _ansenc_packed_jit
:378-428 with update="adv").  On encode every symbol's branch and bit are
known before coding starts, and a branch's probabilities depend only on its
own bits in stream order.  So the live symbols (idx >= 0) are grouped by
(lane, branch), in stream order within a group, and each group is walked
alone from its start state.  The coders' walks (vpx_coder.vpx_walk,
ans_coder.ans_walk) then read these probabilities and keep no model arena.

Grouping is one torch.sort of a packed int64 key a live symbol,

    ((lane * ARENA_SIZE + idx) << shift) | (pos << 1) | bit

with shift - 1 bits for a position in the lane.  Positions are unique in a
lane, so the keys are unique and the sort's stability is moot.  Then two
kernels of csrc/branch_probs.cu, each behind its own wrapper: run_heads
gathers the keys that start a run of equal (lane, branch), and walk_runs
walks each run in one thread with the rules of csrc/vpx_branch.cuh,
scattering each probability to its stream position.  branch_probs chains
the sort and the two.  Each wrapper launches its kernel for CUDA tensors
and runs its plain version (run_heads_plain, walk_runs_plain) only for CPU
tensors; branch_probs_plain chains the plain versions.

arena_probs_plain computes the same function the way the coders did before
this stage existed: a lockstep walk of every lane over its own model arena.
The coders' whole-function plain versions use it, so they stay independent
of the grouping.

grow is plumbing that both coders share: a walk run again while a lane
overflows its output.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..model.tables import ARENA_SIZE, IDENTITY_BRANCH
from ..util import timing
from . import cuda_build

RULES = ("vpx", "adv")

_lib = None
_lock = threading.Lock()


def branch_update(fc, tc, obs):
    """Branch::record_obs_and_update (branch.hh:82-100), the VPX lanes'
    rule, on int64 tensors of pre-observation counts; returns the packed
    fc | tc<<8 | prob<<16 with the prob wrapped to 8 bits like the host's
    uint8 store (the tc == 0 corner that only templates reach yields
    256)."""
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


def branch_update_adv(fc, tc, obs):
    """The adv rule (model.branch.adv_update_branch) of the rANS lanes on
    int64 tensors of pre-observation counts; returns the packed
    fc | tc<<8 | prob<<16."""
    val = torch.where(obs, tc, fc)
    ovf = val == 0xFF
    nfc = torch.where(ovf, torch.where(obs, (fc + 1) >> 1, 129),
                      torch.where(obs, fc, fc + 1))
    ntc = torch.where(ovf, torch.where(obs, 129, (tc + 1) >> 1),
                      torch.where(obs, tc + 1, tc))
    nprob = (((nfc << 8) // (nfc + ntc)) & 0xFF) | 1
    return nfc | (ntc << 8) | (nprob << 16)


_UPDATE = {"vpx": branch_update, "adv": branch_update_adv}


def grow(walk, cap: int):
    """walk(cap) -> (out, counts) until every lane's count fits in cap: a
    walk that overflows is run again, alone, with room for its longest
    lane."""
    while True:
        out, n = walk(cap)
        need = int(n.max()) if n.numel() else 0
        if need <= cap:
            return out, n
        cap = need


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("branch_probs")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.run_heads_launch.argtypes = [p, i64, i, p, p, p]
            lib.run_heads_launch.restype = i
            lib.walk_runs_launch.argtypes = [p, i64, i, p, i64, i64, i64,
                                             i64, p, i, p, p, p, p]
            lib.walk_runs_launch.restype = i
            lib.branch_probs_error_string.argtypes = [i]
            lib.branch_probs_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(idx: torch.Tensor, bit: torch.Tensor,
          template: Optional[torch.Tensor], rule: str = "vpx",
          nsyms: Optional[torch.Tensor] = None) -> None:
    """Raise on inputs the stage does not take."""
    if idx.dim() != 2 or bit.shape != idx.shape:
        raise ValueError("idx and bit must both be [S, L]")
    if idx.dtype != torch.int32 or bit.dtype != torch.uint8:
        raise TypeError("idx must be int32 and bit uint8")
    if bit.device != idx.device:
        raise ValueError("idx and bit must be on one device")
    if rule not in RULES:
        raise ValueError(f"rule must be one of {RULES}")
    # the kernel indexes the template with idx unchecked
    if idx.numel() and int(idx.max()) >= ARENA_SIZE:
        raise ValueError(f"idx must lie below {ARENA_SIZE}")
    if nsyms is not None:
        if nsyms.shape != (idx.shape[0],):
            raise ValueError("nsyms must be [S]")
        if nsyms.dtype != torch.int32:
            raise TypeError("nsyms must be int32")
        if nsyms.device != idx.device:
            raise ValueError("nsyms must be on idx's device")
        if nsyms.numel() and (int(nsyms.min()) < 0
                              or int(nsyms.max()) > idx.shape[1]):
            raise ValueError("nsyms must lie in [0, L]")
    if template is not None and (
            template.shape != (ARENA_SIZE,) or template.dtype != torch.int32
            or template.device != idx.device):
        raise ValueError(f"template must be int32 [{ARENA_SIZE}] on "
                         f"{idx.device}")


def key_shift(S: int, L: int) -> int:
    """The shift of the packed sort key of S lanes of L symbols, (lane *
    ARENA_SIZE + branch) << shift | position << 1 | bit: one bit more than
    a position takes.  Raises ValueError where the largest key, below
    S * ARENA_SIZE << shift, would not fit in 63 bits (the sort is of
    signed int64: a wrapped key would sort first)."""
    shift = max(L - 1, 1).bit_length() + 1
    if S * ARENA_SIZE > 1 << (63 - shift):
        raise ValueError(f"{S} lanes of {L} symbols overflow the 63-bit "
                         "sort key")
    return shift


def group(idx: torch.Tensor, bit: torch.Tensor,
          nsyms: Optional[torch.Tensor] = None):
    """The live symbols' packed keys, sorted: (keys int64 [N], shift).

    A symbol is live where idx >= 0 and, given nsyms, its position is
    below its lane's nsyms.  Raises ValueError where the key would not fit
    in 63 bits (key_shift)."""
    S, L = idx.shape
    shift = key_shift(S, L)
    dev = idx.device
    live = idx >= 0
    if nsyms is not None:
        live &= torch.arange(L, device=dev) < nsyms[:, None]
    key = idx.to(torch.int64)
    key += torch.arange(S, device=dev)[:, None] * ARENA_SIZE
    key <<= shift
    key |= torch.arange(L, device=dev) << 1
    key |= bit != 0
    return torch.sort(key[live]).values, shift


def branch_probs(idx: torch.Tensor, bit: torch.Tensor,
                 template: Optional[torch.Tensor] = None, rule: str = "vpx",
                 nsyms: Optional[torch.Tensor] = None):
    """Each symbol's coding probability: the probability of its branch
    before the branch sees the symbol's bit, on first use the template's
    stored prob byte (default: every branch (1, 1, 128)).

    idx int32 [S, L] (a branch, or < 0: FIXED_PROB and PAD), bit uint8
    [S, L]; template: optional int32 [ARENA_SIZE] in the coder layout
    (model.tables.arena_from_template); rule: "vpx" (update_branch) or
    "adv" (update_branch_adv); nsyms: optional int32 [S], the symbols of
    lane s past nsyms[s] are not coded.  Returns (probs uint8 [S, L] in
    stream order, 128 where no branch is coded; zero bool [S], under "adv"
    the lanes that code a 0 bit at probability 0, which has no rANS code).
    Stats of the open call (util/timing.py): live (symbols), runs and
    longest_run, and on CUDA tensors the CUDA-event times sort_ms
    (group), heads_ms (run_heads), runs_ms (walk_runs) and probs_ms (the
    two kernels together)."""
    check(idx, bit, template, rule, nsyms)
    dev = idx.device
    keys, shift = timing.timed(lambda: group(idx, bit, nsyms), dev,
                               "sort_ms", name="coder.sort")

    def kernels():
        heads = timing.timed(lambda: run_heads(keys, shift), dev, "heads_ms")
        return len(heads), timing.timed(
            lambda: walk_runs(keys, shift, heads, idx.shape, template, rule),
            dev, "runs_ms")

    nruns, (probs, zero, longest) = timing.timed(kernels, dev, "probs_ms",
                                                 name="coder.probs")
    timing.add("live", keys.numel())
    timing.add("runs", nruns)
    timing.add("longest_run", longest)
    return probs, zero


def _raise_on(lib, err: int) -> None:
    if err:
        raise RuntimeError("branch_probs launch failed: "
                           + lib.branch_probs_error_string(err).decode())


def _stream(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"no probability stage for device {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def run_heads(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The positions in keys (int64 [N], sorted, as group gives them) of
    the keys that start a run of equal (lane, branch): int64 [R].  CUDA
    tensors launch the kernel, whose list comes in no fixed order; CPU
    tensors run run_heads_plain, whose list is ascending."""
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError("keys must be int64 [N]")
    if keys.device.type == "cpu":
        return run_heads_plain(keys, shift)
    stream = _stream(keys)
    n = keys.numel()
    if n == 0:
        return keys.new_empty(0)
    lib = _get_lib()
    keys = keys.contiguous()
    heads = torch.empty(n, dtype=torch.int64, device=keys.device)
    nheads = torch.zeros(1, dtype=torch.int64, device=keys.device)
    with cuda_build.bounds(lib, stream, per_lane=False):
        err = lib.run_heads_launch(keys.data_ptr(), n, shift,
                                   heads.data_ptr(), nheads.data_ptr(),
                                   stream)
        cuda_build.count_launch(run_heads)
        _raise_on(lib, err)
    return heads[:int(nheads)]


run_heads.launches = 0


def run_heads_plain(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The run_heads kernel's plain PyTorch version: every position whose
    (lane, branch) differs from the previous key's, ascending."""
    branch = keys >> shift
    head = torch.ones_like(branch, dtype=torch.bool)
    head[1:] = branch[1:] != branch[:-1]
    return torch.nonzero(head).flatten()


def walk_runs(keys: torch.Tensor, shift: int, heads: torch.Tensor, shape,
              template: Optional[torch.Tensor] = None, rule: str = "vpx"):
    """Walk each run of keys that starts at heads (run_heads' list, in any
    order) from its start state, the identity branch or template[branch],
    under `rule`.  shape: the lanes' (S, L).  Returns (probs uint8 [S, L],
    128 where no key lands; zero bool [S], see branch_probs; the longest
    run, int).  CUDA tensors launch the kernel; CPU tensors run
    walk_runs_plain."""
    if rule not in RULES:
        raise ValueError(f"rule must be one of {RULES}")
    if keys.device.type == "cpu":
        return walk_runs_plain(keys, shift, heads, shape, template, rule)
    stream = _stream(keys)
    S, L = shape
    dev = keys.device
    probs = torch.full((S, L), 128, dtype=torch.uint8, device=dev)
    zero = torch.zeros(S, dtype=torch.uint8, device=dev)
    if not len(heads):
        return probs, zero != 0, 0
    lib = _get_lib()
    keys, heads = keys.contiguous(), heads.contiguous()
    if template is not None:
        template = template.contiguous()
    longest = torch.zeros(1, dtype=torch.int32, device=dev)
    with cuda_build.bounds(lib, stream, per_lane=False):
        err = lib.walk_runs_launch(
            keys.data_ptr(), keys.numel(), shift, heads.data_ptr(),
            len(heads), ARENA_SIZE, S, L,
            None if template is None else template.data_ptr(),
            int(rule == "adv"), probs.data_ptr(), zero.data_ptr(),
            longest.data_ptr(), stream)
        cuda_build.count_launch(walk_runs)
        _raise_on(lib, err)
    return probs, zero != 0, int(longest)


walk_runs.launches = 0


def walk_runs_plain(keys: torch.Tensor, shift: int, heads: torch.Tensor,
                    shape, template: Optional[torch.Tensor] = None,
                    rule: str = "vpx"):
    """The walk_runs kernel's plain PyTorch version, same contract: a
    lockstep loop over the rank within a run, vectorised over runs, in
    int64.  Step r advances every run longer than r by one symbol; runs are
    ordered longest first, so those still walking are a prefix."""
    S, L = shape
    dev = keys.device
    i64 = torch.int64
    probs = torch.full((S * L,), 128, dtype=i64, device=dev)
    zero = torch.zeros(S, dtype=torch.bool, device=dev)
    if not len(heads):
        return probs.view(S, L).to(torch.uint8), zero, 0
    branch = keys >> shift
    lane = branch // ARENA_SIZE
    flat = lane * L + ((keys >> 1) & ((1 << (shift - 1)) - 1))
    obs = (keys & 1) != 0
    starts = torch.sort(heads).values
    lens = torch.diff(starts, append=starts.new_tensor([len(keys)]))
    lens, order = torch.sort(lens, descending=True, stable=True)
    starts = starts[order]
    first = branch[starts] % ARENA_SIZE
    state = (torch.full_like(starts, IDENTITY_BRANCH) if template is None
             else template.to(i64)[first])
    # walking[r]: the runs longer than r
    walking = torch.bincount(lens).flip(0).cumsum(0).flip(0)[1:].tolist()
    update = _UPDATE[rule]
    for r, m in enumerate(walking):
        j = starts[:m] + r
        st = state[:m]
        p = (st >> 16) & 0xFF
        b = obs[j]
        probs[flat[j]] = p
        if rule == "adv":
            zero[lane[j][(p == 0) & ~b]] = True
        state[:m] = update(st & 0xFF, (st >> 8) & 0xFF, b)
    return probs.view(S, L).to(torch.uint8), zero, int(lens[0])


def branch_probs_plain(idx: torch.Tensor, bit: torch.Tensor,
                       template: Optional[torch.Tensor] = None,
                       rule: str = "vpx",
                       nsyms: Optional[torch.Tensor] = None):
    """The stage's plain PyTorch version, same contract as branch_probs:
    the same grouping, then run_heads_plain and walk_runs_plain."""
    check(idx, bit, template, rule, nsyms)
    keys, shift = group(idx, bit, nsyms)
    probs, zero, _ = walk_runs_plain(keys, shift,
                                     run_heads_plain(keys, shift), idx.shape,
                                     template, rule)
    return probs, zero


def arena_probs_plain(idx: torch.Tensor, bit: torch.Tensor,
                      template: Optional[torch.Tensor] = None,
                      rule: str = "vpx",
                      nsyms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probabilities of branch_probs (uint8 [S, L]) from a lockstep loop
    over symbol positions, vectorised over lanes, that gathers and scatters
    one branch a lane of an [S, ARENA_SIZE] arena per step: the function of
    the coders' original arena walk, with no grouping."""
    check(idx, bit, template, rule, nsyms)
    S, L = idx.shape
    dev = idx.device
    i64 = torch.int64
    if template is None:
        arena = torch.full((S, ARENA_SIZE), IDENTITY_BRANCH, dtype=i64,
                           device=dev)
    else:
        arena = template.to(i64).expand(S, ARENA_SIZE).clone()
    update = _UPDATE[rule]
    seg = torch.arange(S, device=dev)
    n = torch.full((S,), L, device=dev) if nsyms is None else nsyms
    obs = (bit != 0).t()
    probs = torch.full((L, S), 128, dtype=i64, device=dev)
    idx_t = idx.t().to(i64)
    for t in range(L):
        i = idx_t[t]
        live = (i >= 0) & (t < n)
        safe = i.clamp(min=0)
        packed = arena[seg, safe]
        probs[t] = torch.where(live, (packed >> 16) & 0xFF, 128)
        new = update(packed & 0xFF, (packed >> 8) & 0xFF, obs[t])
        # in place: one branch per lane changes per step
        arena[seg, safe] = torch.where(live, new, packed)
    return probs.t().to(torch.uint8).contiguous()
