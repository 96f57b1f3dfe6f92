"""Per-segment token decode: .lep streams -> int16 coefficient planes.

Port of lepton_tpu/kernels/pallas_decode.py (the kernel of _build_kernel
:270-763 with its VPX reader, coder="vpx", and its two-state rANS reader,
coder="ans", and their host side decode_segments_pallas /
decode_segments_pallas_multi :784-979).  The kernel is csrc/vpx_decoder.cu,
a template on the reader, built with nvcc at first use into build/ and
bound with ctypes (kernels/cuda_build.py).  decode_lanes launches it for
CUDA tensors and runs the plain PyTorch version, decode_lanes_plain, only
for CPU tensors.  Each of the kernel's CTAs keeps its lane's branches in a
cache in shared memory of cache_slots() entries (cache_fill replays what
it holds).

The host plan (plan_decode) turns one or many requests of one coder into
the kernel's inputs: every segment of every request is one lane; each lane
is a list of row descriptors in plan_rows order; the streams are padded
into one [S, Lmax] buffer, of bytes for VPX lanes (containers v1 and v2)
and of little-endian uint32 words for rANS lanes (container v3); each
request's colour tables are rows of one table array.  Every lane writes its
rows straight into one zero-initialised int16 buffer that holds every plane
of every request, so a row cut by early EOF stays zero.  What the Mosaic
kernel needed is left out: the shape buckets, the 64-wide width bucket,
dummy lanes, 128-lane rows and the [S, n_flat] slab with its host scatter.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..model.tables import (ARENA_SIZE, IDENTITY_BRANCH, TABLE_OFFSETS,
                            TABLE_STRIDES)
from . import cuda_build
from .ans_coder import RANS64_L, next_state_adv
from .branch_probs import branch_update
from .contexts import bit_length, idct_blocks
from .encode_pipeline import plan_rows

LOTS_OF_BITS = 0x40000000
MAX_TABLES = 4          # colour tables a lane may use (one request's)
SUMMARY = 9             # ring entry: nz7, then the 8 horizontal edge values
# row descriptor fields
ROW_FIELDS = ("comp", "ci", "width", "plane_width", "has_above", "ctab",
              "out_block")
LANE_FIELDS = ("row0", "nrows", "tab0", "ntab")
# colour table rows: quant, icos_x, icos_y, min_noise_threshold (raster)
TABLE_ROWS = 4
# the kernel's reader for each coder (vpx_decoder_launch's `coder`)
CODERS = {"vpx": 0, "ans": 1}

# model layout in the LUT from LUT_LAYOUT on: each table's offset, then its
# strides but the last (csrc/vpx_decoder.cu reads them in this order)
LUT_LAYOUT = 192
_LAYOUT_TABLES = ("nz_7x7", "exp_7x7", "residual_noise", "sign", "exp_x",
                  "residual_thresh", "exp_dc", "residual_noise_dc",
                  "nz_8x1", "nz_1x8")

# the kernel's branch cache (csrc/vpx_decoder.cu): shared memory before it
# (kFixedSmem), slots probed for a branch (kProbes), the hash multiplier
# (kHashMul), and what one CTA may hold on the H100 (227 KB)
FIXED_SMEM = 10240
CACHE_PROBES = 8
CACHE_HASH = 0x9E3779B1
CACHE_ENTRY_BYTES = 8
SMEM_LIMIT = 232448

_lib = None
_lock = threading.Lock()


def build_luts() -> np.ndarray:
    """int32 [256]: [0:49] unzigzag49, [64:114] nonzero_to_bin, [128:178]
    (n + 3) // 7 (pallas_decode._build_luts, :773-781), then from
    LUT_LAYOUT on the model layout."""
    luts = np.zeros(256, np.int32)
    luts[:49] = np.asarray(C.UNZIGZAG49, np.int32)
    nzb = np.asarray(C.NONZERO_TO_BIN, np.int32)
    luts[64:64 + len(nzb)] = nzb
    luts[128:178] = (np.arange(50) + 3) // 7
    layout = []
    for name in _LAYOUT_TABLES:
        layout.append(TABLE_OFFSETS[name])
        layout.extend(TABLE_STRIDES[name][:-1])
    luts[LUT_LAYOUT:LUT_LAYOUT + len(layout)] = layout
    return luts


@dataclass
class DecodePlan:
    """The kernel's inputs for a batch of requests, on the host."""
    data: np.ndarray        # vpx: uint8 [S, Lmax + 4], streams zero-padded;
    #                         ans: int32 [S, max(Lmax, 4)], LE uint32 words
    dlen: np.ndarray        # int32 [S]: stream bytes (vpx) or words (ans)
    lanes: np.ndarray       # int32 [S, 4]: LANE_FIELDS
    rows: np.ndarray        # int32 [R, 7]: ROW_FIELDS
    tables: np.ndarray      # int32 [T, 4, 64]: TABLE_ROWS per colour table
    ring_width: int         # widest plane, in blocks
    ring_comps: int         # most components of one request
    n_blocks: int           # blocks of every plane of every request
    planes: list            # per request: [(block offset, H, W)] per comp
    lane_request: list      # request index of each lane
    coder: str = "vpx"      # every lane's: "vpx" or "ans"

    def to(self, device) -> dict:
        """The arguments of decode_lanes on `device`."""
        dev = torch.device(device)
        return dict(
            data=torch.as_tensor(self.data, device=dev),
            dlen=torch.as_tensor(self.dlen, device=dev),
            lanes=torch.as_tensor(self.lanes, device=dev),
            rows=torch.as_tensor(self.rows, device=dev),
            tables=torch.as_tensor(self.tables, device=dev),
            ring_width=self.ring_width, ring_comps=self.ring_comps,
            n_blocks=self.n_blocks, coder=self.coder)

    def _row_span(self, lo: int, hi: int) -> tuple:
        """The rows of lanes lo..hi-1: (first, past the last)."""
        if lo >= hi:
            return 0, 0
        return (int(self.lanes[lo, 0]),
                int(self.lanes[hi - 1, 0] + self.lanes[hi - 1, 1]))

    def share(self, lo: int, hi: int) -> "DecodePlan":
        """Lanes lo..hi-1 as a plan of their own, for one device of a
        lane-sharded decode (the shard_map over the 'seg' axis of
        lepton_tpu/kernels/vpx_decode.py:883-917): the same planes, tables
        and n_blocks, only those lanes' streams and rows.  A lane writes
        only the blocks of its own rows, so the share's launch fills its
        rows of a zeroed [n_blocks, 64], and merge_shares puts the shares
        back together."""
        if not 0 <= lo <= hi <= len(self.lanes):
            raise ValueError(f"lanes ({lo}, {hi}) outside the plan's "
                             f"{len(self.lanes)}")
        r0, r1 = self._row_span(lo, hi)
        lanes = self.lanes[lo:hi].copy()
        lanes[:, 0] -= r0
        return replace(self, data=self.data[lo:hi], dlen=self.dlen[lo:hi],
                       lanes=lanes, rows=self.rows[r0:r1],
                       lane_request=self.lane_request[lo:hi])

    def owned_blocks(self, lo: int, hi: int) -> np.ndarray:
        """int64 indices of the blocks that lanes lo..hi-1 write: every
        block of each of their rows that decodes (a row cut by early EOF
        decodes its first `width` blocks, at least block 0; the rest stay
        zero)."""
        r0, r1 = self._row_span(lo, hi)
        width = self.rows[r0:r1, 2].astype(np.int64)
        start = self.rows[r0:r1, 6].astype(np.int64)
        before = np.cumsum(width) - width
        return (np.repeat(start - before, width)
                + np.arange(int(width.sum()), dtype=np.int64))


def _ans_words(stream: bytes) -> np.ndarray:
    """A v3 stream as little-endian uint32 words, short trailing bytes
    zero-filled (pallas_decode.py:899-913, like ANSReader)."""
    return np.frombuffer(stream + b"\x00" * (-len(stream) % 4), "<u4")


def plan_decode(requests, coder: str = "vpx") -> DecodePlan:
    """Plan many requests' segments as the lanes of one kernel launch.

    Each request is a dict with keys streams, plane_shapes, color_tables,
    mcuv, max_coded_heights, component_sizes, splits_y and color_index
    (the request of lepton_tpu.kernels.pallas_decode
    .decode_segments_pallas_multi).  Row descriptors as in
    decode_segments_pallas_multi (:858-896): has_above is false on the
    first row of each component within a segment; a row cut by early EOF
    decodes min(W, component_sizes[c] - y * W) blocks, and at least its
    first: the host codec tests the limit after each block (leptonc.c
    process_row), so a row that the cut leaves past the limit still
    decodes block 0 (the JAX readers decode none of it,
    pallas_decode.py:874).  coder: "vpx" for the streams of containers
    v1 and v2, "ans" for those of v3."""
    if coder not in CODERS:
        raise ValueError(f"no {coder!r} reader")
    rows, lanes, streams, tables, planes, lane_request = [], [], [], [], [], []
    n_blocks = 0
    ring_width, ring_comps = 1, 1
    for ri, rq in enumerate(requests):
        shapes = rq["plane_shapes"]
        ncomp = len(shapes)
        if ncomp > MAX_TABLES:
            raise ValueError(f"request {ri}: {ncomp} components")
        heights = [h for h, _ in shapes]
        widths = [w for _, w in shapes]
        ring_width = max(ring_width, max(widths))
        ring_comps = max(ring_comps, ncomp)
        offsets = []
        for h, w in shapes:
            offsets.append(n_blocks)
            n_blocks += h * w
        planes.append([(o, h, w) for o, (h, w) in zip(offsets, shapes)])
        tab0 = len(tables)
        for ct in rq["color_tables"]:
            tables.append(np.stack([
                np.asarray(t, np.int64) for t in (
                    ct.quant, ct.icos_idct_edge_8192_dequantized_x,
                    ct.icos_idct_edge_8192_dequantized_y,
                    ct.min_noise_threshold)]).astype(np.int32))
        plans = plan_rows(heights, rq["mcuv"], rq["max_coded_heights"],
                          rq["splits_y"])
        if len(plans) != len(rq["streams"]):
            raise ValueError(f"request {ri}: {len(rq['streams'])} streams "
                             f"for {len(plans)} segments")
        cix = rq.get("color_index")
        sizes = rq["component_sizes"]
        for plan, stream in zip(plans, rq["streams"]):
            first = {}
            row0 = len(rows)
            for comp, y in plan:
                first.setdefault(comp, y)
                W = widths[comp]
                ci = (0 if comp == 0 else 1) if cix is None else cix(comp)
                rows.append((comp, ci, min(W, max(1, sizes[comp] - y * W)),
                             W, int(y != first[comp]), tab0 + comp,
                             offsets[comp] + y * W))
            lanes.append((row0, len(rows) - row0, tab0, ncomp))
            streams.append(stream)
            lane_request.append(ri)
    S = len(streams)
    if coder == "ans":
        streams = [_ans_words(b) for b in streams]
        data = np.zeros((S, max([len(w) for w in streams] + [4])), np.uint32)
    else:
        streams = [np.frombuffer(b, np.uint8) for b in streams]
        data = np.zeros((S, max([len(b) for b in streams], default=0) + 4),
                        np.uint8)
    for s, b in enumerate(streams):
        data[s, :len(b)] = b
    return DecodePlan(
        data=data.view(np.int32) if coder == "ans" else data,
        dlen=np.asarray([len(b) for b in streams], np.int32),
        lanes=np.asarray(lanes, np.int32).reshape(S, len(LANE_FIELDS)),
        rows=np.asarray(rows, np.int32).reshape(-1, len(ROW_FIELDS)),
        tables=np.asarray(tables, np.int32).reshape(-1, TABLE_ROWS, 64),
        ring_width=ring_width, ring_comps=ring_comps, n_blocks=n_blocks,
        planes=planes, lane_request=lane_request, coder=coder)


def split_planes(plan: DecodePlan, coef, err) -> list:
    """Per request (planes [H_c, W_c, 64] int16 views of coef, err bool
    [segments]); coef and err are torch tensors or numpy arrays."""
    lane_request = np.asarray(plan.lane_request)
    out = []
    for ri, geo in enumerate(plan.planes):
        planes = [coef[o:o + h * w].reshape(h, w, 64) for o, h, w in geo]
        lo, hi = np.flatnonzero(lane_request == ri)[[0, -1]].tolist()
        out.append((planes, err[lo:hi + 1]))
    return out


def merge_shares(plan: DecodePlan, shares, device):
    """The decode of the whole plan from its lane shares: shares is a list
    of (lo, hi, coef, err), one per plan.share(lo, hi) launch, in lane
    order and covering every lane.  Each block is taken from the share
    whose lanes own its row (plan.owned_blocks), never by its value: an
    all-zero block is a legal decode.  err is concatenated in lane order.
    Returns (coef int16 [n_blocks, 64], err int32 [S]) on `device`, as
    decode_lanes returns them for the whole plan."""
    dev = torch.device(device)
    if [lo for lo, *_ in shares] != [0] + [hi for _, hi, *_ in shares[:-1]] \
            or (shares[-1][1] if shares else 0) != len(plan.lanes):
        raise ValueError("lane shares must cover the plan's lanes in order")
    coef = torch.zeros((plan.n_blocks, 64), dtype=torch.int16, device=dev)
    for lo, hi, c, _ in shares:
        blocks = torch.as_tensor(plan.owned_blocks(lo, hi))
        coef[blocks.to(dev)] = c[blocks.to(c.device)].to(dev)
    err = torch.cat([e.to(dev) for *_, e in shares]) if shares \
        else torch.zeros(0, dtype=torch.int32, device=dev)
    return coef, err


def cache_slots() -> int:
    """Entries of each CTA's branch cache: 192 KB, over five times the
    4,000 to 4,500 distinct branches a lane of a 12 MP photo touches, so
    that an 8-slot linear probe almost never finds its slots full."""
    return 24576


def smem_bytes(slots: int) -> int:
    """Dynamic shared memory of one CTA with a cache of `slots` entries."""
    return FIXED_SMEM + CACHE_ENTRY_BYTES * slots


def cache_fill(branches, slots: int) -> tuple:
    """(inserts, fall-through reads, distinct branches) of one lane's
    branch cache, replayed: `branches` is the lane's reads' branch indices
    in order (int array).  Each distinct branch, in order of first use,
    takes the first empty slot of its CACHE_PROBES probed ones or, finding
    none, sends every read of it to the arena."""
    b = np.asarray(branches, np.int64).ravel()
    if not len(b):
        return 0, 0, 0
    uniq, first, counts = np.unique(b, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    keys = (uniq[order] + 1) & 0xFFFFFFFF
    home = ((keys * CACHE_HASH) & 0xFFFFFFFF) * slots >> 32
    taken = np.zeros(slots, bool)
    inserts = falls = 0
    for h, n in zip(home.tolist(), counts[order].tolist()):
        for i in range(CACHE_PROBES):
            slot = (h + i) % slots
            if not taken[slot]:
                taken[slot] = True
                inserts += 1
                break
        else:
            falls += n
    return inserts, falls, len(uniq)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/vpx_decoder.cu."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.vpx_decoder_launch.argtypes = [
        p, i64, p, p, i64, p, p, p, p, p, i, p, i, i, p, p, i, p, i, p]
    lib.vpx_decoder_launch.restype = i
    lib.vpx_decoder_error_string.argtypes = [i]
    lib.vpx_decoder_error_string.restype = ctypes.c_char_p
    return lib


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(cuda_build.load("vpx_decoder"))
    return _lib


def _check(data, dlen, lanes, rows, tables, ring_width, ring_comps,
           n_blocks, template, coder) -> None:
    """Device, dtype, shape and index checks: the kernel indexes every
    buffer unchecked."""
    dev = data.device
    if coder not in CODERS:
        raise ValueError(f"no {coder!r} reader")
    ans = coder == "ans"
    for name, t, dt in (("data", data, torch.int32 if ans else torch.uint8),
                        ("dlen", dlen, torch.int32),
                        ("lanes", lanes, torch.int32),
                        ("rows", rows, torch.int32),
                        ("tables", tables, torch.int32)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}")
    S = data.shape[0]
    if (data.dim() != 2 or dlen.shape != (S,)
            or lanes.shape != (S, len(LANE_FIELDS))
            or rows.dim() != 2 or rows.shape[1] != len(ROW_FIELDS)
            or tables.dim() != 3 or tables.shape[1:] != (TABLE_ROWS, 64)):
        raise ValueError("decode inputs have the wrong shapes")
    if template is not None and (
            template.shape != (ARENA_SIZE,) or template.dtype != torch.int32
            or template.device != dev):
        raise ValueError(f"template must be int32 [{ARENA_SIZE}] on {dev}")
    ln = lanes.cpu().numpy().astype(np.int64)
    rw = rows.cpu().numpy().astype(np.int64)
    dl = dlen.cpu().numpy()
    # the VPX reader may fetch 4 bytes past dlen; the rANS reader reads no
    # word at or past dlen
    if S and (dl.min() < 0 or dl.max() > data.shape[1] - (0 if ans else 4)):
        raise ValueError("dlen must lie in [0, Lmax - 4] (bytes) or "
                         "[0, Lmax] (words)")
    row0, nrows, tab0, ntab = ln.T if S else np.zeros((4, 0), np.int64)
    if S and (nrows.min() < 0 or nrows.sum() != len(rw)
              or (row0 != np.cumsum(nrows) - nrows).any()
              or tab0.min() < 0 or (tab0 + ntab).max() > len(tables)
              or ntab.min() < 1 or ntab.max() > MAX_TABLES):
        raise ValueError("lane descriptors out of range (each lane's rows "
                         "follow the previous lane's)")
    if len(rw):
        comp, ci, width, W, has_above, ctab, ob = rw.T
        lane_of_row = np.repeat(np.arange(S), nrows)
        if (comp.min() < 0 or comp.max() >= ring_comps
                or ci.min() < 0 or ci.max() >= C.BLOCK_TYPES
                or width.min() < 0 or (width > W).any()
                or W.max() > ring_width
                or (ctab < tab0[lane_of_row]).any()
                or (ctab >= (tab0 + ntab)[lane_of_row]).any()
                or ob.min() < 0 or (ob + width).max() > n_blocks
                or ((has_above != 0) & (ob < W)).any()):
            raise ValueError("row descriptors out of range")


def decode_lanes(data: torch.Tensor, dlen: torch.Tensor, lanes: torch.Tensor,
                 rows: torch.Tensor, tables: torch.Tensor, ring_width: int,
                 ring_comps: int, n_blocks: int,
                 template: Optional[torch.Tensor] = None,
                 coder: str = "vpx"):
    """Decode every lane of a DecodePlan (DecodePlan.to gives the inputs).

    template: optional int32 [ARENA_SIZE] start arena in the coder layout
    (model.tables.arena_from_template); default: every branch (1, 1, 128).
    coder: the streams' reader, "vpx" (bytes) or "ans" (words).
    Returns (coef int16 [n_blocks, 64], err int32 [S]) on the input's
    device: every plane of every request, raster coefficients per block,
    and each lane's sticky stream-inconsistency flag.  CUDA tensors run
    the kernel (each launch with the VPX reader counts in
    decode_lanes.launches, each with the rANS reader in
    decode_lanes.ans_launches); CPU tensors run the plain version.

    The kernel runs a CTA a lane; its first warp runs the reads (every
    lane the same ones) and splits each block's 64-wide work across its
    lanes, and every read looks its branch up in the CTA's cache of
    cache_slots() entries in shared memory, going to the lane's arena in
    device memory only on a branch's first use or when the branch's probed
    slots are taken (see csrc/vpx_decoder.cu).  After each
    launch decode_lanes.cache_counts holds its int32 [S, 2] (inserts,
    fall-through reads) a lane, on the card and not synchronised.  A cache
    whose shared memory the card refuses raises."""
    if data.device.type == "cpu":
        return decode_lanes_plain(data, dlen, lanes, rows, tables,
                                  ring_width, ring_comps, n_blocks, template,
                                  coder)
    if data.device.type != "cuda":
        raise ValueError(f"no token decoder for device {data.device}")
    _check(data, dlen, lanes, rows, tables, ring_width, ring_comps,
           n_blocks, template, coder)
    dev = data.device
    S = data.shape[0]
    coef = torch.zeros((n_blocks, 64), dtype=torch.int16, device=dev)
    err = torch.zeros(S, dtype=torch.int32, device=dev)
    if S == 0:
        return coef, err
    slots = cache_slots()
    if slots < 1 or smem_bytes(slots) > SMEM_LIMIT:
        raise ValueError(f"a branch cache of {slots} slots needs "
                         f"{smem_bytes(slots)} bytes of shared memory, "
                         f"over {SMEM_LIMIT}")
    lib = _get_lib()
    data, dlen, lanes, rows, tables = (t.contiguous() for t in (
        data, dlen, lanes, rows, tables))
    luts = torch.as_tensor(build_luts(), device=dev)
    # scratch: one model arena and one summary ring per lane, both filled
    # or written before they are read
    arena = torch.empty((S, ARENA_SIZE), dtype=torch.int32, device=dev)
    ring = torch.empty((S, ring_comps * ring_width, SUMMARY),
                       dtype=torch.int32, device=dev)
    counts = torch.zeros((S, 2), dtype=torch.int32, device=dev)
    rc = lib.vpx_decoder_launch(
        data.data_ptr(), data.shape[1], dlen.data_ptr(), lanes.data_ptr(), S,
        rows.data_ptr(), tables.data_ptr(), luts.data_ptr(),
        None if template is None else template.data_ptr(),
        arena.data_ptr(), ARENA_SIZE, ring.data_ptr(), ring_comps * ring_width,
        ring_width, coef.data_ptr(), err.data_ptr(), slots,
        counts.data_ptr(), CODERS[coder],
        torch.cuda.current_stream(dev).cuda_stream)
    if coder == "ans":
        cuda_build.count_launch(decode_lanes, "ans_launches")
    else:
        cuda_build.count_launch(decode_lanes)
    decode_lanes.cache_counts = counts
    if rc:
        raise RuntimeError("vpx_decoder launch failed: "
                           + lib.vpx_decoder_error_string(rc).decode())
    return coef, err


decode_lanes.launches = 0
decode_lanes.ans_launches = 0
decode_lanes.cache_counts = None


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 32768) & 0xFFFF) - 32768


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _div2_tz(v: torch.Tensor) -> torch.Tensor:
    return torch.sign(v) * (torch.abs(v) >> 1)


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    return bit_length(v.to(torch.int32)).to(torch.int64)


class _Lanes:
    """The VPX readers and model arenas of S lanes, advanced together: one
    read per call, on the lanes of its `active` mask (boolreader.hh:376-416
    with the 32-bit window of pallas_decode.py:290-328)."""

    def __init__(self, data, dlen, template):
        dev = data.device
        S = data.shape[0]
        i64 = torch.int64
        self.lanes = torch.arange(S, device=dev)
        self.base = self.lanes * ARENA_SIZE
        self.data = data.to(i64)
        self.dlen = dlen.to(i64)
        if template is None:
            self.arena = torch.full((S, ARENA_SIZE), IDENTITY_BRANCH,
                                    dtype=i64, device=dev)
        else:
            self.arena = template.to(i64).expand(S, ARENA_SIZE).clone()
        self.value = torch.zeros(S, dtype=i64, device=dev)
        self.rng = torch.full((S,), 255, dtype=i64, device=dev)
        self.count = torch.full((S,), -8, dtype=i64, device=dev)
        self.pos = torch.zeros(S, dtype=i64, device=dev)
        self.norm = torch.as_tensor(C.VPX_NORM, dtype=i64, device=dev)
        self.four = torch.arange(4, device=dev)
        # every branch's next state: index (tc << 8 | fc) << 1 | bit
        state = torch.arange(1 << 17, device=dev)
        self.next = branch_update((state >> 1) & 0xFF, (state >> 9) & 0xFF,
                                  (state & 1) != 0)

    def _refill(self, active):
        need = active & (self.count < 0)
        if not bool(need.any()):
            return
        # bytes while shift = 16 - count stays >= 0; past the stream's end
        # LOTS_OF_BITS once instead (the padding bytes are zero)
        shift = 16 - self.count
        want = (shift >> 3) + 1
        avail = self.dlen - self.pos
        take = torch.minimum(want, avail)
        b = self.data[self.lanes[:, None], self.pos[:, None] + self.four]
        sh = shift[:, None] - 8 * self.four
        add = torch.where(self.four < take[:, None],
                          b << sh.clamp(min=0), 0).sum(1)
        self.value = torch.where(need, self.value | add, self.value)
        self.count = torch.where(
            need, self.count + 8 * take
            + torch.where(avail < want, LOTS_OF_BITS, 0), self.count)
        self.pos = torch.where(need, self.pos + take, self.pos)

    def _bit(self, prob, active):
        """One bool read at prob on the active lanes: the bits, False on
        inactive lanes."""
        self._refill(active)
        split = (self.rng * prob + 256 - prob) >> 8
        big = split << 24
        bit = (self.value >= big) & active
        rng2 = torch.where(bit, self.rng - split, split)
        sh = torch.where(active, self.norm[rng2], 0)
        self.value = ((self.value - big * bit) << sh) & 0xFFFFFFFF
        self.rng = torch.where(active, rng2 << sh, self.rng)
        self.count = self.count - sh
        return bit

    def read(self, idx, active):
        """One read on the active lanes; idx int64 [S] is the branch of
        each lane (clamped into the arena), None for probability 128 with
        no update.  Returns the bits, 0 on inactive lanes."""
        if idx is None:
            prob = 128
        else:
            flat = self.base + idx.clamp(0, ARENA_SIZE - 1)
            packed = torch.take(self.arena, flat)
            prob = (packed >> 16) & 0xFF
        bit = self._bit(prob, active).to(torch.int64)
        if idx is not None:
            new = self.next[((packed & 0xFFFF) << 1) | bit]
            self.arena.view(-1)[flat] = torch.where(active, new, packed)
        return bit

    def tree(self, nbits, base, stride, active):
        """MSB-first binary tree: bit i at base + i * stride + so_far."""
        v = torch.zeros_like(base)
        so_far = torch.zeros_like(base)
        for i in range(nbits - 1, -1, -1):
            bit = self.read(base + i * stride + so_far, active)
            v |= bit << i
            so_far = (so_far << 1) | bit
        return v

    def exponent(self, base, active):
        """Unary exponent: reads at base + i while the bits are 1, at most
        MAX_EXPONENT reads.  Returns the number of 1 bits."""
        length = torch.zeros_like(base)
        cont = active.clone()
        for i in range(C.MAX_EXPONENT):
            if not bool(cont.any()):
                break
            bit = self.read(base + i, cont)
            cont = cont & (bit != 0)
            length += cont.to(torch.int64)
        return length

    def sign_residual(self, length, sign_idx, res_base, active):
        """Sign bit, then residual bits length-2 down to 0 at res_base + i:
        every one of them, as the host codec reads them (leptonc.c
        decode_block), up to COEF_BITS for the longest exponent.  Returns
        (sign bit, magnitude bits)."""
        sbit = self.read(sign_idx, active)
        acc = torch.zeros_like(length)
        for j in range(C.COEF_BITS):
            i = length - 2 - j
            cur = active & (i >= 0)
            if not bool(cur.any()):
                break
            i = i.clamp(min=0)
            acc |= self.read(res_base + i, cur) << i
        return sbit, acc


class _AnsLanes(_Lanes):
    """The rANS readers and model arenas of S lanes, advanced together,
    with the interface of _Lanes (pallas_decode.py ans_step :330-360, init
    :436-440): two alternating states a lane, the word at pos shifted in
    when a state drops below 2^31, words past the end read as zero, and
    the adv update rule.  The states are uint64 held in int64: products
    and sums wrap alike, x >> 8 masks off the sign, and the renormalisation
    test is unsigned."""

    def __init__(self, data, dlen, template):
        super().__init__(data, dlen, template)
        self.data = data.to(torch.int64) & 0xFFFFFFFF
        self.next = next_state_adv(data.device)
        w = [self._word(torch.full_like(self.pos, k)) for k in range(4)]
        self.r0 = w[0] | (w[1] << 32)
        self.r1 = w[2] | (w[3] << 32)
        self.pos = torch.full_like(self.pos, 4)

    def _word(self, k):
        w = self.data[self.lanes, k.clamp(0, self.data.shape[1] - 1)]
        return torch.where(k < self.dlen, w, 0)

    def _bit(self, prob, active):
        x = self.r0
        cum = x & 0xFF
        bit = cum >= prob
        start = torch.where(bit, prob, 0)
        freq = torch.where(bit, 256 - prob, prob)
        x = freq * ((x >> 8) & ((1 << 56) - 1)) + cum - start
        renorm = (x >= 0) & (x < RANS64_L)
        x = torch.where(renorm, (x << 32) | self._word(self.pos), x)
        self.pos = torch.where(active & renorm, self.pos + 1, self.pos)
        self.r0 = torch.where(active, self.r1, self.r0)
        self.r1 = torch.where(active, x, self.r1)
        return bit & active


def _signed(length, sbit, magnitude):
    v = magnitude | (1 << (length - 1).clamp(min=0))
    return torch.where(sbit == 0, -v, v)


def _lane_blocks(lanes: np.ndarray, rows: np.ndarray):
    """Per step t and lane s the t-th block of lane s: [T, S] arrays of its
    row and its x, and live."""
    S = len(lanes)
    per_lane = []
    for s in range(S):
        row0, nrows = int(lanes[s, 0]), int(lanes[s, 1])
        widths = rows[row0:row0 + nrows, 2]
        r = np.repeat(np.arange(row0, row0 + nrows), widths)
        x = np.concatenate([np.arange(w) for w in widths]) if nrows \
            else np.zeros(0, np.int64)
        per_lane.append((r, x))
    T = max([len(r) for r, _ in per_lane], default=0)
    row = np.zeros((T, S), np.int64)
    xs = np.zeros((T, S), np.int64)
    live = np.zeros((T, S), bool)
    for s, (r, x) in enumerate(per_lane):
        row[:len(r), s] = r
        xs[:len(x), s] = x
        live[:len(r), s] = True
    return row, xs, live


def decode_lanes_plain(data, dlen, lanes, rows, tables, ring_width: int,
                       ring_comps: int, n_blocks: int, template=None,
                       coder: str = "vpx"):
    """The kernel's plain PyTorch version, same contract as decode_lanes.

    A lockstep loop over blocks, vectorized over lanes with masks, with
    the semantics of lepton_tpu/kernels/vpx_decode.decode_blocks_scan
    (:397-760): every read advances only the lanes that read, and each
    data-dependent loop runs while any lane still reads.  Arithmetic is
    int64 with explicit wraps where the reference wraps (int16 stores and
    summaries, the int32 Lakhani sum) and truncating divisions where it
    truncates."""
    _check(data, dlen, lanes, rows, tables, ring_width, ring_comps,
           n_blocks, template, coder)
    dev = data.device
    i64 = torch.int64
    S = data.shape[0]
    L = build_luts().astype(np.int64)
    lay = iter(L[LUT_LAYOUT:].tolist())
    off, stride = {}, {}
    for name in _LAYOUT_TABLES:
        off[name] = next(lay)
        stride[name] = [next(lay) for _ in TABLE_STRIDES[name][:-1]]
    unzig, nz_bin_np, nz73_np = L[:49], L[64:114], L[128:178]
    nz_bin = torch.as_tensor(nz_bin_np, device=dev)
    nz73_lut = torch.as_tensor(nz73_np, device=dev)

    rows_np = rows.cpu().numpy().astype(np.int64)
    step_row, step_x, step_live = _lane_blocks(
        lanes.cpu().numpy().astype(np.int64), rows_np)
    rows64 = rows.to(i64)
    tabs = tables.to(i64)

    rd = (_AnsLanes if coder == "ans" else _Lanes)(data, dlen, template)
    coef = torch.zeros((n_blocks + 1, 64), dtype=torch.int16, device=dev)
    ring = torch.zeros((S, ring_comps * ring_width, SUMMARY), dtype=i64,
                       device=dev)
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    if S == 0:
        return coef[:n_blocks], err.to(torch.int32)
    if coder == "vpx":
        # marker bit (vpx_reader_init), probability 128
        rd.read(None, torch.ones(S, dtype=torch.bool, device=dev))

    zeros64 = torch.zeros((S, 64), dtype=i64, device=dev)
    left, al = zeros64, zeros64
    left_vert = torch.zeros((S, 8), dtype=i64, device=dev)
    nz_left_blk = torch.zeros(S, dtype=i64, device=dev)
    odd = torch.as_tensor([1, -1, 1, -1, 1, -1, 1], dtype=i64, device=dev)
    big = 1 << 30

    for t in range(step_row.shape[0]):
        live = torch.as_tensor(step_live[t], device=dev)
        desc = rows64[torch.as_tensor(step_row[t], device=dev)]
        comp, ci, _, W, ha, ctab, ob = desc.unbind(1)
        x = torch.as_tensor(step_x[t], device=dev)
        hl = live & (x > 0)
        ha = live & (ha != 0)
        quant, icx, icy, mnt = tabs[ctab].unbind(1)
        slot = comp * ring_width + x
        above = torch.where(ha[:, None],
                            coef[(ob + x - W).clamp(min=0)].to(i64), 0)
        summ_a = torch.where(ha[:, None], ring[rd.lanes, slot], 0)
        left = torch.where(hl[:, None], left, 0)
        al = torch.where((hl & ha)[:, None], al, 0)

        # ---- 7x7 nonzero count (decoder.cc:171-185)
        nzl = torch.where(hl, nz_left_blk, 0)
        nza = summ_a[:, 0]
        nz_ctx = torch.where(hl & ha, (nza + nzl + 2) >> 2,
                             torch.where(ha, (nza + 1) >> 1,
                                         torch.where(hl, (nzl + 1) >> 1, 0)))
        s7 = stride["nz_7x7"]
        base = (off["nz_7x7"] + ci * s7[0]
                + nz_bin[nz_ctx.clamp(0, 49)] * s7[1])
        nz7 = rd.tree(6, base, s7[2], live)
        err |= live & (nz7 > 49)
        nz7 = nz7.clamp(max=49)

        # ---- 49 interior coefficients (decoder.cc:200-240)
        both = ((13 * (left.abs() + above.abs()) + 6 * al.abs())
                & 0xFFFF) >> 5
        aavrg = torch.where((hl & ha)[:, None], both,
                            torch.where(hl[:, None], left.abs(), above.abs()))
        bsr_all = _bitlen(aavrg.clamp(max=1023))
        se, sr, ss = (stride["exp_7x7"], stride["residual_noise"],
                      stride["sign"])
        sign_base = off["sign"] + ci * ss[0]
        exp7_base = off["exp_7x7"] + ci * se[0]
        res_base = off["residual_noise"] + ci * sr[0]
        here = torch.zeros((S, 64), dtype=i64, device=dev)
        nz_left = nz7.clone()
        eob_x = torch.zeros(S, dtype=i64, device=dev)
        eob_y = torch.zeros(S, dtype=i64, device=dev)
        for zz in range(49):
            act = live & (nz_left > 0)
            if not bool(act.any()):
                break
            coord = int(unzig[zz])
            nnzb = nz_bin[nz_left.clamp(0, 49)]
            length = rd.exponent(exp7_base + nnzb * se[1] + zz * se[2]
                                 + bsr_all[:, coord] * se[3], act)
            nonzero = act & (length > 0)
            sbit, mag = rd.sign_residual(
                length, sign_base, res_base + coord * sr[1] + nnzb * sr[2],
                nonzero)
            here[:, coord] = torch.where(nonzero, _signed(length, sbit, mag),
                                         here[:, coord])
            nz_left -= nonzero.to(i64)
            eob_x = torch.where(nonzero, eob_x.clamp(min=coord & 7), eob_x)
            eob_y = torch.where(nonzero, eob_y.clamp(min=coord >> 3), eob_y)

        # ---- edges, horizontal then vertical (decode_one_edge :29-142)
        nz73 = nz73_lut[nz7]
        sx, st = stride["exp_x"], stride["residual_thresh"]
        expx_base = off["exp_x"] + ci * sx[0]
        rt_base = off["residual_thresh"] + ci * st[0]
        for horizontal in (True, False):
            if horizontal:
                name, zig15, delta, est_eob = "nz_8x1", 0, 1, eob_x
                nb, nb_has = above, ha
            else:
                name, zig15, delta, est_eob = "nz_1x8", 7, 8, eob_y
                nb, nb_has = left, hl
            tn = stride[name]
            remaining = rd.tree(3, off[name] + ci * tn[0] + est_eob * tn[1]
                                + nz73 * tn[2], tn[3], live)
            for k in range(7):
                act = live & (remaining > 0)
                if not bool(act.any()):
                    break
                band = (k + 1) * delta
                # Lakhani prediction (model.hh:1033-1071), int32 wraps
                if horizontal:
                    hx, na = here[:, band::8], nb[:, band::8]
                    ic = icx[:, band * 8:band * 8 + 8]
                else:
                    hx, na = here[:, band:band + 8], nb[:, band:band + 8]
                    ic = icy[:, band:band + 8]
                pred = _wrap32(na[:, 0] * ic[:, 0] - (
                    ic[:, 1:] * (hx[:, 1:] + odd * na[:, 1:])).sum(1))
                bp = torch.where(nb_has, torch.div(
                    pred, ic[:, 0], rounding_mode="trunc"), 0)
                absbp = bp.abs()
                bsr = _bitlen(absbp.clamp(max=1023))
                length = rd.exponent(expx_base + remaining * sx[1]
                                     + (zig15 + k) * sx[2] + bsr * sx[3],
                                     act)
                nonzero = act & (length > 0)
                ctx1 = torch.where(bp == 0, 0, torch.where(bp > 0, 1, 2))
                sbit = rd.read(sign_base + ctx1 * ss[1] + bsr, nonzero)
                mt = mnt[:, band]
                thresh = (rt_base + (absbp >> mt).clamp(max=255) * st[1]
                          + (length - mt).clamp(max=C.RESIDUAL_NOISE_FLOOR)
                          * st[2])
                res = res_base + band * sr[1] + remaining * sr[2]
                mag = torch.zeros(S, dtype=i64, device=dev)
                dsf = torch.ones(S, dtype=i64, device=dev)
                for j in range(C.COEF_BITS):
                    i = length - 2 - j
                    cur = nonzero & (i >= 0)
                    if not bool(cur.any()):
                        break
                    i = i.clamp(min=0)
                    is_th = i >= mt
                    bit = rd.read(torch.where(is_th, thresh + dsf, res + i),
                                  cur)
                    mag |= bit << i
                    dsf = torch.where(cur & is_th, ((dsf << 1) | bit).clamp(
                        max=(1 << C.RESIDUAL_NOISE_FLOOR) - 1), dsf)
                here[:, band] = torch.where(
                    nonzero, _signed(length, sbit, mag), here[:, band])
                remaining -= nonzero.to(i64)

        # ---- DC last (decoder.cc:243-287 + model.hh:674-784)
        pixels = idct_blocks(here, quant).to(i64).reshape(S, 8, 8)
        col0, col1 = pixels[:, :, 0], pixels[:, :, 1]
        row0, row1 = pixels[:, 0, :], pixels[:, 1, :]
        est_l = _wrap16(left_vert - _div2_tz(col0 - col1) - (col0 + 1024))
        est_a = _wrap16(summ_a[:, 1:9] - _div2_tz(row0 - row1)
                        - (row0 + 1024))
        hl1, ha1 = hl[:, None], ha[:, None]
        mins = torch.minimum(torch.where(hl1, est_l, big).amin(1),
                             torch.where(ha1, est_a, big).amin(1))
        maxs = torch.maximum(torch.where(hl1, est_l, -big).amax(1),
                             torch.where(ha1, est_a, -big).amax(1))
        sum_le = torch.where(hl1, est_l, 0).sum(1)
        sum_ae = torch.where(ha1, est_a, 0).sum(1)
        avg_h = torch.where(hl, sum_le, sum_ae)
        avg_v = torch.where(hl & ha, sum_ae, avg_h)
        overall = (avg_h + avg_v) >> 1
        any_n = hl | ha
        unc = torch.where(any_n, (maxs - mins) >> 3, 0)
        dh, dv = avg_h - overall, avg_v - overall
        unc2 = torch.where(any_n, torch.where(dh.abs() < dv.abs(), dh, dv)
                           >> 3, 0)
        avgmed = torch.where(any_n, overall, 0)
        q0 = quant[:, 0]
        pred_dc = (torch.div(avgmed, q0, rounding_mode="trunc") + 4) >> 3
        lm = _bitlen(unc.abs()).clamp(max=C.NUMERIC_LENGTH_MAX - 1)
        lo = _bitlen(unc2.abs()).clamp(max=16)
        sd = stride["exp_dc"]
        length = rd.exponent(off["exp_dc"] + lm * sd[0] + lo * sd[1], live)
        nonzero = live & (length > 0)
        sctx = torch.where(unc2 < 0, 1, torch.where(unc2 == 0, 3, 2))
        sbit, mag = rd.sign_residual(
            length, sign_base + sctx,
            off["residual_noise_dc"] + lm * stride["residual_noise_dc"][0],
            nonzero)
        max_value = 1 << (C.MAX_EXPONENT - 1)
        dc = torch.where(nonzero, _signed(length, sbit, mag), 0) + pred_dc
        dc = torch.where(dc < -max_value, dc + 2 * max_value + 1, dc)
        dc = torch.where(dc > max_value, dc - 2 * max_value - 1, dc)
        here[:, 0] = dc

        # ---- outgoing neighbour summary (NeighborSummary set_*)
        col7, col6 = pixels[:, :, 7], pixels[:, :, 6]
        row7, row6 = pixels[:, 7, :], pixels[:, 6, :]
        dcq = (dc * q0)[:, None]
        vert = _wrap16(dcq + col7 + 1024 + _div2_tz(col7 - col6))
        horiz = _wrap16(dcq + row7 + 1024 + _div2_tz(row7 - row6))
        here_w = _wrap16(here)
        coef[torch.where(live, ob + x, n_blocks)] = here_w.to(torch.int16)
        ring[rd.lanes, slot] = torch.where(
            live[:, None], torch.cat([nz7[:, None], horiz], 1),
            ring[rd.lanes, slot])
        live1 = live[:, None]
        left = torch.where(live1, here_w, left)
        al = torch.where(live1, above, al)
        left_vert = torch.where(live1, vert, left_vert)
        nz_left_blk = torch.where(live, nz7, nz_left_blk)
    return coef[:n_blocks], err.to(torch.int32)
