"""Many devices of one process: a ('data', 'seg') mesh.

Port of lepton_tpu/parallel/mesh.py.  The codec's parallel structure
(SURVEY.md section 2.5): images are independent, and within an image up to
255 segments are independent arithmetic streams.  On a grid of devices the
images go over the 'data' rows and one image's segments (or one .lep's
lanes) over the 'seg' devices of a row; the priors and quantization tables
derive from the header, and each device's finished streams are gathered on
the host in file order (the MuxWriter role).  No collective runs on the
hot path.

Mesh stands in for jax.sharding.Mesh: a grid of this process's devices
with named axes.  torch.distributed's DeviceMesh does not fit, as it holds
one device a rank and needs a process group.  A Mesh may name one device
more than once (a single card then runs the split-and-merge code with real
launches).  Each CUDA device's work runs on a thread and a stream of its
own, and "cpu" entries run in turn (on_devices).  This module owns every
split of work over devices: the mesh routes here, and the lane shares of
api.batch_decompress_device(mesh=) (decode_shares).
"""
from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import api, host
from ..container.mux import mux_streams
from ..kernels import batch_encode, vpx_decoder
from ..kernels.contexts import phase_a
from ..util import timing

# host.compress arguments that the card route takes, with their defaults;
# any other argument of host.compress it honours only at its default value
CARD_KW = dict(max_threads=8, version=1, allow_progressive=False,
               allow_four_colors=False)
HOST_ONLY_KW = dict(min_threads=1, even_split=False, start_byte=0,
                    embedding=0, allow_34_sampling=False)


class Mesh:
    """A grid of torch devices with named axes (jax.sharding.Mesh's role).

    devices: an array-like of devices (torch.device or str), one axis per
    name; repeats are allowed.  Attributes: devices (numpy object array of
    torch.device), axis_names, shape ({name: size}, as JAX's mesh.shape)
    and size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.vectorize(torch.device, otypes=[object])(arr) \
            if arr.size else arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim \
                or len(set(self.axis_names)) != arr.ndim:
            raise ValueError(f"{arr.ndim}-axis devices need as many distinct "
                             f"axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.size = int(arr.size)

    def axis_devices(self, name: str) -> list:
        """The devices along axis `name`, at index 0 of every other axis."""
        at = [0] * self.devices.ndim
        at[self.axis_names.index(name)] = slice(None)
        return list(self.devices[tuple(at)])

    def grid(self) -> np.ndarray:
        """The devices as a (data, seg) grid, whatever the axes' order."""
        if sorted(self.axis_names) != ["data", "seg"]:
            raise ValueError(f"a mesh of axes {self.axis_names} is not a "
                             "('data', 'seg') grid")
        return self.devices.transpose([self.axis_names.index("data"),
                                       self.axis_names.index("seg")])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def on_device(dev: torch.device):
    """The context a thread launches dev's kernels in: dev made the
    thread's current CUDA device (a launch goes to the current device's
    stream), nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _hand_over(obj, stream) -> None:
    """Mark every CUDA tensor in obj (nested in lists, tuples and dicts) as
    used on `stream`: the allocator then reuses its memory only after the
    work queued there by the time it is freed."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, dict):
        for v in obj.values():
            _hand_over(v, stream)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _hand_over(v, stream)


def on_devices(fn, devices) -> list:
    """[fn(k, device) for each of `devices`]: one after another on the
    CPU, whose cores torch already spreads each op over (threads there
    only contend for them and for the GIL), and one thread a CUDA device,
    on a stream of its own, so that two entries of a mesh that name one
    card run side by side too.  That stream starts after the work the
    caller queued on the device, is synchronised before fn's result is
    handed back, and the result's CUDA tensors are marked as used on the
    caller's stream.  The first error of any raises here."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cpu" for d in devices):
        return [fn(k, d) for k, d in enumerate(devices)]
    callers = [torch.cuda.current_stream(d) if d.type == "cuda" else None
               for d in devices]

    def run(k):
        dev = devices[k]
        if dev.type != "cuda":
            return fn(k, dev)
        with on_device(dev):
            own = torch.cuda.Stream(dev)
            own.wait_stream(callers[k])
            with torch.cuda.stream(own):
                out = fn(k, dev)
            own.synchronize()
            _hand_over(out, callers[k])
            return out

    with ThreadPoolExecutor(max_workers=len(devices)) as ex:
        futures = [ex.submit(run, k) for k in range(len(devices))]
        return [f.result() for f in futures]


def _share(n: int, k: int, parts: int) -> tuple:
    """The k-th of `parts` contiguous shares of n items (as
    distributed_compress splits segments over processes)."""
    return n * k // parts, n * (k + 1) // parts


def decode_shares(plan, mesh: "Mesh", template, dev: torch.device,
                  even: bool = True):
    """The plan's lanes split over the devices of the mesh's 'seg' axis,
    one decode_lanes launch a device, as decode_segments_tpu shards them
    (lepton_tpu/kernels/vpx_decode.py:883-917), then merged on dev
    (vpx_decoder.merge_shares).  even: a lane count the axis does not
    divide raises ValueError, as that function fails its assert (:898);
    with even=False the shares are as near equal as may be, over at most
    as many devices as there are lanes.  Returns (coef, err, each share's
    launch ms); the merge's seconds go to the open call's merge_s (span
    reader.merge)."""
    devices = mesh.axis_devices("seg")
    S = len(plan.lanes)
    if even and S % len(devices):
        raise ValueError(f"{S} lanes do not split evenly over the "
                         f"{len(devices)} devices of the mesh's 'seg' axis")
    devices = devices[:S]

    def share(k, d):
        lo, hi = _share(S, k, len(devices))
        tpl = None if template is None else template.to(d)
        return (lo, hi) + api._timed_decode(plan.share(lo, hi).to(d), tpl, d)

    shares = on_devices(share, devices)
    with timing.span("reader.merge", "merge_s"):
        coef, err = vpx_decoder.merge_shares(
            plan, [(lo, hi, c, e) for lo, hi, c, e, _ in shares], dev)
        batch_encode._sync(dev)
    return coef, err, [ms for *_, ms in shares]


def make_mesh(n_devices: Optional[int] = None, data_axis: int = 0,
              device=None) -> Mesh:
    """A ('data', 'seg') mesh of distinct devices, of shape (d, n // d)
    where d = int(sqrt(n)) lowered until it divides n, as
    lepton_tpu.parallel.mesh.make_mesh (:47-58) shapes it.

    device: None or "cuda" for this process's CUDA devices (the first
    n_devices of them; without CUDA it raises); "cpu" for n_devices
    entries of the CPU (1 by default), which run the kernels' plain
    versions.  data_axis is taken for the JAX signature and, as there,
    not read."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        devices = [torch.device("cpu")] * (n_devices or 1)
    else:
        api._device(kind)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices:
            if n_devices > len(devices):
                raise ValueError(f"{n_devices} devices asked for, "
                                 f"{len(devices)} present")
            devices = devices[:n_devices]
    n = len(devices)
    d = int(np.sqrt(n))
    while n % d:
        d -= 1
    return Mesh(np.array(devices, dtype=object).reshape(d, n // d),
                ("data", "seg"))


def sharded_phase_a(coef_batch, quant, icos_x, icos_y, mesh: Mesh) -> dict:
    """Phase-A context bundles over [data, seg, H, W, 64] shards
    (lepton_tpu.parallel.mesh.sharded_phase_a, :61-81): dim 0 is split
    over the mesh's 'data' axis and dim 1 over its 'seg' axis, as
    P('data', 'seg') splits them, and each shard runs
    kernels.contexts.phase_a on its device, once a [H, W, 64] plane.  No
    halo is exchanged: a segment boundary resets the above-context by
    design (is_top_row, lepton_codec.hh:173-181).

    coef_batch: int16 [D, S, H, W, 64] (numpy or tensor); quant, icos_x,
    icos_y: int32 [64].  Returns phase_a's dict, each value stacked
    [D, S, ...] on the mesh's first device.  A shape the mesh does not
    divide raises ValueError."""
    grid = mesh.grid()
    coefs = torch.as_tensor(coef_batch)
    if coefs.dim() != 5:
        raise ValueError(f"coef_batch must be [data, seg, H, W, 64], got "
                         f"{tuple(coefs.shape)}")
    (D, S), (nd, ns) = coefs.shape[:2], grid.shape
    if D % nd or S % ns:
        raise ValueError(f"a [{D}, {S}, ...] batch does not split over a "
                         f"({nd}, {ns}) mesh")
    bd, bs = D // nd, S // ns
    tables = [torch.as_tensor(t) for t in (quant, icos_x, icos_y)]

    def shard(k, dev):
        i, j = divmod(k, ns)
        part = coefs[i * bd:(i + 1) * bd, j * bs:(j + 1) * bs].to(dev)
        tabs = [t.to(dev, torch.int32) for t in tables]
        return [[phase_a(plane, *tabs) for plane in row] for row in part]

    shards = on_devices(shard, list(grid.flat))
    first = grid.flat[0]
    out = {}
    for key in shards[0][0][0]:
        rows = []
        for i in range(nd):
            for r in range(bd):
                rows.append(torch.stack([
                    shards[i * ns + j][r][c][key].to(first)
                    for j in range(ns) for c in range(bs)]))
        out[key] = torch.stack(rows)
    return out


def gather_streams_in_file_order(per_segment_streams) -> bytes:
    """The MuxWriter role: the per-segment streams interleaved in file
    order (lepton_tpu.parallel.mesh, :84-89)."""
    return mux_streams(list(per_segment_streams))


def _pool_map(fn, items, max_workers: int) -> list:
    """The host route's thread pool (lepton_tpu.parallel.mesh, :21-44)."""
    if max_workers <= 0:
        max_workers = min(16, os.cpu_count() or 1)
    if max_workers == 1 or len(items) <= 1:
        return [fn(b) for b in items]
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(fn, items))


def _card_mesh(mesh: Optional[Mesh], device) -> np.ndarray:
    return (make_mesh(device=device) if mesh is None else mesh).grid()


def batch_compress(jpeg_blobs: Sequence[bytes], max_workers: int = 0,
                   mesh: Optional[Mesh] = None, device=None, stats=None,
                   **kw) -> List[bytes]:
    """Encode many JPEGs over a mesh of devices.  Returns the .lep bytes
    of each.

    device="host": lepton_tpu.parallel.mesh.batch_compress (:21-32), a
    pool of max_workers threads over the host codec's compress(b, **kw).

    Otherwise (the card route; mesh=None means make_mesh(device=device),
    this process's CUDA devices, or "cpu" devices for device="cpu"): the
    images are split into contiguous shares over the mesh's 'data' rows,
    and within a row each image's segments into contiguous shares over
    the row's 'seg' devices (segment_range), one thread a device, as
    mesh.py:1-11 of the JAX package lays the work out.  The row's first
    device symbolizes the row's images once; each device of the row then
    assembles and codes its own lanes.  The streams are gathered in file
    order and each container written as batch_compress_device writes it.
    kw: max_threads (8), version, allow_progressive and allow_four_colors
    mean what they mean to host.compress, and with the same values the
    bytes equal the host route's; the other arguments of host.compress are
    honoured only at their defaults, and any other value raises
    ValueError (pass device="host").

    stats: optional dict (card route) that receives parse_s and the other
    keys of api._parse_images, symbolize_s and code_s (the two device
    stages' walls), mux_s, rows: one dict a 'data' row with its device,
    its images and its symbolize_s, and shares: one dict a device with its
    data row and seg column, its images and its encode_symbols stats.  A
    device's thread writes its row's or its share's dict (timing.part)."""
    if device == "host":
        if mesh is not None:
            raise ValueError("device='host' takes no mesh")
        return _pool_map(lambda b: api.compress(b, **kw), list(jpeg_blobs),
                         max_workers)
    for key, value in kw.items():
        if key not in CARD_KW and key not in HOST_ONLY_KW:
            raise TypeError(f"batch_compress got an unexpected argument "
                            f"{key!r}")
        if key in HOST_ONLY_KW and value != HOST_ONLY_KW[key]:
            raise ValueError(f"{key}={value!r} runs only on the host codec: "
                             "pass device='host'")
    opts = {**CARD_KW, **{k: v for k, v in kw.items() if k in CARD_KW}}
    if opts["version"] not in (1, 2, 3):
        raise api.LeptonError(f"no container version {opts['version']}")
    grid = _card_mesh(mesh, device)
    stats = {} if stats is None else stats
    nd, ns = grid.shape
    with timing.call(stats, "encode"):
        with timing.span("parse", "parse_s", stage="TS_JPEG_DECODE"):
            metas, descs = api._parse_images(
                jpeg_blobs, [opts["max_threads"]] * len(jpeg_blobs), False,
                opts["allow_progressive"], opts["allow_four_colors"])
        images = [_share(len(descs), r, nd) for r in range(nd)]
        rows = [dict(data=r, device=str(grid[r, 0]), images=images[r])
                for r in range(nd)]
        shares = [dict(data=k // ns, seg=k % ns, device=str(dev),
                       images=images[k // ns])
                  for k, dev in enumerate(grid.flat)]
        template = host._model_template_packed()

        def symbolize(r, dev):
            i0, i1 = images[r]
            with timing.part(rows[r]):
                return batch_encode.symbolize_images(descs[i0:i1], dev)

        def code(k, dev):
            (i0, i1), j = images[k // ns], k % ns
            ranges = [_share(len(d["splits_y"]), j, ns)
                      for d in descs[i0:i1]]
            with timing.part(shares[k]):
                return batch_encode.encode_symbols(
                    syms[k // ns].to(dev), opts["version"], template,
                    segment_range=ranges)

        with timing.span("mesh.symbolize", "symbolize_s"):
            syms = on_devices(symbolize, list(grid[:, 0]))
        with timing.span("mesh.code", "code_s"):
            parts = on_devices(code, list(grid.flat))
        del syms
        stats["rows"], stats["shares"] = rows, shares
        with timing.span("container", "mux_s", stage="TS_STREAM_MULTIPLEX"):
            out = []
            for i, (parsed, dec, splits, num_threads) in enumerate(metas):
                r = next(r for r in range(nd)
                         if images[r][0] <= i < images[r][1])
                streams = [st for k in range(r * ns, (r + 1) * ns)
                           for st in parts[k][i - images[r][0]]]
                out.append(api._container(parsed, dec, splits, num_threads,
                                          streams, opts["version"]))
    return out


def batch_decompress(lep_blobs: Sequence[bytes], max_workers: int = 0,
                     mesh: Optional[Mesh] = None, device=None,
                     stats=None) -> List[bytes]:
    """Decode many .lep files over a mesh of devices.  Returns the JPEG
    bytes of each.

    device="host": lepton_tpu.parallel.mesh.batch_decompress (:35-44), a
    pool of max_workers threads over the host codec's decompress.

    Otherwise (the card route; mesh as batch_compress takes it): the
    requests are split into contiguous shares over the mesh's 'data'
    rows, one thread a row, and each row's share goes through
    batch_decompress_device with its lanes split over the row's 'seg'
    devices (mesh=, even_shares=False: any lane count, over at most as
    many devices as there are lanes).  A request the device path does not
    cover (mode Y) raises, as batch_decompress_device does.  stats:
    optional dict (card route) that receives rows: each row's
    batch_decompress_device stats, with its device list and its
    requests."""
    if device == "host":
        if mesh is not None:
            raise ValueError("device='host' takes no mesh")
        return _pool_map(api.decompress, list(lep_blobs), max_workers)
    grid = _card_mesh(mesh, device)
    stats = {} if stats is None else stats
    nd = grid.shape[0]
    leps = list(lep_blobs)
    rows = [dict(devices=[str(d) for d in grid[r]],
                 requests=_share(len(leps), r, nd)) for r in range(nd)]

    def decode(r, dev):
        lo, hi = rows[r]["requests"]
        if lo == hi:
            return []
        return api.batch_decompress_device(
            leps[lo:hi], dev, stats=rows[r], mesh=Mesh(grid[r], ("seg",)),
            even_shares=False)

    parts = on_devices(decode, list(grid[:, 0]))
    stats["rows"] = rows
    return [out for part in parts for out in part]
