"""Many processes: a cooperative encode of one JPEG.

Port of lepton_tpu/parallel/multihost.py.  The codec's cross-process
pattern (SURVEY.md section 5): every process parses the same JPEG bytes
(the priors and tables derive from its header), codes its own contiguous
share of the segments, which are independent arithmetic streams, on its own
device, and the finished streams are gathered to every process in file
order (the MuxWriter role, reference vp8_encoder.cc:576-594).  No
collective runs on the hot path.

The processes join a torch.distributed group over gloo: what crosses
between them is host bytes, as jax's process_allgather of numpy arrays is
in the JAX package.  The JAX module's _pre_collective_barrier (:39-57),
which works round the 30 s key exchange of jax's gloo context, has no
counterpart: init_process_group is itself the rendezvous, under the
timeout given.

Two processes on one machine, each on its own device (or both on one):

    init_distributed("127.0.0.1:29500", 2, rank)   # in each, rank 0 and 1
    lep = distributed_compress(jpeg_bytes, num_segments=16)
"""
from __future__ import annotations

import datetime
from functools import partial
from typing import List

import torch
import torch.distributed as dist

from .. import api, host
from ..codec.driver import encode_segment
from ..container.handoff import select_splits
from ..jpeg.decoder import decode_scans
from ..jpeg.imageinfo import image_info_from_header
from ..jpeg.parser import parse_jpeg
from ..kernels import batch_encode
from ..util import timing
from .mesh import on_device


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     timeout_s: float = 600) -> None:
    """Join the processes' gloo group at tcp://<coordinator> (host:port);
    nothing when this process is in a group already (jax.distributed's
    idempotent initialize, multihost.py:23-36)."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def gather_streams_to_host0(streams: List[bytes]) -> List[bytes]:
    """All-gather every process's contiguous share of segment streams;
    returns the whole list in file order on every process (multihost.py:
    60-92: host 0 writes the container, and returning everywhere keeps the
    call collective-shaped).  Without a group, or in a group of one, the
    streams come back as they are.  Shares may be uneven or empty, and
    streams empty."""
    rank, nproc = _rank_world()
    if nproc == 1:
        return list(streams)
    # pad locally to a common (count, length), then all-gather as uint8
    dims = torch.tensor([len(streams), max(map(len, streams), default=0)],
                        dtype=torch.int64)
    all_dims = [torch.zeros_like(dims) for _ in range(nproc)]
    dist.all_gather(all_dims, dims)
    n_max = max(1, max(int(d[0]) for d in all_dims))
    l_max = max(1, max(int(d[1]) for d in all_dims))
    buf = torch.zeros((n_max, l_max), dtype=torch.uint8)
    lens = torch.zeros(n_max, dtype=torch.int64)
    for i, s in enumerate(streams):
        if s:
            buf[i, :len(s)] = torch.frombuffer(bytearray(s),
                                               dtype=torch.uint8)
        lens[i] = len(s)
    all_buf = [torch.zeros_like(buf) for _ in range(nproc)]
    all_len = [torch.zeros_like(lens) for _ in range(nproc)]
    dist.all_gather(all_buf, buf)
    dist.all_gather(all_len, lens)
    return [all_buf[p][i, :int(all_len[p][i])].numpy().tobytes()
            for p in range(nproc) for i in range(int(all_dims[p][0]))]


def distributed_compress(jpeg_data: bytes, num_segments: int = 8,
                         engine: str = "device", device=None,
                         stats=None) -> bytes:
    """Cooperative encode (multihost.py:95-176): each process codes its
    contiguous share of the segments, S*rank//world .. S*(rank+1)//world,
    the streams are gathered to every process, and every process writes
    the same container.  Byte-identical to one process with the same
    splits (even ones, num_segments of them), either engine.

    Rank and world size come from torch.distributed, or are 0 and 1
    without a group.  engine="device" codes the share with the kernels
    (kernels/batch_encode.encode_images_device(segment_range=), no model
    template, as the JAX function passes none) on `device`; device=None
    means cuda:<rank mod the CUDA devices>, and without CUDA it raises;
    "cpu" runs the kernels' plain versions.  engine="host" codes it with
    the C segment coder (_native), or, where that library cannot be
    built, with the pure-Python segment codec (codec/driver.py, counted
    in host.SEGMENT_CODEC_ROUTES), as the JAX function does (:145-157).
    The device engine and the Python route start every segment from
    the identity model; the C route from the library's template, which
    only host.compress and host.decompress set.  stats: optional dict
    that receives rank, world, lanes (this process's segments), parse_s,
    the encode's stage stats (device engine), encode_s and gather_s."""
    if engine not in ("device", "host"):
        raise ValueError(f"no {engine!r} engine")
    stats = {} if stats is None else stats
    rank, nproc = _rank_world()
    if engine == "device":
        dev = api._device(device)
        if device is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())

    with timing.call(stats, "encode"):
        with timing.span("parse", "parse_s", stage="TS_JPEG_DECODE"):
            parsed = parse_jpeg(jpeg_data)
            info = image_info_from_header(parsed.hdrdata)
            dec = decode_scans(parsed, info)
            splits = select_splits(dec.handoffs, num_segments,
                                   even_split=True)
        S = len(splits)
        bounds = [th.luma_y_start for th in splits] + [info.cmpnfo[0].bcv]
        lo, hi = S * rank // nproc, S * (rank + 1) // nproc
        with timing.span("multihost.encode", "encode_s"):
            if engine == "device":
                # symbolization covers the whole plane; assembly and the
                # coder run only this process's lanes
                with on_device(dev):
                    local = batch_encode.encode_images_device(
                        [api._describe(info, dec, splits)], 1, device=dev,
                        segment_range=[(lo, hi)])[0]
            else:
                mh, cs = host._truncation_geometry(info, dec)
                if host._segment_codec_is_native():
                    enc = host._native_image(info, dec.planes, mh,
                                             cs).encode_segment
                else:
                    enc = partial(encode_segment, host._python_image(
                        info, dec.planes, mh, cs))
                local = [enc(bounds[i], bounds[i + 1], i == S - 1)
                         for i in range(lo, hi)]
        with timing.span("multihost.gather", "gather_s"):
            streams = gather_streams_to_host0(local)
    stats.update(rank=rank, world=nproc, lanes=hi - lo)

    # the header of compress_device's containers: mode Z (the scan decode
    # above takes baseline JPEGs only), version 1 (multihost.py:162)
    return api._container(parsed, dec, splits, S, streams, version=1)
