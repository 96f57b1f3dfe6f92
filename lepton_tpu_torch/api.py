"""Top-level API: JPEG bytes <-> .lep bytes on one CUDA card.

Encode: port of lepton_tpu.api.compress_tpu / batch_compress_tpu
(:1023-1228) for JPEGs of 1 to 4 components (4 with allow_four_colors),
baseline single-scan (mode Z) or, with allow_progressive, progressive and
multi-scan (mode X), into containers v1, v2 (VPX lanes; the header zlib or
brotli) and v3 (rANS lanes, brotli header).  Pipeline: host parse + Huffman
decode of every scan to coefficient planes and handoffs, the images of a
batch at once on the host pool, thread splits, then phase A,
symbolization and the VPX or ANS coder on the device
(kernels/batch_encode.py), then the VPX stop-byte rule or the rANS word
order, the mux and the .lep header on the host.  The output is
byte-identical to the JAX package's.  compress_device(symbolizer="native")
symbolizes on the host with the C library instead, as compress_tpu's
(:1096-1122) does, and codes those symbols with the same kernels.

Decode: port of lepton_tpu.api.decompress_tpu / batch_decompress_tpu
(:427-589) for mode-Z and mode-X containers of versions 1 to 3.  Pipeline:
host container read and demux, then for each coder (VPX lanes for v1 and
v2, rANS lanes for v3) one launch of the token decoder for every segment of
every request of that coder, whatever its mode (kernels/vpx_decoder.py),
and one copy of the planes to the host, then the Huffman re-emit: the
baseline scan by segments (jpeg/recoder.py) for mode Z, every scan
regenerated from the whole planes (jpeg/recode_progressive.py) for mode X,
the mode-X requests of a batch at once on the host pool.
The output is the original JPEG, byte for byte.  A container the device
path does not cover (mode Y) raises LeptonError, or, with per_request,
comes back as its LeptonError in its own slot; there is no hidden host
fallback.

Host: the torch-free host codec (host.py: compress, decompress,
generic_compress, compress_any, decompress_all, decompress_streaming,
ujg_compress, ujg_decompress) is re-exported here; the CLI and the serving
layer verify device encodes with it and route to it what the device path
does not cover.

The entry points run on the card: device=None means "cuda", and without
CUDA they raise.  Pass device="cpu" to run the plain PyTorch versions of
the kernels (the tests do).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _native, host
from . import constants as C
from .container.format import (ContainerError, LeptonHeader, read_container,
                               write_container)
from .container.handoff import choose_num_threads, select_splits
from .container.mux import MuxReader, mux_streams
from .errors import REQUEST_ERRORS, LeptonError, request_error  # noqa: F401
# the host codec, re-exported beside the device entry points; _parse and
# _reemit are looked up here at call time (benchmark/spans.json wraps them)
from .host import (_parse, _reemit, compress, compress_any,  # noqa: F401
                   decompress, decompress_all, decompress_streaming,
                   generic_compress, pack_model, ujg_compress,
                   ujg_decompress)
from .jpeg.imageinfo import UnsupportedJpeg, image_info_from_header  # noqa: F401
from .kernels import batch_encode, vpx_decoder
from .model.context import ColorTables
from .model.tables import arena_from_template
from .util import pool, timing


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lepton_tpu_torch: no CUDA device (pass "
                           "device='cpu' for the plain versions)")
    return dev


def _plan(dec, num_segments: int):
    """(splits, num_threads) as compress_tpu chooses them."""
    num_threads = choose_num_threads(
        len(dec.handoffs),
        dec.handoffs[-1].segment_size - dec.handoffs[0].segment_size,
        num_segments, 1)
    return select_splits(dec.handoffs, num_threads, False), num_threads


def _describe(info, dec, splits) -> dict:
    """The encode_images_device description of one image."""
    mh, cs = host._truncation_geometry(info, dec)
    colors = [ColorTables(info.qtables[info.cmpnfo[c].qtable_index])
              for c in range(info.cmpc)]
    return dict(planes=list(dec.planes), color_tables=colors, mcuv=info.mcuv,
                max_coded_heights=mh, component_sizes=cs,
                splits_y=[th.luma_y_start for th in splits],
                color_index=(lambda c: 0 if c == 0 else 1))


def _container(parsed, dec, splits, num_threads, streams,
               version: int = 1) -> bytes:
    """The .lep bytes, header as in lepton_tpu.api (:1209-1228)."""
    hdr = LeptonHeader()
    hdr.version = version
    hdr.mode = ord("Z") if dec.is_baseline else ord("X")
    hdr.num_threads = num_threads
    hdr.original_size = parsed.jpgfilesize
    hdr.hdrdata = parsed.hdrdata
    hdr.padbit = dec.padbit
    hdr.handoffs = splits
    hdr.rst_cnt = parsed.rst_cnt
    hdr.rst_err = parsed.rst_err
    hdr.garbage = parsed.garbage if parsed.garbage else b"\xff\xd9"
    hdr.early_eof = dec.early_eof
    if dec.early_eof:
        hdr.max_cmp, hdr.max_bpos = dec.max_cmp, dec.max_bpos
        hdr.max_sah, hdr.max_dpos = dec.max_sah, dec.max_dpos
    return write_container(hdr, mux_streams(streams, hdr.version))


def batch_compress_device(jpeg_blobs, num_segments: int = 16,
                          device=None, stats=None, version: int = 1,
                          allow_progressive: bool = False,
                          allow_four_colors: bool = False,
                          jailed_parse: bool = False) -> list:
    """Encode many JPEGs on one card: every image's segments are lanes of
    one coder kernel launch.  Returns the .lep bytes of each, identical to
    compress_device on it alone and to the JAX package's batch_compress_tpu.

    num_segments: the most segments a JPEG is cut into, one number for
    every JPEG or a list of one a JPEG (a wave of uploads that asked for
    different thread counts, as the randomized soak sends them).

    version: the container version, 1 (zlib header) or 2 (brotli header)
    with VPX lanes, or 3 (brotli header) with rANS lanes.
    allow_progressive: take progressive and multi-scan JPEGs too, written as
    mode-X containers (the reference's -allowprogressive); they code the
    same token layer as baseline files.
    allow_four_colors: take 4-component (CMYK) JPEGs, component 3 on the
    chroma tables; without it they raise UnsupportedJpeg.  A JPEG that
    does not parse raises one of host.REQUEST_ERRORS, whatever the parse
    raised (host.request_error).
    jailed_parse: parse each JPEG in a jailed forked child
    (host._parse_jpeg_jailed), as batch_compress_tpu does (:1173-1179);
    the caller must have pre-imported the parse modules
    (cli._prepare_for_jail).
    stats: optional dict that receives the stage times and counts: parse_s
    (host parse + Huffman, the wall on this thread), huffman_s (the native
    scan decodes in it, summed over images; not with jailed_parse),
    parse_image_s and parse_workers (_parse_images), stage_s and
    stage_bytes (coefficients copied into pinned memory), symbolize_s,
    assemble_s, coder_ms or, for version 3, ans_coder_ms (CUDA events on
    the card), finalize_s, mux_s, lanes, symbols, max_lane_symbols.  Each
    time is a timing.span's."""
    if version not in (1, 2, 3):
        raise LeptonError(f"no container version {version}")
    stats = {} if stats is None else stats
    dev = _device(device)
    if isinstance(num_segments, int):
        num_segments = [num_segments] * len(jpeg_blobs)
    if len(num_segments) != len(jpeg_blobs):
        raise ValueError(f"{len(num_segments)} segment counts for "
                         f"{len(jpeg_blobs)} JPEGs")
    with timing.call(stats, "encode"):
        with timing.span("parse", "parse_s", stage="TS_JPEG_DECODE"):
            metas, descs = _parse_images(jpeg_blobs, num_segments,
                                         jailed_parse, allow_progressive,
                                         allow_four_colors)
        all_streams = batch_encode.encode_images_device(
            descs, version, template=host._model_template_packed(),
            device=dev)
        with timing.span("container", "mux_s", stage="TS_STREAM_MULTIPLEX"):
            return [_container(parsed, dec, splits, num_threads, streams,
                               version)
                    for (parsed, dec, splits, num_threads), streams
                    in zip(metas, all_streams)]


def _parse_images(jpeg_blobs, num_segments, jailed_parse,
                  allow_progressive, allow_four_colors):
    """(metas, descs) of a batch: each JPEG parsed (span parse.image) and
    its segments planned (parse.plan).  The images parse at once on the
    host pool (util/pool.py; the native scan decodes drop the GIL), an
    image a job, and come back in their order; the request error of the
    first image that fails is raised.  With jailed_parse the pool has one
    worker: each image forks a child, and a fork while other threads run
    can leave the child a lock that no thread of it will release.  Stats:
    parse_workers, the threads the parse ran on; parse_image_s, the
    parse.image spans' seconds summed over images."""
    parse = host._parse_jpeg_jailed if jailed_parse else _parse

    def one(i):
        # what a request's bytes make fail here raises one of
        # REQUEST_ERRORS; an error of the stages after the parse is the
        # card's
        with timing.span("parse.image", "parse_image_s", image=i):
            try:
                parsed, info, dec = parse(jpeg_blobs[i], allow_progressive,
                                          allow_four_colors)
                with timing.span("parse.plan"):
                    splits, num_threads = _plan(dec, num_segments[i])
                    desc = _describe(info, dec, splits)
            except Exception as e:
                raise request_error(i, e)
        return (parsed, dec, splits, num_threads), desc

    n = len(jpeg_blobs)
    workers = 1 if jailed_parse else pool._workers(n)
    timing.add("parse_workers", workers)
    done = pool.results(pool.map(one, range(n), workers))
    return [m for m, _ in done], [d for _, d in done]


def compress_device(jpeg_data: bytes, num_segments: int = 16,
                    device=None, version: int = 1,
                    allow_progressive: bool = False,
                    allow_four_colors: bool = False,
                    jailed_parse: bool = False, symbolizer: str = "jax",
                    stats=None) -> bytes:
    """Encode one JPEG on the card, as compress_tpu does (:1023-1122).

    symbolizer: "jax" (the default; the name is compress_tpu's) runs the
    batch pipeline with a one-image batch, symbolizing on the card.
    "native" symbolizes the segments on the host with the C library
    (_native.native_symbolize_segment, a thread a segment, as the host
    codec codes them) and codes the symbols on the card
    (batch_encode.symbol_lanes, then code_lanes: one launch of each coder
    kernel); without the library it raises LeptonError, with no Python
    route.  Both write the same bytes.  stats: optional dict that receives
    batch_compress_device's keys; on the "native" route parse_s and
    huffman_s, symbolize_s (the host symbolizer), assemble_s, the coder's
    keys and mux_s."""
    if symbolizer not in ("jax", "native"):
        raise ValueError(f"no symbolizer {symbolizer!r} (jax or native)")
    if symbolizer == "jax":
        return batch_compress_device(
            [jpeg_data], num_segments, device, stats, version=version,
            allow_progressive=allow_progressive,
            allow_four_colors=allow_four_colors,
            jailed_parse=jailed_parse)[0]
    if version not in (1, 2, 3):
        raise LeptonError(f"no container version {version}")
    stats = {} if stats is None else stats
    dev = _device(device)
    with timing.call(stats, "encode"):
        parse = host._parse_jpeg_jailed if jailed_parse else _parse
        with timing.span("parse", "parse_s", stage="TS_JPEG_DECODE"), \
                timing.span("parse.image", image=0):
            try:
                parsed, info, dec = parse(jpeg_data, allow_progressive,
                                          allow_four_colors)
                with timing.span("parse.plan"):
                    splits, num_threads = _plan(dec, num_segments)
            except Exception as e:
                raise request_error(0, e)
        if not _native.available():
            raise LeptonError("native symbolizer unavailable")
        with timing.span("symbolize", "symbolize_s"):
            mh, cs = host._truncation_geometry(info, dec)
            img = host._native_image(info, dec.planes, mh, cs)
            bounds = [th.luma_y_start for th in splits] + [info.cmpnfo[0].bcv]
            # a thread a segment, as the host codec codes them: the C calls
            # drop the GIL
            segs = pool.results(pool.map(
                lambda i: _native.native_symbolize_segment(
                    img, bounds[i], bounds[i + 1], i == len(splits) - 1),
                range(len(splits))))
        idx, bit = batch_encode.symbol_lanes(segs, version != 3, dev)
        streams = batch_encode.code_lanes(idx, bit, version,
                                          host._model_template_packed())
        with timing.span("container", "mux_s", stage="TS_STREAM_MULTIPLEX"):
            return _container(parsed, dec, splits, num_threads, streams,
                              version)


def _decode_request(lep_data: bytes, i: int = 0):
    """Read one container into the decoder's request dict (streams,
    geometry, colour tables) and the re-emit's inputs, as
    lepton_tpu.api._tpu_decode_request (:427-462) does, legacy files
    without an 'H' record included.  Returns (req, hdr, handoffs).  Raises
    LeptonError naming request i for what the device path does not cover:
    mode Y, and version 2 and above when the brotli libraries cannot be
    loaded."""
    if len(lep_data) < 28 or lep_data[:2] not in (C.LEPTON_HEADER,
                                                  C.UJG_HEADER):
        raise LeptonError(f"request {i}: not a .lep container")
    version, mode = lep_data[2], lep_data[3]
    if mode == ord("Y"):
        raise LeptonError(f"request {i}: mode-Y container (host decoder "
                          "only)")
    try:
        hdr, mux_region = read_container(lep_data)
    except ContainerError as e:
        raise LeptonError(f"request {i}: {e}") from e
    if hdr.mode not in (ord("Z"), ord("X")):
        raise LeptonError(f"request {i}: unknown mode {hdr.mode}")
    info = image_info_from_header(hdr.hdrdata, allow_34=True)
    max_heights, comp_sizes = host._truncation_geometry(info, hdr)
    handoffs, mux_region = host._handoffs(hdr, mux_region, info,
                                          f"request {i}: ")
    demux = MuxReader(mux_region)
    req = dict(streams=[bytes(demux.buffers[k]) for k in range(len(handoffs))],
               plane_shapes=[(info.cmpnfo[c].bcv, info.cmpnfo[c].bch)
                             for c in range(info.cmpc)],
               color_tables=[ColorTables(info.qtables[
                   info.cmpnfo[c].qtable_index]) for c in range(info.cmpc)],
               mcuv=info.mcuv, max_coded_heights=max_heights,
               component_sizes=comp_sizes,
               splits_y=[th.luma_y_start for th in handoffs],
               color_index=(lambda c: 0 if c == 0 else 1))
    return req, hdr, handoffs


def _request_error(i: int, e: Exception) -> LeptonError:
    return e if isinstance(e, LeptonError) else LeptonError(
        f"request {i}: {type(e).__name__}: {e}")


def _timed_decode(inputs: dict, template, dev: torch.device):
    """(coef, err, ms) of one decode_lanes launch; ms by CUDA events on the
    card, the host clock on the CPU (timing.timed, in a part of its
    own)."""
    got = {}
    with timing.part(got):
        coef, err = timing.timed(
            lambda: vpx_decoder.decode_lanes(**inputs, template=template),
            dev, "ms", host=True)
    return coef, err, got["ms"]


def batch_decompress_device(leps, device=None, stats=None,
                            per_request: bool = False, mesh=None,
                            even_shares: bool = True) -> list:
    """Decode many .lep containers on one card: the requests are grouped
    by coder (rANS lanes for container v3, VPX lanes for v1 and v2, as
    lepton_tpu.api.batch_decompress_tpu groups them, :496-536), and every
    segment of every request of a group, mode Z or X, is a lane of one
    decoder kernel launch, with each lane's colour tables routed to its
    own request.  Returns the original JPEG bytes of each, identical to
    decompress_device on it alone and to the JAX package's
    batch_decompress_tpu.

    Every request is read before anything is launched; one the device path
    does not cover (mode Y, a container that does not read), or one whose
    decode flags a stream inconsistency or whose re-emit fails, raises
    LeptonError naming it, or another of host.REQUEST_ERRORS.  Any other
    error comes from the decoder's stages on the card.  With per_request, each such request instead
    gets its LeptonError in its own slot of the returned list and the
    others their bytes, as batch_decompress_tpu answers each request on
    its own (:497-535); the caller decides where such a request goes
    (serve.py counts it and routes it to the host codec).

    mesh: a parallel.mesh.Mesh; each coder's lanes are split evenly over
    the devices of its 'seg' axis (one launch a device, each of a
    contiguous share of the lanes), and the shares' planes merged on
    `device` (parallel.mesh.decode_shares).  A lane count that the axis
    does not divide raises ValueError, where decode_segments_tpu fails its
    assert (vpx_decode.py:898).  even_shares=False (the card route of
    parallel.mesh.batch_decompress) takes any lane count: the shares are
    then as near equal as may be, over at most as many devices as there
    are lanes.

    stats: optional dict that receives the stage times and counts: read_s
    (container read and demux), plan_s (lane plans and uploads; with a
    mesh, the plans alone), decoder_ms (CUDA events on the card, both
    coders' launches; with a mesh, each coder's longest share), vpx_decoder_ms
    and ans_decoder_ms (each launch; with a mesh, a list of each share's
    launch), merge_s (with a mesh), d2h_s and d2h_bytes (the planes' and
    flags' copy to the host), recode_s and recode_native_s (the native
    re-emit calls in it; mode X's summed over the pool's threads),
    recode_scan_bytes and reemit_workers (mode X only: the entropy-coded
    bytes of the scans regenerated; the threads _reemit_modex ran the
    requests on), lanes, max_lane_blocks.  Each time in
    seconds is a timing.span's; the ms are CUDA events (timing.timed)."""
    stats = {} if stats is None else stats
    dev = _device(device)
    with timing.call(stats, "decode"):
        out = [None] * len(leps)
        reqs = [None] * len(leps)
        groups = {}
        with timing.span("container.read", "read_s"):
            for i, lep in enumerate(leps):
                try:
                    with timing.span("container.read.request", image=i):
                        reqs[i] = _decode_request(lep, i)
                except Exception as e:
                    if not per_request:
                        raise request_error(i, e)
                    out[i] = _request_error(i, e)
                    continue
                coder = "ans" if reqs[i][1].version == 3 else "vpx"
                groups.setdefault(coder, []).append(i)
        tpl = host._model_template_packed()
        if tpl is not None:
            tpl = arena_from_template(tpl)
        for key in ("plan_s", "decoder_ms", "d2h_s", "d2h_bytes", "lanes",
                    "max_lane_blocks"):
            stats[key] = 0
        if mesh is not None:
            stats["merge_s"] = 0
        planes = [None] * len(reqs)
        for coder, members in groups.items():
            with timing.span("reader.plan", "plan_s"):
                plan = vpx_decoder.plan_decode([reqs[i][0] for i in members],
                                               coder)
                if mesh is None:
                    inputs = plan.to(dev)
                    batch_encode._sync(dev)
            stats["lanes"] += len(plan.lane_request)
            stats["max_lane_blocks"] = max(stats["max_lane_blocks"], int(
                np.bincount(np.repeat(np.arange(len(plan.lanes)),
                                      plan.lanes[:, 1]),
                            weights=plan.rows[:, 2], minlength=1).max()))
            with timing.span("reader", stage="TS_ARITH"):
                if mesh is None:
                    coef, err, ms = _timed_decode(
                        inputs, None if tpl is None else tpl.to(dev), dev)
                    del inputs
                    stats["decoder_ms"] += ms
                else:
                    from .parallel.mesh import decode_shares
                    coef, err, ms = decode_shares(plan, mesh, tpl, dev,
                                                  even_shares)
                    stats["decoder_ms"] += max(ms)
            stats[f"{coder}_decoder_ms"] = ms
            with timing.span("reader.d2h", "d2h_s"):
                coef, err = coef.cpu().numpy(), err.cpu().numpy()
            stats["d2h_bytes"] += coef.nbytes + err.nbytes
            for i, res in zip(members, vpx_decoder.split_planes(plan, coef,
                                                                err != 0)):
                planes[i] = res
        with timing.span("re-emit", "recode_s", stage="TS_JPEG_RECODE"):
            pooled = _reemit_modex(reqs, planes, per_request)
            for i, req in enumerate(reqs):
                if req is None:
                    continue
                out[i], err = pooled[i] if i in pooled else (
                    _reemit_request(i, req, planes[i], per_request), None)
                if err is not None:
                    raise err
        return out


def _reemit_request(i, req, decoded, per_request: bool = False):
    """Request i's JPEG from its decoded planes (span re-emit.request).  A
    failure raises its request error, or with per_request comes back as
    its LeptonError."""
    (p, bad), (_, hdr, handoffs) = decoded, req
    try:
        if bad.any():
            raise LeptonError(f"request {i}: lepton stream inconsistent "
                              "(device decode)")
        with timing.span("re-emit.request", image=i):
            return _reemit(hdr, handoffs, p)
    except Exception as e:
        if not per_request:
            raise request_error(i, e)
        return _request_error(i, e)


def _reemit_modex(reqs, planes, per_request: bool = False) -> dict:
    """{i: (_reemit_request's result or None, the error it raised or None)}
    of the batch's mode-X requests whose planes are not flagged, re-emitted
    at once on the host pool (util/pool.py; the native scan coder drops
    the GIL), a request a job, its scans in order on its job's thread; in
    turn on this thread where the pool has one worker.  Mode-Z requests
    stay with the caller: their segments take the pool themselves.  Stats:
    reemit_workers, where there is such a request; each job's keys
    (recode_native_s, recode_scan_bytes) summed."""
    xs = [i for i, req in enumerate(reqs)
          if req is not None and req[1].mode == ord("X")
          and not planes[i][1].any()]
    if not xs:
        return {}
    workers = pool._workers(len(xs))
    timing.add("reemit_workers", workers)
    return dict(zip(xs, pool.map(
        lambda i: _reemit_request(i, reqs[i], planes[i], per_request), xs,
        workers)))


def decompress_device(lep_data: bytes, device=None, mesh=None,
                      stats=None) -> bytes:
    """Decode one .lep on the card: the batch pipeline with a one-request
    batch.  Bit-exact with the host decompress and decompress_tpu.  mesh:
    the lanes split over the devices of its 'seg' axis, as
    decompress_tpu(mesh=) splits them (lepton_tpu/api.py:539-592); see
    batch_decompress_device, which says what stats receives."""
    return batch_decompress_device([lep_data], device, stats, mesh=mesh)[0]
