"""The host codec: JPEG bytes <-> .lep bytes on the CPU, without torch.

Port of the host half of lepton_tpu/api.py: compress (:224-343, mode Y
start_byte slices, embedding, even_split and allow_34_sampling included),
decompress (:346-424, legacy files without an 'H' record included),
generic_compress (:612-631), compress_any (:634-662), _container_end,
decompress_streaming and decompress_all (:665-808), ujg_compress and
ujg_decompress (:810-858), _apply_model_env (:51-77), and the jailed
parse with its allowlisted unpickler
(:860-1020).

The segment coders are the port's own leptonc.c (_native.NativeImage), the
same C code the JAX package's host codec runs.  Where that library cannot
be built, compress and decompress take the pure-Python segment codec
(codec/driver.py), as lepton_tpu.api does (:277-314, :355-363, :403-407);
the route is counted in SEGMENT_CODEC_ROUTES and named once on stderr, and
unlike the JAX package's it starts each segment from the
LEPTON_COMPRESSION_MODEL template, so both routes write the same bytes.
This module and
everything it imports load no torch: the CLI's host path, the jailed parse
child and the serving layer's host-fallback child run it in processes that
must stay small and, once jailed, cannot open a file.  api.py re-exports
it beside the device entry points.
"""
from __future__ import annotations

import os
import sys
import time
from dataclasses import replace
from typing import Optional

import numpy as np

from . import _native
from .codec.driver import ImageData, decode_segment, encode_segment
from .constants import RASTER_TO_ZIGZAG
from .container.format import LeptonHeader, read_container, write_container
from .container.handoff import choose_num_threads, select_splits
from .container.mux import MuxReader, mux_streams
from .errors import (REQUEST_ERRORS, LeptonError,  # noqa: F401
                     request_error)
from .jpeg.decoder import ThreadHandoff, decode_scans
from .jpeg.imageinfo import ImageInfo, UnsupportedJpeg, image_info_from_header
from .jpeg.parser import parse_jpeg
from .jpeg.recode_progressive import recode_progressive_jpeg
from .jpeg.recoder import recode_baseline_jpeg
from .model.context import ColorTables
from .model.tables import ARENA_SIZE
from .util import pool, timing


_model_env_state = {"cur": None, "template": None, "native": None,
                    "out_f": None}

# segment codec calls (one a compress or decompress) by route: the C
# library, or the pure-Python codec where the library cannot be built
SEGMENT_CODEC_ROUTES = {"native": 0, "python": 0}


def _segment_codec_is_native() -> bool:
    """Whether this compress or decompress codes its segments with the C
    library; counts the route, and names the Python route on stderr the
    first time the process takes it."""
    if _native.available():
        SEGMENT_CODEC_ROUTES["native"] += 1
        return True
    if not SEGMENT_CODEC_ROUTES["python"]:
        sys.stderr.write("lepton_tpu_torch: the C segment codec cannot be "
                         "built; coding segments in Python (slow)\n")
    SEGMENT_CODEC_ROUTES["python"] += 1
    return False


def _model_out_file():
    """Pre-opened LEPTON_COMPRESSION_MODEL_OUT handle (the reference opens
    this fd at startup, before the jail: vp8_encoder.cc:447-458)."""
    path = os.environ.get("LEPTON_COMPRESSION_MODEL_OUT")
    if not path:
        return None
    f = _model_env_state.get("out_f")
    if f is None or f.name != path:
        f = open(path, "wb")
        _model_env_state["out_f"] = f
    return f


def _apply_model_env() -> Optional[bytes]:
    """Honor LEPTON_COMPRESSION_MODEL in the host segment coders: a trained
    model is every segment's start state, each branch count normalized to
    (1+c)>>1 on load (load_probability_tables, model.cc:386-397;
    branch.hh:101-104).  Sets the C codec's template when the library
    builds, and returns the normalized bytes (None without a model) for
    the Python codec, which the JAX package's _apply_model_env (:51-77)
    leaves at the identity.  The device kernels start from the same file
    (_model_template_packed), so the host verification of a device encode
    decodes what the card coded."""
    path = os.environ.get("LEPTON_COMPRESSION_MODEL")
    if path != _model_env_state["cur"]:
        template = None
        if path:
            with open(path, "rb") as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8).copy()
            if raw.size != ARENA_SIZE * 3:
                raise LeptonError("unexpected model file size")
            arr = raw.reshape(-1, 3)
            arr[:, :2] = ((1 + arr[:, :2].astype(np.uint16)) >> 1).astype(
                np.uint8)
            template = raw.tobytes()
        _model_env_state.update(cur=path, template=template)
    if path != _model_env_state["native"] and _native.available():
        _native.set_model_template(_model_env_state["template"])
        _model_env_state["native"] = path
    return _model_env_state["template"]


_template_cache = {}


def _model_template_packed():
    """Packed uint32 [ARENA_SIZE] start arena when LEPTON_COMPRESSION_MODEL
    is set, else None (lepton_tpu.api._model_template_packed, :79-99).
    Counts load-normalize to (1+c)>>1 and the prob byte ships as stored,
    the state the host coders start every segment from
    (load_probability_tables, model.cc:386-421; layout
    c0<<16 | c1<<8 | prob)."""
    path = os.environ.get("LEPTON_COMPRESSION_MODEL")
    if not path:
        return None
    if path not in _template_cache:
        _template_cache[path] = pack_model(
            np.frombuffer(open(path, "rb").read(), dtype=np.uint8))
    return _template_cache[path]


def pack_model(raw: np.ndarray) -> np.ndarray:
    """A raw model file's bytes (ARENA_SIZE x (false count, true count,
    prob)) as the packed uint32 template of _model_template_packed."""
    if raw.size != ARENA_SIZE * 3:
        raise LeptonError("unexpected model file size")
    arr = raw.reshape(-1, 3).astype(np.uint32)
    return ((((1 + arr[:, 0]) >> 1) << 16)
            | (((1 + arr[:, 1]) >> 1) << 8) | arr[:, 2])


def _mark(i, fn, job):
    """Per-thread ARITH stage edges (the reference's stage x thread timing
    matrix records each worker's span, jpgcoder.hh:25-56)."""
    timing.mark("TS_ARITH_STARTED", thread=min(i, 7))
    r = fn(*job)
    timing.mark("TS_ARITH_FINISHED", thread=min(i, 7))
    return r


def _native_image(info: ImageInfo, planes, max_heights, comp_sizes,
                  heights=None):
    """The C segment codec over these planes, with each component's
    quantization table in raster order; heights: the components' heights
    where the planes are ring-sized windows."""
    qtables_raster = [
        np.asarray(info.qtables[info.cmpnfo[c].qtable_index])[
            RASTER_TO_ZIGZAG] for c in range(info.cmpc)]
    return _native.NativeImage(planes, qtables_raster, info.mcuv,
                               max_heights, comp_sizes, heights)


def _python_image(info: ImageInfo, planes, max_heights,
                  comp_sizes) -> ImageData:
    """The pure-Python segment codec over these planes (decode fills them
    in place)."""
    colors = [ColorTables(info.qtables[info.cmpnfo[c].qtable_index])
              for c in range(info.cmpc)]
    return ImageData(planes, colors, info.mcuv, max_heights, comp_sizes)


def _truncation_geometry(info: ImageInfo, hdr_or_dec) -> tuple:
    """trunc_bcv / trunc_bc per component (set_block_count_dpos,
    uncompressed_components.hh:168-179), from a scan decode's result or a
    container header (both carry early_eof and max_dpos)."""
    max_coded_heights = []
    component_sizes = []
    for c in range(info.cmpc):
        ci = info.cmpnfo[c]
        if hdr_or_dec.early_eof:
            trunc_bc = hdr_or_dec.max_dpos[c] + 1
            vertical = min(-(-trunc_bc // ci.bch), ci.bcv)
            ratio = ci.bcv // info.mcuv
            while vertical % ratio != 0 and vertical + 1 <= ci.bcv:
                vertical += 1
            max_coded_heights.append(vertical)
            component_sizes.append(trunc_bc)
        else:
            max_coded_heights.append(ci.bcv)
            component_sizes.append(ci.bc)
    return max_coded_heights, component_sizes


def _handoffs(hdr, mux_region: bytes, info: ImageInfo, what: str = ""):
    """(handoffs, mux streams region) of a container.  A legacy file has no
    'H' record: a mark byte and mark - 1 LE16 luma splits precede the mux
    data (vp8_decoder.cc:337-363), and the overhang state is unknown,
    forcing a continuous re-emit."""
    handoffs = hdr.handoffs
    if not handoffs:
        mark = mux_region[0]
        if mark == 0:
            raise LeptonError(f"{what}legacy file with zero threads")
        splits = [int.from_bytes(mux_region[1 + 2 * k:3 + 2 * k], "little")
                  for k in range(mark - 1)]
        mux_region = mux_region[1 + 2 * (mark - 1):]
        bounds = [0] + splits + [info.cmpnfo[0].bcv]
        handoffs = [
            ThreadHandoff(luma_y_start=bounds[k], luma_y_end=bounds[k + 1],
                          num_overhang_bits=ThreadHandoff.LEGACY_OVERHANG_BITS)
            for k in range(mark)]
    handoffs[-1].luma_y_end = info.cmpnfo[0].bcv
    return handoffs, mux_region


def _reemit_handoffs(hdr, handoffs, info: ImageInfo) -> list:
    """The handoffs the baseline re-emit starts its segments from.  In an
    early-EOF file the scan decode crystallizes its last handoff where the
    data ends, mid-row, and files it under the next MCU row
    (jpeg/decoder.py's final _crystallize and the luma_y_start fix-up
    after it): a segment that starts at or past the rows the cut left
    coded (_truncation_geometry) carries the state of the cut, not that of
    its first row, and checking it raises "handoff mismatch" though every
    byte such a segment re-emits lies past the output bound.  Those
    segments are folded into the last one before them, which re-emits to
    the end of the image from its running state, as a one-segment file
    does.  The .lep bytes are untouched; the JAX package's re-emit, which
    checks every handoff, refuses these files."""
    if not hdr.early_eof or len(handoffs) < 2:
        return handoffs
    coded = _truncation_geometry(info, hdr)[0][0]
    k = next((i for i in range(1, len(handoffs))
              if handoffs[i].luma_y_start >= coded), len(handoffs))
    if k == len(handoffs):
        return handoffs
    last = replace(handoffs[k - 1], luma_y_end=handoffs[-1].luma_y_end)
    return handoffs[:k - 1] + [last]


def _reemit(hdr, handoffs, planes) -> bytes:
    """Huffman re-emit from decoded planes (lepton_tpu.api._tpu_decode_reemit,
    :465-478): mode X regenerates every scan from the whole planes; modes
    Z and Y re-emit the one baseline scan segment by segment
    (_reemit_handoffs)."""
    info = image_info_from_header(hdr.hdrdata, allow_34=True)
    if hdr.mode == ord("X"):
        return recode_progressive_jpeg(
            hdr.hdrdata, planes, info, hdr.padbit, hdr.rst_cnt,
            hdr.rst_cnt_set, hdr.rst_err, hdr.garbage, hdr.original_size,
            hdr.prefix_garbage, hdr.embedded_jpeg,
            truncated=hdr.early_eof)
    return recode_baseline_jpeg(
        hdr.hdrdata, planes, _reemit_handoffs(hdr, handoffs, info),
        info, hdr.padbit,
        hdr.rst_cnt, hdr.rst_cnt_set, hdr.rst_err, hdr.garbage,
        hdr.original_size, hdr.prefix_garbage, hdr.embedded_jpeg)


def _filter_header_second_block(hdrdata: bytes) -> bytes:
    """Keep only the header segments a mid-file slice needs to decode
    (is_needed_for_second_block, jpgcoder.cc:2242-2265): DHT/DQT/DRI/SOS/SOF
    plus anything malformed enough not to be understood."""
    out = bytearray()
    pos = 0
    n = len(hdrdata)
    while pos + 4 <= n:
        length = 2 + (hdrdata[pos + 2] << 8) + hdrdata[pos + 3]
        seg = hdrdata[pos:pos + length]
        if len(seg) <= 2 or seg[0] != 0xFF or \
                seg[1] in (0xC4, 0xDB, 0xDD, 0xDA, 0xC0, 0xC1, 0xC2):
            out += seg
        pos += length
    return bytes(out)


def _parse(jpeg_data: bytes, allow_progressive: bool = False,
           allow_four_colors: bool = False):
    """Host parse + Huffman decode: (parsed, info, dec).  Refuses a
    4-component JPEG unless allow_four_colors, as compress_tpu (:1055-1058)
    and the host compress do (batch_compress_tpu's unjailed parse has no
    such check), and a progressive or multi-scan one unless
    allow_progressive."""
    with timing.span("parse.header"):
        parsed = parse_jpeg(jpeg_data)
        info = image_info_from_header(parsed.hdrdata)
    if info.cmpc > 3 and not allow_four_colors:
        raise UnsupportedJpeg("4 colors unsupported")
    return parsed, info, decode_scans(parsed, info,
                                      allow_progressive=allow_progressive)


def compress(jpeg_data: bytes, max_threads: int = 8,
             min_threads: int = 1, even_split: bool = False,
             allow_progressive: bool = False, version: int = 1,
             start_byte: int = 0, embedding: int = 0,
             allow_four_colors: bool = False,
             allow_34_sampling: bool = False) -> bytes:
    """Encode one JPEG on the host (lepton_tpu.api.compress): up to
    max_threads segments, each coded by the C segment coder on its own
    thread.  version 1 or 2 codes VPX lanes, 3 rANS lanes.  start_byte
    encodes the slice of the file from that byte on (a mode-Y container);
    embedding declares a JPEG at that offset, whose prefix rides along."""
    ans = version == 3
    if start_byte:
        # a mid-file slice is always re-emitted sequentially (jpgcoder.cc:1205)
        allow_progressive = False
    timing.mark("TS_READ_FINISHED")
    parsed = parse_jpeg(jpeg_data, embedding=embedding)
    info = image_info_from_header(parsed.hdrdata,
                                  allow_34=allow_34_sampling)
    if info.cmpc > 3 and not allow_four_colors:
        # default parity with the reference's 3-slot build, which exits
        # UNSUPPORTED_4_COLORS=4
        raise UnsupportedJpeg("4 colors unsupported")
    timing.mark("TS_JPEG_DECODE_STARTED")
    dec = decode_scans(parsed, info, allow_progressive=allow_progressive)
    timing.mark("TS_JPEG_DECODE_FINISHED")

    row_handoffs = dec.handoffs
    prefix_garbage = None
    if embedding:
        prefix_garbage = jpeg_data[:embedding]
    if start_byte:
        # keep rows at/after the slice start; the final row survives
        # unconditionally (jpgcoder.cc:3801-3816)
        row_handoffs = [
            th for i, th in enumerate(dec.handoffs)
            if i == len(dec.handoffs) - 1 or th.segment_size >= start_byte]
        if row_handoffs[0].segment_size < start_byte:
            raise LeptonError("only garbage, no JPEG data after start byte")
        # the straddling row's raw bytes ride as prefix garbage; the final
        # in-progress byte is re-emitted from the overhang seed, hence the
        # -1 (jpgcoder.cc:3820-3845)
        prefix_grbs = row_handoffs[0].segment_size - start_byte
        if len(row_handoffs) > 1 and prefix_grbs:
            prefix_grbs -= 1
        # handoff positions are one-based in-progress-byte counts, so a
        # start byte near EOF can reach past the raw data; the reference
        # copies min(available) (jpgcoder.cc:3834-3838) and the decode size
        # bound trims the padding back off
        prefix_garbage = jpeg_data[start_byte:start_byte + prefix_grbs]
        prefix_garbage += b"\0" * (prefix_grbs - len(prefix_garbage))
    fb_size = row_handoffs[-1].segment_size - row_handoffs[0].segment_size
    num_threads = choose_num_threads(len(row_handoffs), fb_size,
                                     max_threads, min_threads)
    splits = select_splits(row_handoffs, num_threads, even_split)

    max_heights, comp_sizes = _truncation_geometry(info, dec)
    jobs = []
    for i, th in enumerate(splits):
        is_last = i == len(splits) - 1
        end_y = (splits[i + 1].luma_y_start if not is_last
                 else info.cmpnfo[0].bcv)
        jobs.append((th.luma_y_start, end_y, is_last))
    timing.mark("TS_ARITH_STARTED")
    template = _apply_model_env()
    if _segment_codec_is_native():
        native = _native_image(info, dec.planes, max_heights, comp_sizes)
        # segments are independent streams; the C calls drop the GIL
        enc = native.encode_segment_ans if ans else native.encode_segment
        if os.environ.get("LEPTON_COMPRESSION_MODEL_OUT"):
            # dump thread 0's post-encode model (vp8_encoder.cc:616-622):
            # encode segment 0 on this thread and snapshot its arena
            first = enc(*jobs[0])
            f = _model_out_file()
            f.seek(0)
            f.write(_native.thread_arena_snapshot().tobytes())
            f.flush()
            streams = [first] + pool.results(pool.map(
                lambda ij: _mark(ij[0] + 1, enc, ij[1]),
                enumerate(jobs[1:])))
        else:
            streams = pool.results(pool.map(
                lambda ij: _mark(ij[0], enc, ij[1]), enumerate(jobs)))
    else:
        image = _python_image(info, dec.planes, max_heights, comp_sizes)
        streams = [encode_segment(image, *j, ans=ans, template=template)
                   for j in jobs]
    timing.mark("TS_ARITH_FINISHED")

    hdr = LeptonHeader()
    hdr.version = version
    if start_byte:
        hdr.mode = ord("Y")
    else:
        hdr.mode = ord("Z") if dec.is_baseline else ord("X")
    hdr.num_threads = num_threads
    hdr.original_size = parsed.jpgfilesize - start_byte
    hdr.hdrdata = (_filter_header_second_block(parsed.hdrdata)
                   if start_byte else parsed.hdrdata)
    hdr.prefix_garbage = prefix_garbage
    hdr.embedded_jpeg = bool(embedding)
    hdr.padbit = dec.padbit
    hdr.handoffs = splits
    hdr.rst_cnt = parsed.rst_cnt
    hdr.rst_err = parsed.rst_err
    hdr.garbage = parsed.garbage if parsed.garbage else b"\xff\xd9"
    hdr.early_eof = dec.early_eof
    if dec.early_eof:
        hdr.max_cmp = dec.max_cmp
        hdr.max_bpos = dec.max_bpos
        hdr.max_sah = dec.max_sah
        hdr.max_dpos = dec.max_dpos
    timing.mark("TS_STREAM_MULTIPLEX_STARTED")
    out = write_container(hdr, mux_streams(streams, hdr.version))
    timing.mark("TS_STREAM_MULTIPLEX_FINISHED")
    return out


def decompress(lep_data: bytes, _state: Optional[dict] = None) -> bytes:
    """Decode one .lep on the host (lepton_tpu.api.decompress): every mode
    (Z, X and Y), containers v1 to v3, legacy files without an 'H' record.
    _state carries a -lepcat stream's pending header from one container to
    the next (decompress_all)."""
    hdr, mux_region = read_container(
        lep_data, pending_header=(_state or {}).get("pending_header"))
    if _state is not None:
        _state["pending_header"] = hdr.pending_header
    info = image_info_from_header(hdr.hdrdata, allow_34=True)
    max_heights, comp_sizes = _truncation_geometry(info, hdr)
    ans = hdr.version == 3
    # np.zeros is lazy (mmap zero pages), so full-size planes cost only
    # the pages the decode actually touches -- crucial for truncated files
    planes = [np.zeros((info.cmpnfo[c].bcv, info.cmpnfo[c].bch, 64),
                       dtype=np.int16) for c in range(info.cmpc)]
    handoffs, mux_region = _handoffs(hdr, mux_region, info)
    demux = MuxReader(mux_region)
    jobs = []
    for i, th in enumerate(handoffs):
        is_last = i == len(handoffs) - 1
        end_y = handoffs[i + 1].luma_y_start if not is_last else \
            info.cmpnfo[0].bcv
        jobs.append((bytes(demux.buffers[i]), th.luma_y_start, end_y,
                     is_last))
    timing.mark("TS_ARITH_STARTED")
    template = _apply_model_env()
    if _segment_codec_is_native():
        native = _native_image(info, planes, max_heights, comp_sizes)
        planes = native.planes
        # each segment decodes a disjoint row range of the shared planes
        dec_fn = native.decode_segment_ans if ans else native.decode_segment
        pool.results(pool.map(lambda ij: _mark(ij[0], dec_fn, ij[1]),
                              enumerate(jobs)))
    else:
        image = _python_image(info, planes, max_heights, comp_sizes)
        for j in jobs:
            decode_segment(image, *j, ans=ans, template=template)
    timing.mark("TS_ARITH_FINISHED")
    timing.mark("TS_JPEG_RECODE_STARTED")
    out = _reemit(hdr, handoffs, planes)
    timing.mark("TS_JPEG_RECODE_FINISHED")
    return out


# The fake 1x1 grayscale JPEG header used to wrap non-JPEG inputs
# (reference generic_compress.cc:38-53 basic_header)
_BASIC_HEADER = bytes([
    0xff, 0xe0, 0x00, 0x10, 0x4a, 0x46, 0x49, 0x46, 0x00, 0x01,
    0x01, 0x02, 0x00, 0x1c, 0x00, 0x1c, 0x00, 0x00, 0xff, 0xdb, 0x00, 0x43,
    0x00, 0x03, 0x02, 0x02, 0x02, 0x02, 0x02, 0x03, 0x02, 0x02, 0x02, 0x03,
    0x03, 0x03, 0x03, 0x04, 0x06, 0x04, 0x04, 0x04, 0x04, 0x04, 0x08, 0x06,
    0x06, 0x05, 0x06, 0x09, 0x08, 0x0a, 0x0a, 0x09, 0x08, 0x09, 0x09, 0x0a,
    0x0c, 0x0f, 0x0c, 0x0a, 0x0b, 0x0e, 0x0b, 0x09, 0x09, 0x0d, 0x11, 0x0d,
    0x0e, 0x0f, 0x10, 0x10, 0x11, 0x10, 0x0a, 0x0c, 0x12, 0x13, 0x12, 0x10,
    0x13, 0x0f, 0x10, 0x10, 0x10, 0xff, 0xc0, 0x00, 0x0b, 0x08, 0x00, 0x01,
    0x00, 0x01, 0x01, 0x01, 0x11, 0x00, 0xff, 0xc4, 0x00, 0x14, 0x00, 0x01,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x09, 0xff, 0xc4, 0x00, 0x14, 0x10, 0x01, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0xff, 0xda, 0x00, 0x08, 0x01, 0x01, 0x00, 0x00, 0x3f, 0x00,
    0x54, 0xdd,
])


def generic_compress(data: bytes, num_threads: int = 8) -> bytes:
    """Wrap arbitrary bytes as a decodable mode-Y .lep
    (generic_compress.cc:60-223): the payload rides as embedded prefix
    garbage over a fake 1x1 JPEG; the decode byte bound makes the
    reconstruction exact."""
    if len(data) == 0:
        raise LeptonError("empty input unsupported")
    hdr = LeptonHeader()
    hdr.version = 1
    hdr.mode = ord("Y")
    hdr.num_threads = num_threads
    hdr.original_size = len(data)
    hdr.hdrdata = _BASIC_HEADER
    hdr.padbit = 0
    hdr.handoffs = [ThreadHandoff() for _ in range(num_threads)]
    hdr.garbage = b""          # explicit empty GRB
    hdr.prefix_garbage = data
    hdr.embedded_jpeg = True
    return write_container(hdr, b"")


def compress_any(data: bytes, permissive: bool = False, verify: bool = True,
                 engine: str = "host", device=None, **kw) -> bytes:
    """Compress with optional roundtrip validation and permissive fallback
    (the validateAndCompress contract, validation.cc:15-219).

    engine="device" encodes through the card (api.compress_device on
    `device`, max_threads segments, the flags the device path has);
    verification always decodes with the host decoder, independent of the
    card, so the roundtrip gate spans both implementations.  On the device
    only REQUEST_ERRORS take the permissive route, and a verification that
    fails in any way raises LeptonError: any other error is the card's,
    and raises through."""
    try:
        if engine == "device":
            from .api import compress_device
            lep = compress_device(
                data, num_segments=kw.get("max_threads", 16), device=device,
                allow_progressive=kw.get("allow_progressive", False),
                allow_four_colors=kw.get("allow_four_colors", False),
                version=kw.get("version", 1),
                jailed_parse=kw.get("jailed_parse", False))
            if verify and not _roundtrips(lep, data):
                raise LeptonError("roundtrip verification failed")
            return lep
        lep = compress(data, **kw)
        if verify:
            # a -startbyte slice reconstructs only data[start_byte:]
            # (the reference validates the md5 of that range, ioutil.cc:221)
            if decompress(lep) != data[kw.get("start_byte", 0):]:
                raise LeptonError("roundtrip verification failed")
        return lep
    except Exception as e:
        if permissive and (engine == "host" or isinstance(e, REQUEST_ERRORS)):
            return generic_compress(data)
        raise


def _roundtrips(lep: bytes, data: bytes) -> bool:
    """The host decoder gives `data` back from `lep`; a .lep it cannot
    decode does not round-trip."""
    try:
        return decompress(lep) == data
    except Exception:
        return False


def _container_end(data: bytes, pos: int) -> int:
    """The end of the container that starts at `pos`.

    Containers carry their total size in a trailing LE32 (vp8_encoder.cc:
    602-614); for concatenated streams (the -lepcat decode loop,
    jpgcoder.cc:1884-1897) scan for a trailer whose declared size reaches
    either the stream end or the next magic."""
    n = len(data)
    hdr_block_size = int.from_bytes(data[pos + 24:pos + 28], "little")
    start = pos + 28 + hdr_block_size + 3
    # fast path: one container occupying the rest of the stream
    if int.from_bytes(data[n - 4:n], "little") == n - pos:
        return n
    for end in range(start, n - 3):
        declared = int.from_bytes(data[end:end + 4], "little")
        if declared == end + 4 - pos and \
                (end + 4 == n or
                 data[end + 4:end + 6] == bytes([0xCF, 0x84])):
            return end + 4
    raise LeptonError("cannot find container boundary")


def decompress_streaming(lep_data: bytes) -> bytes:
    """O(width)-memory decode: the token decode and the Huffman re-emit
    alternate MCU row by MCU row over ring-indexed planes (the reference's
    2-row memory-optimized decode, uncompressed_components.hh:90-108 +
    block_based_image.hh:52-121; lepton_tpu.api.decompress_streaming,
    :688-793).  Byte-identical to decompress(), which it calls for
    progressive, v3 and truncated containers."""
    hdr, mux_region = read_container(lep_data)
    info = image_info_from_header(hdr.hdrdata, allow_34=True)
    if hdr.version == 3 or hdr.mode != ord("Z") or hdr.early_eof:
        return decompress(lep_data)
    mcuv = info.mcuv
    cm0 = info.cmpnfo[0].bcv // mcuv if mcuv else 1
    if cm0 == 0:
        return decompress(lep_data)
    max_heights, comp_sizes = _truncation_geometry(info, hdr)
    _apply_model_env()
    handoffs, mux_region = _handoffs(hdr, mux_region, info)
    planes = []
    masks = []
    for c in range(info.cmpc):
        ci = info.cmpnfo[c]
        cm = max(1, ci.bcv // mcuv) if mcuv else 1
        rr = 1
        while rr < cm + 1:
            rr <<= 1
        planes.append(np.zeros((rr, ci.bch, 64), dtype=np.int16))
        masks.append(rr - 1)
    native = _native_image(info, planes, max_heights, comp_sizes,
                           [info.cmpnfo[c].bcv for c in range(info.cmpc)])

    demux = MuxReader(mux_region)
    seg_bounds = []
    for i, th in enumerate(handoffs):
        is_last = i == len(handoffs) - 1
        end_y = handoffs[i + 1].luma_y_start if not is_last else \
            info.cmpnfo[0].bcv
        seg_bounds.append((th.luma_y_start, end_y, is_last))

    state = {"seg": -1, "dec": None}

    def ensure_decoded(mcu_row: int) -> None:
        until = (mcu_row + 1) * cm0
        while True:
            if state["dec"] is None:
                state["seg"] += 1
                s_i = state["seg"]
                if s_i >= len(seg_bounds):
                    return
                start_y, end_y, is_last = seg_bounds[s_i]
                seg_data = bytes(demux.buffers[s_i])
                # each stream is consumed exactly once, in order: release
                # the demux copy so the whole mux region is never held
                # twice (keeps the decode inside the -recodememory bound)
                demux.buffers[s_i] = None
                state["dec"] = _native.StreamDecoder(
                    native, masks, start_y, end_y, is_last, seg_data)
            start_y, end_y, is_last = seg_bounds[state["seg"]]
            r = state["dec"].run(until)
            if r == 1 and until > end_y and not is_last:
                state["dec"].close()
                state["dec"] = None
                continue
            return

    from .jpeg.recoder import recode_baseline_jpeg_streaming
    try:
        return recode_baseline_jpeg_streaming(
            hdr.hdrdata, native.planes, masks, ensure_decoded,
            _reemit_handoffs(hdr, handoffs, info), info, hdr.padbit,
            hdr.rst_cnt, hdr.rst_cnt_set, hdr.rst_err, hdr.garbage,
            hdr.original_size, hdr.prefix_garbage, hdr.embedded_jpeg)
    finally:
        if state["dec"] is not None:
            state["dec"].close()


def decompress_all(data: bytes) -> bytes:
    """Decode a (possibly concatenated) stream of .lep containers."""
    out = bytearray()
    pos = 0
    n = len(data)
    state = {}
    while pos + 2 <= n and data[pos:pos + 2] == bytes([0xCF, 0x84]):
        end = _container_end(data, pos)
        out += decompress(data[pos:end], _state=state)
        pos = end
    if not out:
        raise LeptonError("no decodable lepton container found")
    return bytes(out)


def ujg_compress(jpeg_data: bytes, allow_progressive: bool = False) -> bytes:
    """Raw-coefficient UJG output, the -ujg debug baseline
    (lepton_tpu.api.ujg_compress, :810-833)."""
    from .constants import UJG_HEADER
    from .container.ujg import encode_raw
    parsed = parse_jpeg(jpeg_data)
    info = image_info_from_header(parsed.hdrdata)
    dec = decode_scans(parsed, info, allow_progressive=allow_progressive)
    hdr = LeptonHeader()
    hdr.version = 1
    hdr.mode = ord("Z") if dec.is_baseline else ord("X")
    hdr.num_threads = 1
    hdr.original_size = parsed.jpgfilesize
    hdr.hdrdata = parsed.hdrdata
    hdr.padbit = dec.padbit
    hdr.handoffs = dec.handoffs[:1] or [ThreadHandoff()]
    hdr.rst_cnt = parsed.rst_cnt
    hdr.rst_err = parsed.rst_err
    hdr.garbage = parsed.garbage if parsed.garbage else b"\xff\xd9"
    hdr.early_eof = dec.early_eof
    if dec.early_eof:
        hdr.max_cmp, hdr.max_bpos, hdr.max_sah = \
            dec.max_cmp, dec.max_bpos, dec.max_sah
        hdr.max_dpos = dec.max_dpos
    return write_container(hdr, encode_raw(dec.planes), magic=UJG_HEADER)


def ujg_decompress(ujg_data: bytes) -> bytes:
    """The JPEG of a UJG file (lepton_tpu.api.ujg_decompress, :836-857)."""
    from .container.ujg import decode_raw
    hdr, payload = read_container(ujg_data)
    info = image_info_from_header(hdr.hdrdata)
    shapes = [(info.cmpnfo[c].bcv, info.cmpnfo[c].bch)
              for c in range(info.cmpc)]
    planes = decode_raw(payload, shapes)
    handoffs = hdr.handoffs or [ThreadHandoff()]
    handoffs[0].num_overhang_bits = ThreadHandoff.LEGACY_OVERHANG_BITS
    handoffs[-1].luma_y_end = info.cmpnfo[0].bcv
    return _reemit(hdr, handoffs, planes)


def _parse_jpeg_jailed(jpeg_data: bytes, allow_progressive: bool,
                       allow_four_colors: bool = False):
    """Parse + Huffman-decode untrusted JPEG bytes inside a JAILED forked
    child, returning (parsed, info, dec) over a pipe
    (lepton_tpu.api._parse_jpeg_jailed, :860-967).

    A device process cannot jail itself (the CUDA runtime needs its files
    and memory maps), but the JPEG parse is exactly the untrusted-input
    surface the reference never runs outside seccomp (Seccomp.cc:67-138
    installs before read_jpeg, jpgcoder.cc:1766).  Forking confines it:
    the child installs the stage-1 allowlist jail (memory syscalls stay
    allowed -- the planes must grow), parses, and pickles the result back;
    any child death maps to a parse failure, never code execution in the
    device process.  The child runs only this module's torch-free code,
    so it never touches the CUDA state it inherits.

    Callers must have pre-imported the parse modules (cli._prepare_for_jail)
    so the child never opens files.  Parses in-process where fork does not
    exist.

    The return channel is read with a class-allowlisted unpickler: a
    hostile input that fully compromised the jailed child must not be able
    to smuggle an arbitrary-code pickle into the unjailed parent.  A child
    that deadlocks on a lock inherited from a live thread is killed after
    LEPTON_PARSE_TIMEOUT_S (default 300) and maps to a parse failure."""
    import pickle
    import select
    import signal
    import struct

    from .util.sandbox import install_jail

    if not hasattr(os, "fork"):
        return _parse(jpeg_data, allow_progressive, allow_four_colors)
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            os.close(r)
            install_jail()
            try:
                payload = pickle.dumps(
                    (True, _parse(jpeg_data, allow_progressive,
                                  allow_four_colors)),
                    protocol=pickle.HIGHEST_PROTOCOL)
            except BaseException as e:
                # the parent gets one of REQUEST_ERRORS, whatever failed
                if not isinstance(e, REQUEST_ERRORS):
                    e = LeptonError(f"{type(e).__name__}: {e}")
                try:
                    payload = pickle.dumps((False, e),
                                           protocol=pickle.HIGHEST_PROTOCOL)
                except BaseException:
                    payload = pickle.dumps(
                        (False, LeptonError(f"{type(e).__name__}: {e}")),
                        protocol=pickle.HIGHEST_PROTOCOL)
            hdr = struct.pack("<Q", len(payload))
            for buf in (hdr, payload):
                off = 0
                while off < len(buf):
                    off += os.write(w, buf[off:off + (1 << 20)])
            code = 0
        except BaseException:
            pass
        os._exit(code)
    os.close(w)
    deadline = time.monotonic() + float(
        os.environ.get("LEPTON_PARSE_TIMEOUT_S", 300))
    chunks = []
    timed_out = False
    while True:
        wait = deadline - time.monotonic()
        if wait <= 0 or not select.select([r], [], [], wait)[0]:
            timed_out = True
            break
        b = os.read(r, 1 << 20)
        if not b:
            break
        chunks.append(b)
    os.close(r)
    if timed_out:
        os.kill(pid, signal.SIGKILL)
    os.waitpid(pid, 0)
    if timed_out:
        raise LeptonError("jailed parse child timed out")
    blob = b"".join(chunks)
    if len(blob) < 8:
        raise LeptonError("jailed parse child died (hostile input?)")
    n = struct.unpack("<Q", blob[:8])[0]
    try:
        ok, val = _restricted_loads(blob[8:8 + n])
    except (pickle.UnpicklingError, ValueError, TypeError, EOFError) as e:
        raise LeptonError(f"jailed parse child sent no parse ({e})")
    if not ok:
        raise val if isinstance(val, REQUEST_ERRORS) \
            else LeptonError(str(val))
    return val


def _restricted_loads(blob: bytes):
    """Unpickle only the classes the jailed parse child legitimately
    returns: the port's JPEG dataclasses, their exceptions, numpy arrays
    (lepton_tpu.api._restricted_loads, :975-1020, over this package's
    classes)."""
    import io
    import pickle

    from .jpeg import decoder as _d
    from .jpeg import huffman as _h
    from .jpeg import imageinfo as _ii
    from .jpeg import parser as _p

    pkg = "lepton_tpu_torch"
    allowed = {
        (f"{pkg}.jpeg.parser", "ParsedJpeg"): _p.ParsedJpeg,
        (f"{pkg}.jpeg.parser", "JpegParseError"): _p.JpegParseError,
        (f"{pkg}.jpeg.imageinfo", "ComponentInfo"): _ii.ComponentInfo,
        (f"{pkg}.jpeg.imageinfo", "ScanInfo"): _ii.ScanInfo,
        (f"{pkg}.jpeg.imageinfo", "ImageInfo"): _ii.ImageInfo,
        (f"{pkg}.jpeg.imageinfo", "UnsupportedJpeg"): _ii.UnsupportedJpeg,
        (f"{pkg}.jpeg.decoder", "ThreadHandoff"): _d.ThreadHandoff,
        (f"{pkg}.jpeg.huffman", "HuffCodes"): _h.HuffCodes,
        (f"{pkg}.jpeg.decoder", "DecodedScanData"): _d.DecodedScanData,
        (f"{pkg}.jpeg.decoder", "JpegDecodeError"): _d.JpegDecodeError,
        (f"{pkg}.host", "LeptonError"): LeptonError,
        ("numpy._core.multiarray", "_reconstruct"):
            np._core.multiarray._reconstruct,
        ("numpy.core.multiarray", "_reconstruct"):
            np._core.multiarray._reconstruct,
        ("numpy._core.numeric", "_frombuffer"):
            np._core.numeric._frombuffer,
        ("numpy.core.numeric", "_frombuffer"):
            np._core.numeric._frombuffer,
        ("numpy", "ndarray"): np.ndarray,
        ("numpy", "dtype"): np.dtype,
        ("builtins", "ValueError"): ValueError,
        ("builtins", "MemoryError"): MemoryError,
    }

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return allowed[(module, name)]
            except KeyError:
                raise pickle.UnpicklingError(
                    f"jailed-parse channel refused {module}.{name}")

    return _Unpickler(io.BytesIO(blob)).load()
