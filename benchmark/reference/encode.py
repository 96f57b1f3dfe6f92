"""The expected .lep of a JPEG, from the plain codec beside it.

What host.compress does on its Python route (the C library absent), with
the identity model as every segment's start (LEPTON_COMPRESSION_MODEL
unset): parse, Huffman-decode the scans in Python, choose the segments as
upstream does (jpgcoder.cc:3898-3960), code each segment with the Python
block coder and the VPX bool writer, and write a version-1 container: mode
Z for a baseline file of one scan, and, with allow_progressive, mode X for
a progressive or multi-scan one (which raises UnsupportedJpeg without it).
The work is split so that a pool can run it: analyse() once an image, then
encode_lane() once a segment, then assemble().

prob_mask: the control.  Each branch probability is ANDed with it before
the bool writer takes it; 0xFF is the format's 8-bit probability, 0xFE the
nearest precision below (7 bits), which writes streams that the format's
decoder does not read back.
"""
from __future__ import annotations

from .codec.blocks import Coder
from .codec.driver import ImageData, _run_segment
from .coder.vpx import BoolWriter
from .container.format import LeptonHeader, write_container
from .container.handoff import choose_num_threads, select_splits
from .container.mux import mux_streams
from .jpeg.decoder import decode_scans
from .jpeg.imageinfo import image_info_from_header
from .jpeg.parser import parse_jpeg
from .model.context import ColorTables

FULL_PRECISION = 0xFF
SEVEN_BITS = 0xFE


class _MaskedCoder(Coder):
    """Coder whose probabilities lose the bits outside `mask`."""

    __slots__ = ("mask",)

    def put(self, bit: int, idx: int) -> None:
        # Coder.put with the probability masked; the counts adapt as ever
        a = self.arena
        lut = self.lut
        o = idx * 3
        self.writer.put_bit(bit, a[o + 2] & self.mask)
        s = (((a[o] << 8) | a[o + 1]) << 1 | bit) * 3
        a[o] = lut[s]
        a[o + 1] = lut[s + 1]
        a[o + 2] = lut[s + 2]


def _geometry(info, dec) -> tuple:
    """trunc_bcv / trunc_bc per component (host._truncation_geometry)."""
    heights, sizes = [], []
    for c in range(info.cmpc):
        ci = info.cmpnfo[c]
        if dec.early_eof:
            trunc_bc = dec.max_dpos[c] + 1
            vertical = min(-(-trunc_bc // ci.bch), ci.bcv)
            ratio = ci.bcv // info.mcuv
            while vertical % ratio != 0 and vertical + 1 <= ci.bcv:
                vertical += 1
            heights.append(vertical)
            sizes.append(trunc_bc)
        else:
            heights.append(ci.bcv)
            sizes.append(ci.bc)
    return heights, sizes


def analyse(jpeg: bytes, num_segments: int,
            allow_progressive: bool = False) -> dict:
    """Parse and Huffman-decode one JPEG and plan its segments: the
    container header without its streams, the coefficient planes, and one
    (first luma row, end row, is last) job a segment."""
    parsed = parse_jpeg(jpeg)
    info = image_info_from_header(parsed.hdrdata)
    dec = decode_scans(parsed, info, allow_progressive=allow_progressive)
    hs = dec.handoffs
    num_threads = choose_num_threads(
        len(hs), hs[-1].segment_size - hs[0].segment_size, num_segments, 1)
    splits = select_splits(hs, num_threads, False)
    bounds = [th.luma_y_start for th in splits] + [info.cmpnfo[0].bcv]
    jobs = [(bounds[k], bounds[k + 1], k == len(splits) - 1)
            for k in range(len(splits))]
    hdr = LeptonHeader()
    hdr.version = 1
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
    heights, sizes = _geometry(info, dec)
    return dict(header=hdr, planes=list(dec.planes),
                qtables=[list(info.qtables[info.cmpnfo[c].qtable_index])
                         for c in range(info.cmpc)],
                mcuv=info.mcuv, heights=heights, sizes=sizes, jobs=jobs)


def encode_lane(analysis: dict, k: int,
                prob_mask: int = FULL_PRECISION) -> bytes:
    """The stream of segment k of an analysed JPEG."""
    image = ImageData(analysis["planes"],
                      [ColorTables(q) for q in analysis["qtables"]],
                      analysis["mcuv"], analysis["heights"],
                      analysis["sizes"])
    writer = BoolWriter()
    if prob_mask == FULL_PRECISION:
        coder = Coder(writer=writer)
    else:
        coder = _MaskedCoder(writer=writer)
        coder.mask = prob_mask
    _run_segment(image, coder, *analysis["jobs"][k], True, None)
    return writer.finish()


def assemble(analysis: dict, streams) -> bytes:
    """The .lep of an analysed JPEG from its segments' streams."""
    return write_container(analysis["header"], mux_streams(list(streams), 1))


def expected_lep(jpeg: bytes, num_segments: int,
                 prob_mask: int = FULL_PRECISION,
                 allow_progressive: bool = False) -> bytes:
    """The whole .lep of one JPEG, in this process."""
    a = analyse(jpeg, num_segments, allow_progressive)
    return assemble(a, [encode_lane(a, k, prob_mask)
                        for k in range(len(a["jobs"]))])


def analyse_job(job) -> dict:
    """analyse(jpeg, num_segments, allow_progressive) for a process
    pool."""
    return analyse(*job)


def lane_job(job) -> bytes:
    """encode_lane(analysis, k, prob_mask) for a process pool."""
    return encode_lane(*job)
