"""Huffman re-emit: coefficient planes -> bit-exact original JPEG.

Copy of lepton_tpu/jpeg/recoder.py (:1-373; reference
src/lepton/recoder.cc): per-segment bitstreams are stitched at arbitrary bit
offsets via the handoffs' overhang byte/bits, 0xFF bytes are re-stuffed,
restart markers and stray-RST errors are replayed, and output is
byte-bounded for truncated originals.  The native library's
lepton_recode_rows runs the row loop when it builds (use_native), the Python
loop below otherwise; both give the same bytes.  The streaming variant,
recode_baseline_jpeg_streaming (:376-443), re-emits from ring-sized planes
a row at a time, in the native library only.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..util import pool, timing
from .bitio import BitWriter
from .decoder import ThreadHandoff, _next_mcupos, _next_mcuposn
from .huffman import envli
from .imageinfo import ImageInfo, scan_header_segments

from ..constants import ZIGZAG_TO_RASTER

_ZIG2RAST = [int(v) for v in ZIGZAG_TO_RASTER]


class RecodeError(Exception):
    pass


class BoundedWriter:
    """Byte-bounded output (reference bounded_iostream, bitops.hh:463)."""

    __slots__ = ("buf", "bound")

    def __init__(self, bound: int):
        self.buf = bytearray()
        self.bound = bound

    def write(self, data) -> None:
        space = self.bound - len(self.buf)
        if space <= 0:
            return
        if len(data) <= space:
            self.buf += data
        else:
            self.buf += data[:space]

    def write_byte(self, b: int) -> None:
        if len(self.buf) < self.bound:
            self.buf.append(b)

    def has_exceeded_bound(self) -> bool:
        return len(self.buf) >= self.bound

    def set_bound(self, bound: int) -> None:
        self.bound = bound


def escape_0xff_and_write(out: BoundedWriter, data) -> None:
    """0xFF byte stuffing (recoder.cc:144-185)."""
    if b"\xff" not in data:
        out.write(data)
        return
    out.write(bytes(data).replace(b"\xff", b"\xff\x00"))


def _handle_initial_segments(out: BoundedWriter, hdrdata: bytes,
                             info: ImageInfo,
                             prefix_garbage: Optional[bytes],
                             embedded_jpeg: bool) -> int:
    """Write SOI + header segments up to and including first SOS
    (recoder.cc:414-461); replays DHT/DRI/SOS into `info`."""
    byte_position = 0
    for stype, seg in scan_header_segments(hdrdata):
        if stype in (0xC4, 0xDD, 0xDA):
            info.parse_segment(seg)
        byte_position += len(seg)
        if stype == 0xDA:
            if prefix_garbage:
                out.write(prefix_garbage)
            if embedded_jpeg or prefix_garbage is None:
                out.write(b"\xff\xd8")
                out.write(hdrdata[:byte_position])
            return byte_position
    raise RecodeError("no SOS found in header")


def _encode_block_seq(huffw: BitWriter, dctbl, actbl, block) -> int:
    """Port of encode_block_seq (recoder.cc:245-313).  block: zigzag ints."""
    tmp = block[0]
    s = (tmp if tmp > 0 else -tmp).bit_length()
    huffw.write(dctbl.cval[s], dctbl.clen[s])
    huffw.write(envli(s, tmp), s)
    end = 63
    while end and not block[end]:
        end -= 1
    z = 0
    for bpos in range(1, end + 1):
        tmp = block[bpos]
        if tmp == 0:
            z += 1
            continue
        while z & 0xF0:
            huffw.write(actbl.cval[0xF0], actbl.clen[0xF0])
            z -= 16
        s = (tmp if tmp > 0 else -tmp).bit_length()
        hc = (z << 4) + s
        huffw.write(actbl.cval[hc], actbl.clen[hc])
        huffw.write(envli(s, tmp), s)
        z = 0
    if end != 63:
        huffw.write(actbl.cval[0x00], actbl.clen[0x00])
    return end + 1


def _recode_one_mcu_row(huffw: BitWriter, mcu: int, out: BoundedWriter,
                        lastdc: List[int], planes, info: ImageInfo,
                        padbit: int, rst_cnt, rst_cnt_set: bool) -> bool:
    """Port of recode_one_mcu_row (recoder.cc:316-412)."""
    sc = info.scan
    cmp = sc.cs_cmp[0]
    csc = 0
    sub = 0
    mcumul = info.cmpnfo[cmp].sfv * info.cmpnfo[cmp].sfh
    dpos = mcu * mcumul
    rstw = (info.rsti - mcu % info.rsti) if info.rsti else 0
    cumulative_reset_markers = mcu // info.rsti if rstw else 0
    ncomp = len(planes)
    zig_block = [0] * 64
    end_of_row = False
    while not end_of_row:
        sta = 0
        while sta == 0:
            ci = info.cmpnfo[cmp]
            y, x = divmod(dpos, ci.bch)
            raster = planes[cmp][y, x]
            for zpos in range(64):
                zig_block[zpos] = int(raster[_ZIG2RAST[zpos]])
            dc = zig_block[0]
            zig_block[0] -= lastdc[cmp]
            lastdc[cmp] = dc
            _encode_block_seq(huffw,
                              info.hcodes[0][ci.huffdc],
                              info.hcodes[1][ci.huffac],
                              zig_block)
            old_mcu = mcu
            if ncomp == 1:
                sta, dpos, rstw = _next_mcuposn(info, cmp, dpos, rstw)
                mcu = dpos // mcumul
            else:
                sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                    info, sc, mcu, cmp, csc, sub, dpos, rstw)
            if sta == 0 and huffw.no_remainder():
                escape_0xff_and_write(out, huffw.take_bytes())
            if out.has_exceeded_bound():
                sta = 2
            if old_mcu != mcu and mcu % info.mcuh == 0:
                end_of_row = True
                if sta == 0:
                    return True
        huffw.pad(padbit)
        if huffw.no_remainder():
            escape_0xff_and_write(out, huffw.take_bytes())
        if sta == -1:
            return False
        if sta == 2:
            break
        if sta == 1 and info.rsti > 0:
            if not rst_cnt or not rst_cnt_set or \
                    cumulative_reset_markers < rst_cnt[0]:
                out.write_byte(0xFF)
                out.write_byte(0xD0 + (cumulative_reset_markers & 7))
                cumulative_reset_markers += 1
            rstw = info.rsti
            for i in range(len(lastdc)):
                lastdc[i] = 0
    return True


def _native_available() -> bool:
    try:
        from .. import _native
        return _native.available()
    except Exception:
        return False


def recode_baseline_jpeg(hdrdata: bytes, planes, handoffs: List[ThreadHandoff],
                         info: ImageInfo, padbit: int,
                         rst_cnt, rst_cnt_set: bool, rst_err,
                         garbage: bytes, max_file_size: int,
                         prefix_garbage: Optional[bytes] = None,
                         embedded_jpeg: bool = False,
                         use_native=None) -> bytes:
    """Port of recode_baseline_jpeg (recoder.cc:694-890), sequential."""
    grbs = len(garbage)
    out = BoundedWriter(max(0, max_file_size - grbs))
    byte_position = _handle_initial_segments(
        out, hdrdata, info, prefix_garbage, embedded_jpeg)

    if padbit == -1:
        padbit = 0  # no padding was observed; value irrelevant

    if use_native is None:
        use_native = _native_available()
    if use_native:
        return _recode_native(out, byte_position, hdrdata, planes, handoffs,
                              info, padbit, rst_cnt, rst_cnt_set, rst_err,
                              garbage, max_file_size)

    huffw = BitWriter(size_bound=max_file_size)
    mcuv = info.mcuv
    luma_mul = info.cmpnfo[0].bcv // mcuv

    # run through logical segments in order; handoff agreement is asserted
    # at each boundary (recoder.cc:633-645)
    running = ThreadHandoff(
        overhang_byte=handoffs[0].overhang_byte,
        num_overhang_bits=(0 if handoffs[0].is_legacy_mode()
                           else handoffs[0].num_overhang_bits),
        last_dc=list(handoffs[0].last_dc))
    for seg_i, th in enumerate(handoffs):
        if not th.is_legacy_mode():
            if seg_i > 0:
                if th.num_overhang_bits != running.num_overhang_bits or \
                        th.overhang_byte != running.overhang_byte or \
                        list(th.last_dc[:3]) != list(running.last_dc[:3]):
                    raise RecodeError(
                        f"handoff mismatch at segment {seg_i}")
            running = ThreadHandoff(
                luma_y_start=th.luma_y_start, luma_y_end=th.luma_y_end,
                overhang_byte=th.overhang_byte,
                num_overhang_bits=th.num_overhang_bits,
                last_dc=list(th.last_dc))
        else:
            running.luma_y_start = th.luma_y_start
            running.luma_y_end = th.luma_y_end
        huffw.fillbit = padbit
        huffw.reset_from_overhang(running.overhang_byte,
                                  running.num_overhang_bits)
        lastdc = running.last_dc
        start_mcu_row = running.luma_y_start // luma_mul
        end_mcu_row = running.luma_y_end // luma_mul
        for mcu_row in range(start_mcu_row, end_mcu_row):
            ok = _recode_one_mcu_row(
                huffw, mcu_row * info.mcuh, out, lastdc, planes, info,
                padbit, rst_cnt, rst_cnt_set)
            if not ok:
                raise RecodeError("coding error")
            escape_0xff_and_write(out, huffw.take_bytes())
        running.num_overhang_bits = huffw.get_num_overhang_bits()
        running.overhang_byte = huffw.get_overhang_byte()

    # stray RST markers recorded for scan 0 (recoder.cc:838-847)
    if rst_err:
        cumulative = ((info.mcuh * info.mcuv - 1) // info.rsti
                      if info.rsti else 0)
        for i in range(rst_err[0]):
            out.write_byte(0xFF)
            out.write_byte(0xD0 + ((cumulative + i) & 7))

    # trailing header data (multi-scan files)
    if not out.has_exceeded_bound():
        out.write(hdrdata[byte_position:])
    # `garbage` always includes the EOI marker (the container substitutes
    # b"\xff\xd9" when no GRB record is present, matching jpgcoder.cc:4190)
    out.set_bound(max_file_size)
    out.write(garbage)
    return bytes(out.buf)


def _recode_native(out: BoundedWriter, byte_position: int, hdrdata: bytes,
                   planes, handoffs, info: ImageInfo, padbit: int,
                   rst_cnt, rst_cnt_set: bool, rst_err,
                   garbage: bytes, max_file_size: int) -> bytes:
    """Native segment re-emit (lepton_recode_rows), same semantics as the
    Python loop in recode_baseline_jpeg."""
    from .. import _native
    grbs = len(garbage)
    bound = max(0, max_file_size - grbs)
    buf = np.zeros(max_file_size + 65536, dtype=np.uint8)
    pos = len(out.buf)
    buf[:pos] = np.frombuffer(bytes(out.buf), dtype=np.uint8)

    planes_c = [np.ascontiguousarray(p.reshape(p.shape[0], -1), dtype=np.int16)
                for p in planes]
    sc = _native.build_hscan(info)
    tables = _native.build_huff_tables(info)
    luma_mul = info.cmpnfo[0].bcv // info.mcuv

    any_legacy = any(th.is_legacy_mode() for th in handoffs)
    if not any_legacy and len(handoffs) > 1:
        # non-legacy handoffs carry each segment's full stitching state, so
        # segments re-emit independently (the reference's parallel recode,
        # recoder.cc:756-825) and concatenate in order
        def run_seg(th):
            # tables/sc are read-only in the C recode: share one copy
            seg_buf = np.zeros(bound + 65536, dtype=np.uint8)
            p2, ob, nb, dc = _native.native_recode_rows(
                info, planes_c, th.luma_y_start // luma_mul,
                th.luma_y_end // luma_mul, th.overhang_byte,
                th.num_overhang_bits, list(th.last_dc), padbit,
                rst_cnt, rst_cnt_set, seg_buf, bound, 0,
                tables=tables, sc=_native.build_hscan(info))
            return seg_buf[:p2], (ob, nb, dc)

        # the host's pool: its threads exist before a jail, which bans the
        # stack mmap of a new one (pool._warm_pool)
        with timing.span("re-emit.native", "recode_native_s"):
            outs = pool.results(pool.map(run_seg, handoffs))
        for i in range(len(handoffs) - 1):
            ob, nb, dc = outs[i][1]
            nxt = handoffs[i + 1]
            if nb != nxt.num_overhang_bits or ob != nxt.overhang_byte or \
                    dc[:3] != list(nxt.last_dc[:3]):
                raise RecodeError(f"handoff mismatch at segment {i + 1}")
        for seg_bytes, _ in outs:
            n = min(len(seg_bytes), bound + 65536 - pos)
            buf[pos:pos + n] = seg_bytes[:n]
            pos += n
    else:
        running_ob = handoffs[0].overhang_byte
        running_nb = (0 if handoffs[0].is_legacy_mode()
                      else handoffs[0].num_overhang_bits)
        running_dc = list(handoffs[0].last_dc)
        running_start = handoffs[0].luma_y_start
        running_end = handoffs[0].luma_y_end
        for seg_i, th in enumerate(handoffs):
            if not th.is_legacy_mode():
                if seg_i > 0 and (th.num_overhang_bits != running_nb
                                  or th.overhang_byte != running_ob
                                  or list(th.last_dc[:3]) != running_dc[:3]):
                    raise RecodeError(f"handoff mismatch at segment {seg_i}")
                running_ob = th.overhang_byte
                running_nb = th.num_overhang_bits
                running_dc = list(th.last_dc)
            running_start = th.luma_y_start
            running_end = th.luma_y_end
            start_row = running_start // luma_mul
            end_row = running_end // luma_mul
            with timing.span("re-emit.native", "recode_native_s"):
                pos, running_ob, running_nb, running_dc = \
                    _native.native_recode_rows(
                        info, planes_c, start_row, end_row, running_ob,
                        running_nb, running_dc, padbit, rst_cnt, rst_cnt_set,
                        buf, bound, pos, tables=tables, sc=sc)

    result = bytearray(buf[:min(pos, bound)].tobytes())
    if rst_err:
        cumulative = ((info.mcuh * info.mcuv - 1) // info.rsti
                      if info.rsti else 0)
        for i in range(rst_err[0]):
            if len(result) < bound:
                result.append(0xFF)
            if len(result) < bound:
                result.append(0xD0 + ((cumulative + i) & 7))
    if len(result) < bound:
        result += hdrdata[byte_position:
                          byte_position + (bound - len(result))]
    result += garbage[:max(0, max_file_size - len(result))]
    return bytes(result)


def recode_baseline_jpeg_streaming(hdrdata: bytes, planes_ring, row_masks,
                                   ensure_decoded, handoffs,
                                   info: ImageInfo, padbit: int,
                                   rst_cnt, rst_cnt_set: bool, rst_err,
                                   garbage: bytes, max_file_size: int,
                                   prefix_garbage=None,
                                   embedded_jpeg: bool = False) -> bytes:
    """Streaming re-emit over ring-indexed planes: `ensure_decoded(mcu_row)`
    is called before each MCU row is re-encoded, so decode memory stays
    O(width) (the reference's 2-row memory-optimized single-thread decode,
    uncompressed_components.hh:90-108).  Byte-identical to
    recode_baseline_jpeg."""
    from .. import _native
    grbs = len(garbage)
    out = BoundedWriter(max(0, max_file_size - grbs))
    byte_position = _handle_initial_segments(
        out, hdrdata, info, prefix_garbage, embedded_jpeg)
    if padbit == -1:
        padbit = 0
    bound = max(0, max_file_size - grbs)
    buf = np.zeros(max_file_size + 65536, dtype=np.uint8)
    pos = len(out.buf)
    buf[:pos] = np.frombuffer(bytes(out.buf), dtype=np.uint8)

    planes_c = [np.ascontiguousarray(p.reshape(p.shape[0], -1),
                                     dtype=np.int16) for p in planes_ring]
    sc = _native.build_hscan(info, row_masks=row_masks)
    tables = _native.build_huff_tables(info)
    luma_mul = info.cmpnfo[0].bcv // info.mcuv

    running_ob = handoffs[0].overhang_byte
    running_nb = (0 if handoffs[0].is_legacy_mode()
                  else handoffs[0].num_overhang_bits)
    running_dc = list(handoffs[0].last_dc)
    for seg_i, th in enumerate(handoffs):
        if not th.is_legacy_mode():
            if seg_i > 0:
                if th.num_overhang_bits != running_nb or \
                        th.overhang_byte != running_ob or \
                        list(th.last_dc[:3]) != running_dc[:3]:
                    raise RecodeError(f"handoff mismatch at segment {seg_i}")
            running_ob = th.overhang_byte
            running_nb = th.num_overhang_bits
            running_dc = list(th.last_dc)
        start_row = th.luma_y_start // luma_mul
        end_row = th.luma_y_end // luma_mul
        for mcu_row in range(start_row, end_row):
            ensure_decoded(mcu_row)
            pos, running_ob, running_nb, running_dc = \
                _native.native_recode_rows(
                    info, planes_c, mcu_row, mcu_row + 1, running_ob,
                    running_nb, running_dc, padbit, rst_cnt, rst_cnt_set,
                    buf, bound, pos, tables=tables, sc=sc)

    result = bytearray(buf[:min(pos, bound)].tobytes())
    if rst_err:
        cumulative = ((info.mcuh * info.mcuv - 1) // info.rsti
                      if info.rsti else 0)
        for i in range(rst_err[0]):
            if len(result) < bound:
                result.append(0xFF)
            if len(result) < bound:
                result.append(0xD0 + ((cumulative + i) & 7))
    if len(result) < bound:
        result += hdrdata[byte_position:
                          byte_position + (bound - len(result))]
    result += garbage[:max(0, max_file_size - len(result))]
    return bytes(result)
