"""JPEG scan decode: Huffman bits -> coefficient planes + handoffs.

Copy of lepton_tpu/jpeg/decoder.py (decode_jpeg, reference
jpgcoder.cc:2799-3300): baseline sequential scans, interleaved or one
component a scan, and progressive scans (jpeg/progressive.py).  A JPEG that
is not a single interleaved baseline scan (mode X) raises UnsupportedJpeg
unless allow_progressive is set.  Coefficients land in raster-order
int16[bcv][bch][64] planes; thread handoffs are crystallized at MCU-row
starts exactly like crystallize_thread_handoff (jpgcoder.cc:2520-2560), in
the DC scans of a progressive file.  Each scan decodes in the native library
when it builds, else in the Python loops below (same output).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..constants import ZIGZAG_TO_RASTER
from ..util import timing
from .bitio import BitReader
from .huffman import devli
from .imageinfo import (ImageInfo, UnsupportedJpeg, scan_header_segments,
                        scan_kind)
from .parser import ParsedJpeg

_ZIG2RAST = [int(v) for v in ZIGZAG_TO_RASTER]


class JpegDecodeError(Exception):
    pass


@dataclass
class ThreadHandoff:
    luma_y_start: int = 0
    luma_y_end: int = 0
    segment_size: int = 0
    overhang_byte: int = 0
    num_overhang_bits: int = 0
    last_dc: List[int] = field(default_factory=lambda: [0, 0, 0, 0])

    LEGACY_OVERHANG_BITS = 0xFF

    def is_legacy_mode(self) -> bool:
        return self.num_overhang_bits == self.LEGACY_OVERHANG_BITS


@dataclass
class DecodedScanData:
    planes: List[np.ndarray] = field(default_factory=list)
    handoffs: List[ThreadHandoff] = field(default_factory=list)
    padbit: int = -1
    early_eof: bool = False
    max_cmp: int = 0
    max_bpos: int = 0
    max_sah: int = 0
    max_dpos: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    is_baseline: bool = True


def _crystallize(reader: BitReader, offsets, mcu_y: int, lastdc,
                 luma_mul: int) -> ThreadHandoff:
    pos = reader.getpos()
    i = bisect.bisect_left(offsets, (pos, pos))
    mapped = 0
    if i > 0:
        i -= 1
    if i < len(offsets):
        mapped = offsets[i][1] + (pos - offsets[i][0])
    th = ThreadHandoff()
    th.segment_size = mapped
    th.last_dc = list(lastdc[:4])
    th.luma_y_start = luma_mul * mcu_y
    th.luma_y_end = luma_mul * (mcu_y + 1)
    th.num_overhang_bits, th.overhang_byte = reader.overhang()
    return th


def _native_available() -> bool:
    try:
        from .. import _native
        return _native.available()
    except Exception:
        return False


def decode_scans(parsed: ParsedJpeg, info: ImageInfo,
                 allow_progressive: bool = False,
                 use_native=None) -> DecodedScanData:
    """Decode all scans from the stored header + huffdata.  Each native
    progressive scan decode is a parse.huffman span labelled with the
    scan's number and kind (imageinfo.scan_kind)."""
    native_finalized = False
    out = DecodedScanData()
    out.planes = [
        np.zeros((info.cmpnfo[c].bcv, info.cmpnfo[c].bch, 64), dtype=np.int16)
        for c in range(info.cmpc)]
    reader = BitReader(parsed.huffdata)
    offsets = parsed.huff_input_offsets

    padbit = -1
    lastdc = [0, 0, 0, 0]
    mcu = 0
    dpos = 0
    cmp = 0
    luma_mul = info.cmpnfo[0].bcv // info.mcuv

    segments = list(scan_header_segments(parsed.hdrdata))
    seg_idx = 0
    scnc = 0
    handoffs = out.handoffs

    while True:
        # seek to next SOS, replaying DHT/DRI/SOS segments
        stype = 0
        while seg_idx < len(segments):
            stype, seg = segments[seg_idx]
            seg_idx += 1
            if stype in (0xC4, 0xDA, 0xDD):
                info.parse_segment(seg)
            if stype == 0xDA:
                break
        if stype != 0xDA:
            break

        sc = info.scan
        if not reader.eof:
            out.max_bpos = max(out.max_bpos, sc.cs_to)
            out.max_sah = max(out.max_sah, max(sc.cs_sal, sc.cs_sah))
            for i in range(sc.cs_cmpc):
                out.max_cmp = max(out.max_cmp, sc.cs_cmp[i])

        if info.jpegtype != 1 or sc.cs_cmpc != info.cmpc:
            if not allow_progressive:
                raise UnsupportedJpeg("progressive JPEG (use allowprogressive)")
            out.is_baseline = False

        if info.jpegtype != 1:
            # progressive scan variants (handoffs crystallize in DC scans)
            if use_native is None:
                use_native = _native_available()
            if use_native:
                from .. import _native
                state = np.asarray([mcu] + list(lastdc[:4]), dtype=np.int32)
                with timing.span("parse.huffman", "huffman_s",
                                 args=f"scan={scnc} kind={scan_kind(info)}"):
                    status, newpos, hrecs, padbit = \
                        _native.native_decode_progressive_scan(
                            info, parsed.huffdata, reader.pos, offsets,
                            out.planes, padbit, state, out.max_dpos)
                if status < 0:
                    raise JpegDecodeError(
                        f"decode error in progressive scan {scnc}")
                reader.pos = newpos
                reader.eof = newpos >= reader.nbits
                for rec in hrecs:
                    handoffs.append(ThreadHandoff(
                        luma_y_start=int(rec[0]),
                        luma_y_end=int(rec[0]) + luma_mul,
                        segment_size=int(rec[1]) & 0xFFFFFFFF,
                        overhang_byte=int(rec[2]),
                        num_overhang_bits=int(rec[3]),
                        last_dc=[int(v) for v in rec[4:8]]))
                mcu = int(state[0])
                lastdc = [int(v) for v in state[1:5]]
                scnc += 1
                continue
            st = dict(mcu=mcu, lastdc=lastdc, padbit=padbit)
            _decode_progressive_scan(reader, info, out, st, offsets,
                                     handoffs, luma_mul, scnc)
            mcu = st["mcu"]
            lastdc = st["lastdc"]
            padbit = st["padbit"]
            scnc += 1
            continue

        # ---- baseline sequential scan (interleaved or one component)

        if use_native is None:
            use_native = _native_available()
        if use_native:
            from .. import _native
            with timing.span("parse.huffman", "huffman_s"):
                status, newpos, hrecs, padbit, maxd = \
                    _native.native_decode_baseline_scan(
                        info, parsed.huffdata, reader.pos, offsets,
                        out.planes, padbit)
            if status < 0:
                raise JpegDecodeError(f"decode error in scan {scnc}")
            reader.pos = newpos
            reader.eof = newpos >= reader.nbits
            for rec in hrecs:
                handoffs.append(ThreadHandoff(
                    luma_y_start=int(rec[0]),
                    luma_y_end=int(rec[0]) + luma_mul,
                    segment_size=int(rec[1]) & 0xFFFFFFFF,
                    overhang_byte=int(rec[2]),
                    num_overhang_bits=int(rec[3]),
                    last_dc=[int(v) for v in rec[4:8]]))
            for c in range(4):
                out.max_dpos[c] = max(out.max_dpos[c], maxd[c])
            scnc += 1
            native_finalized = True
            continue

        cmp = sc.cs_cmp[0]
        csc = 0
        mcu = 0
        sub = 0
        dpos = 0
        do_handoff = True

        while True:  # restart-interval loop
            lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0
            sta = 0
            rstw = info.rsti

            if sc.cs_cmpc > 1:
                # sequential interleaved
                while sta == 0:
                    if do_handoff:
                        handoffs.append(_crystallize(
                            reader, offsets, mcu // info.mcuh,
                            lastdc, luma_mul))
                        do_handoff = False
                    if not reader.eof:
                        out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                    eob = _decode_block_seq(reader, info, cmp, _block)
                    if eob < 0:
                        sta = -1
                    else:
                        _block[0] += lastdc[cmp]
                        lastdc[cmp] = _block[0]
                        _store_block(out.planes[cmp], info, cmp, dpos, eob)
                        old_mcu = mcu
                        sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                            info, sc, mcu, cmp, csc, sub, dpos, rstw)
                        if mcu % info.mcuh == 0 and old_mcu != mcu:
                            do_handoff = True
                    if reader.eof:
                        sta = 2
                        break
            else:
                # sequential non-interleaved: one component in this scan
                # (a grayscale file, or one scan of a multi-scan file)
                hmul = info.cmpnfo[0].bch // info.mcuh
                vmul = info.cmpnfo[0].bcv // info.mcuv
                while sta == 0:
                    if do_handoff:
                        handoffs.append(_crystallize(
                            reader, offsets,
                            (dpos // (hmul * vmul)) // info.mcuh,
                            lastdc, luma_mul))
                        do_handoff = False
                    if not reader.eof:
                        out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                    eob = _decode_block_seq(reader, info, cmp, _block)
                    if eob < 0:
                        sta = -1
                    else:
                        _block[0] += lastdc[cmp]
                        lastdc[cmp] = _block[0]
                        _store_block(out.planes[cmp], info, cmp, dpos, eob)
                        sta, dpos, rstw = _next_mcuposn(info, cmp, dpos, rstw)
                        mcu = dpos // (hmul * vmul)
                        if cmp == 0 and mcu % info.mcuh == 0 and \
                                dpos % (hmul * vmul) == 0:
                            do_handoff = True
                    if reader.eof:
                        sta = 2
                        break

            # unpad / padbit bookkeeping (jpgcoder.cc:3252-3262)
            if padbit != -1:
                if padbit != reader.unpad(padbit):
                    padbit = 1
            else:
                padbit = reader.unpad(padbit)

            if sta == -1:
                raise JpegDecodeError(f"decode error in scan {scnc}")
            if sta == 2:
                scnc += 1
                break
            # sta == 1: restart marker, stay in loop

    out.padbit = padbit
    out.early_eof = parsed.early_eof
    if not native_finalized:
        handoffs.append(_crystallize(
            reader, offsets, mcu // info.mcuh, lastdc, luma_mul))
    for i in range(1, len(handoffs)):
        if handoffs[i].luma_y_start < handoffs[i - 1].luma_y_end:
            handoffs[i].luma_y_start = handoffs[i - 1].luma_y_end
    return out


_block = [0] * 64  # scratch zigzag block


def _store_block(plane: np.ndarray, info: ImageInfo, cmp: int, dpos: int,
                 eob: int) -> None:
    bch = info.cmpnfo[cmp].bch
    y, x = divmod(dpos, bch)
    if y >= plane.shape[0]:
        return
    dst = plane[y, x]
    for bpos in range(eob):
        dst[_ZIG2RAST[bpos]] = _block[bpos]


def _decode_block_seq(reader: BitReader, info: ImageInfo, cmp: int,
                      block) -> int:
    """Port of decode_block_seq (jpgcoder.cc:4893-4960)."""
    ci = info.cmpnfo[cmp]
    dctree = info.hcodes[0][ci.huffdc]
    actree = info.hcodes[1][ci.huffac]
    for i in range(64):
        block[i] = 0
    hc = dctree.decode(reader)
    if hc < 0:
        return -1
    s = hc
    n = reader.read(s)
    block[0] = devli(s, n)
    eob = 64
    bpos = 1
    eof_fixup = False
    while bpos < 64:
        hc = actree.decode(reader)
        if hc > 0:
            z = hc >> 4
            s = hc & 15
            n = reader.read(s)
            if z + bpos >= 64:
                eof_fixup = True
                break
            bpos += z
            block[bpos] = devli(s, n)
            bpos += 1
        elif hc == 0:
            eob = bpos
            break
        else:
            return -1
    if eof_fixup:
        if not reader.eof:
            return -1
        for i in range(bpos, eob):
            block[i] = 0
        if eob:
            block[eob - 1] = 1
    return eob


def _next_mcupos(info: ImageInfo, sc, mcu, cmp, csc, sub, dpos, rstw):
    """Port of next_mcupos (recoder.cc:190-240)."""
    sta = 0
    sub += 1
    if sub >= info.cmpnfo[cmp].mbs:
        sub = 0
        csc += 1
        if csc >= sc.cs_cmpc:
            csc = 0
            cmp = sc.cs_cmp[0]
            mcu += 1
            if mcu >= info.mcuc:
                sta = 2
            elif info.rsti > 0:
                rstw -= 1
                if rstw == 0:
                    sta = 1
        else:
            cmp = sc.cs_cmp[csc]
    ci = info.cmpnfo[cmp]
    if ci.sfh > 1:
        mcu_o_mcuh, mcu_mod_mcuh = divmod(mcu, info.mcuh)
        sub_o_sfv, sub_mod_sfv = divmod(sub, ci.sfv)
        dpos = (mcu_o_mcuh * ci.sfh + sub_o_sfv) * ci.bch \
            + mcu_mod_mcuh * ci.sfv + sub_mod_sfv
    elif ci.sfv > 1:
        dpos = mcu * ci.mbs + sub
    else:
        dpos = mcu
    return sta, mcu, cmp, csc, sub, dpos, rstw


def _next_mcuposn(info: ImageInfo, cmp, dpos, rstw):
    """Port of next_mcuposn (jpgcoder.cc:5432-5455)."""
    ci = info.cmpnfo[cmp]
    dpos += 1
    if ci.bch != ci.nch:
        if dpos % ci.bch == ci.nch:
            dpos += ci.bch - ci.nch
    if ci.bcv != ci.ncv:
        if dpos // ci.bch == ci.ncv:
            dpos = ci.bc
    if dpos >= ci.bc:
        return 2, dpos, rstw
    if info.rsti > 0:
        rstw -= 1
        if rstw == 0:
            return 1, dpos, rstw
    return 0, dpos, rstw


def _i16(v: int) -> int:
    """int16 wraparound of an arbitrary python int."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v

def _decode_progressive_scan(reader: BitReader, info: ImageInfo,
                             out: DecodedScanData, st, offsets, handoffs,
                             luma_mul: int, scnc: int) -> None:
    """One progressive scan: all variants + restart intervals
    (jpgcoder.cc:2990-3260 progressive branches)."""
    from .progressive import (decode_ac_prg_fs, decode_ac_prg_sa,
                              decode_dc_prg_fs, decode_dc_prg_sa,
                              decode_eobrun_sa, skip_eobrun)
    sc = info.scan
    planes = out.planes
    lastdc = st["lastdc"]
    padbit = st["padbit"]
    mcu = st["mcu"]
    cmp = sc.cs_cmp[0]
    csc = 0
    mcu = 0
    sub = 0
    dpos = 0
    do_handoff = True
    block = [0] * 64
    eobrun_box = [0]
    peobrun = 0

    def load_block(c, d, frm, to):
        ci = info.cmpnfo[c]
        y, x = divmod(d, ci.bch)
        pl = planes[c][y, x]
        for b in range(frm, to + 1):
            block[b] = int(pl[_ZIG2RAST[b]])

    def store_block_shifted(c, d, frm, eob, sal):
        ci = info.cmpnfo[c]
        y, x = divmod(d, ci.bch)
        pl = planes[c][y, x]
        for b in range(frm, eob):
            pl[_ZIG2RAST[b]] = _i16(block[b] << sal)

    def add_block_shifted(c, d, frm, to, sal):
        ci = info.cmpnfo[c]
        y, x = divmod(d, ci.bch)
        pl = planes[c][y, x]
        for b in range(frm, to + 1):
            pl[_ZIG2RAST[b]] = _i16(int(pl[_ZIG2RAST[b]])
                                    + (block[b] << sal))

    while True:  # restart-interval loop
        lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0
        sta = 0
        eobrun_box[0] = 0
        peobrun = 0
        rstw = info.rsti

        if sc.cs_cmpc > 1:
            if sc.cs_sah == 0:
                # progressive interleaved DC, first stage
                while sta == 0:
                    if do_handoff:
                        handoffs.append(_crystallize(
                            reader, offsets, mcu // info.mcuh,
                            lastdc, luma_mul))
                        do_handoff = False
                    if not reader.eof:
                        out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                    ci = info.cmpnfo[cmp]
                    sta = decode_dc_prg_fs(
                        reader, info.hcodes[0][ci.huffdc], block)
                    y, x = divmod(dpos, ci.bch)
                    dc = _i16(block[0] + lastdc[cmp])
                    lastdc[cmp] = dc
                    planes[cmp][y, x, 0] = _i16(dc << sc.cs_sal)
                    old_mcu = mcu
                    if sta != -1:
                        sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                            info, sc, mcu, cmp, csc, sub, dpos, rstw)
                    if mcu % info.mcuh == 0 and old_mcu != mcu:
                        do_handoff = True
                    if reader.eof:
                        sta = 2
                        break
            else:
                # progressive interleaved DC, refinement
                while sta == 0:
                    if not reader.eof:
                        out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                    sta = decode_dc_prg_sa(reader, block)
                    ci = info.cmpnfo[cmp]
                    y, x = divmod(dpos, ci.bch)
                    planes[cmp][y, x, 0] = _i16(
                        int(planes[cmp][y, x, 0])
                        + (block[0] << sc.cs_sal))
                    if sta != -1:
                        sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                            info, sc, mcu, cmp, csc, sub, dpos, rstw)
                    if reader.eof:
                        sta = 2
                        break
        else:
            if sc.cs_to == 0:
                if sc.cs_sah == 0:
                    # progressive non-interleaved DC, first stage
                    while sta == 0:
                        if do_handoff:
                            handoffs.append(_crystallize(
                                reader, offsets,
                                dpos // info.cmpnfo[cmp].bch,
                                lastdc, luma_mul))
                            do_handoff = False
                        if not reader.eof:
                            out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                        ci = info.cmpnfo[cmp]
                        sta = decode_dc_prg_fs(
                            reader, info.hcodes[0][ci.huffdc], block)
                        y, x = divmod(dpos, ci.bch)
                        dc = _i16(block[0] + lastdc[cmp])
                        lastdc[cmp] = dc
                        planes[cmp][y, x, 0] = _i16(dc << sc.cs_sal)
                        if sta != -1:
                            sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                            rstw)
                        if cmp == 0 and dpos % info.cmpnfo[cmp].bch == 0:
                            do_handoff = True
                        if reader.eof:
                            sta = 2
                            break
                else:
                    # progressive non-interleaved DC, refinement
                    while sta == 0:
                        if not reader.eof:
                            out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                        sta = decode_dc_prg_sa(reader, block)
                        ci = info.cmpnfo[cmp]
                        y, x = divmod(dpos, ci.bch)
                        planes[cmp][y, x, 0] = _i16(
                            int(planes[cmp][y, x, 0])
                            + (block[0] << sc.cs_sal))
                        if sta != -1:
                            sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                            rstw)
                        if reader.eof:
                            sta = 2
                            break
            else:
                ci = info.cmpnfo[cmp]
                actree = info.hcodes[1][ci.huffac]
                max_eobrun = actree.max_eobrun if actree else 0
                if sc.cs_sah == 0:
                    # progressive non-interleaved AC, first stage
                    while sta == 0:
                        if not reader.eof:
                            out.max_dpos[cmp] = max(dpos, out.max_dpos[cmp])
                        for b in range(sc.cs_from, sc.cs_to + 1):
                            block[b] = 0
                        eob = decode_ac_prg_fs(reader, actree, block,
                                               eobrun_box, sc.cs_from,
                                               sc.cs_to)
                        peobrun = eobrun_box[0]
                        if eob >= 0:
                            store_block_shifted(cmp, dpos, sc.cs_from, eob,
                                                sc.cs_sal)
                        if eob < 0:
                            sta = -1
                        else:
                            sta, dpos, rstw = skip_eobrun(info, cmp, dpos,
                                                          rstw, eobrun_box)
                        if sta == 0:
                            sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                            rstw)
                        if reader.eof:
                            sta = 2
                            break
                else:
                    # progressive non-interleaved AC, refinement
                    while sta == 0:
                        load_block(cmp, dpos, sc.cs_from, sc.cs_to)
                        if eobrun_box[0] == 0:
                            if not reader.eof:
                                out.max_dpos[cmp] = max(dpos,
                                                        out.max_dpos[cmp])
                            eob = decode_ac_prg_sa(reader, actree, block,
                                                   eobrun_box, sc.cs_from,
                                                   sc.cs_to)
                        else:
                            if not reader.eof:
                                out.max_dpos[cmp] = max(dpos,
                                                        out.max_dpos[cmp])
                            eob = decode_eobrun_sa(reader, block, eobrun_box,
                                                   sc.cs_from, sc.cs_to)
                        peobrun = eobrun_box[0]
                        # copy back: add shifted bits
                        ci2 = info.cmpnfo[cmp]
                        y, x = divmod(dpos, ci2.bch)
                        pl = planes[cmp][y, x]
                        for b in range(sc.cs_from, sc.cs_to + 1):
                            pl[_ZIG2RAST[b]] = _i16(
                                int(pl[_ZIG2RAST[b]])
                                + (block[b] << sc.cs_sal))
                        if eob < 0:
                            sta = -1
                        else:
                            sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                            rstw)
                        if reader.eof:
                            sta = 2
                            break

        # unpad / padbit bookkeeping
        if padbit != -1:
            if padbit != reader.unpad(padbit):
                padbit = 1
        else:
            padbit = reader.unpad(padbit)

        if sta == -1:
            raise JpegDecodeError("decode error in progressive scan")
        if sta == 2:
            break

    st["mcu"] = mcu
    st["lastdc"] = lastdc
    st["padbit"] = padbit
