"""Progressive JPEG re-emit: full multi-scan Huffman regeneration + merge.

Port of recode_jpeg (reference jpgcoder.cc:3309-3720) and the flush pass of
merge_jpeg_streaming (jpgcoder.cc:2560-2745): phase 1 regenerates the
entropy-coded data of every scan (sequential or progressive, first-stage or
refinement) recording scan/restart positions, phase 2 interleaves header
segments with escaped scan bytes, restart markers and stray-RST replay.

Copy of lepton_tpu/jpeg/recode_progressive.py: the port keeps its own host
layers.  Each scan is regenerated in the native library when it builds
(native_recode_any_scan), in the Python loop below otherwise; both give the
same bytes.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..constants import ZIGZAG_TO_RASTER
from ..util import timing
from .bitio import BitWriter
from .huffman import envli
from .imageinfo import ImageInfo, scan_header_segments, scan_kind
from .recoder import BoundedWriter, RecodeError
from .decoder import _next_mcupos, _next_mcuposn

_ZIG2RAST = [int(v) for v in ZIGZAG_TO_RASTER]


def _fdiv2(v: int, p: int) -> int:
    return -((-v) >> p) if v < 0 else v >> p


def _encode_eobrun(huffw: BitWriter, actbl, eobrun: int) -> int:
    """jpgcoder.cc:5349-5374; returns the new (zero) eobrun."""
    if eobrun > 0:
        if actbl.max_eobrun == 0:
            # only reachable with corrupt coefficients: a valid stream's
            # optimized table always covers the runs its scan produced
            raise RecodeError("AC table cannot encode an EOB run")
        while eobrun > actbl.max_eobrun:
            huffw.write(actbl.cval[0xE0], actbl.clen[0xE0])
            huffw.write(32767 - (1 << 14), 14)  # E_ENVLI(14, 32767)
            eobrun -= actbl.max_eobrun
        s = eobrun.bit_length()
        if s:
            s -= 1
        huffw.write(actbl.cval[s << 4], actbl.clen[s << 4])
        huffw.write(eobrun - (1 << s), s)
    return 0


def _encode_crbits(huffw: BitWriter, storw: List[int]) -> None:
    for b in storw:
        huffw.write(b, 1)
    storw.clear()


def _encode_block_seq(huffw, dctbl, actbl, block) -> int:
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


def _encode_ac_prg_fs(huffw, actbl, block, eobrun: int, cs_from, cs_to):
    """jpgcoder.cc:5077-5131; returns (eob, eobrun)."""
    z = 0
    for bpos in range(cs_from, cs_to + 1):
        tmp = block[bpos]
        if tmp != 0:
            eobrun = _encode_eobrun(huffw, actbl, eobrun)
            while z >= 16:
                huffw.write(actbl.cval[0xF0], actbl.clen[0xF0])
                z -= 16
            s = (tmp if tmp > 0 else -tmp).bit_length()
            hc = (z << 4) + s
            huffw.write(actbl.cval[hc], actbl.clen[hc])
            huffw.write(envli(s, tmp), s)
            z = 0
        else:
            z += 1
    if z > 0:
        eobrun += 1
        if eobrun == actbl.max_eobrun:
            eobrun = _encode_eobrun(huffw, actbl, eobrun)
        return 1 + cs_to - z, eobrun
    return 1 + cs_to, eobrun


def _encode_ac_prg_sa(huffw, storw, actbl, block, eobrun: int,
                      cs_from, cs_to):
    """jpgcoder.cc:5237-5330; returns (eob, eobrun)."""
    eob = cs_from
    for bpos in range(cs_to, cs_from - 1, -1):
        if block[bpos] in (1, -1):
            eob = bpos + 1
            break
    if eob > cs_from and eobrun > 0:
        eobrun = _encode_eobrun(huffw, actbl, eobrun)
        _encode_crbits(huffw, storw)
    z = 0
    bpos = cs_from
    while bpos < eob:
        tmp = block[bpos]
        if tmp == 0:
            z += 1
            if z == 16:
                huffw.write(actbl.cval[0xF0], actbl.clen[0xF0])
                _encode_crbits(huffw, storw)
                z = 0
        elif tmp in (1, -1):
            s = 1
            n = envli(s, tmp)
            hc = (z << 4) + s
            huffw.write(actbl.cval[hc], actbl.clen[hc])
            huffw.write(n, s)
            _encode_crbits(huffw, storw)
            z = 0
        else:
            storw.append(block[bpos] & 0x1)
        bpos += 1
    while bpos <= cs_to:
        if block[bpos] != 0:
            storw.append(block[bpos] & 0x1)
        bpos += 1
    if eob <= cs_to:
        eobrun += 1
        if eobrun == actbl.max_eobrun:
            eobrun = _encode_eobrun(huffw, actbl, eobrun)
            _encode_crbits(huffw, storw)
    return eob, eobrun


def _native_available() -> bool:
    try:
        from .. import _native
        return _native.available()
    except Exception:
        return False


def regenerate_scans(hdrdata: bytes, planes, info: ImageInfo, padbit: int,
                     use_native=None, truncated: bool = False):
    """Phase 1 of recode_jpeg: rebuild all scans' entropy data.

    truncated: the container is early-EOF (EEE).  The final scan's
    coefficient store is zero-filled past the truncation point, and the
    zero tail can merge into an EOB run the scan's optimized Huffman
    table has no code for (the original encoder never emitted one) --
    every byte at or beyond that flush lies past the original_size cut
    merge_jpeg applies, so generation stops cleanly there instead of
    failing the whole decode.  The reference emits the same container
    for such inputs and then its own decoder loops forever recoding it
    (observed: /tmp/refbuild/lepton spins on a 639-byte truncated
    progressive+RST file); a clean exact-prefix decode is the only
    useful behavior.

    Each scan is a span labelled with its number and kind
    (imageinfo.scan_kind): re-emit.native (adding to recode_native_s) or,
    in the Python loop, re-emit.python.  The open call's stats count the
    scans' entropy-coded bytes, before the merge stuffs them, in
    recode_scan_bytes.

    Returns (huffdata bytes, scnp list, rstp list, scnc).
    """
    huffw = BitWriter()
    huffw.fillbit = padbit if padbit != -1 else 0
    storw: List[int] = []
    scnp: List[int] = []
    rstp: List[int] = []
    scnc = 0
    lastdc = [0, 0, 0, 0]
    block = [0] * 64
    segments = list(scan_header_segments(hdrdata))
    seg_idx = 0
    # the native scans read the planes through raw pointers: one contiguous
    # copy (a no-op for contiguous planes) serves every scan
    planes_c = [np.ascontiguousarray(p, dtype=np.int16) for p in planes]

    def pos():
        return huffw.nbytes

    def load_block(c, d, frm, to, sal=0):
        ci = info.cmpnfo[c]
        y, x = divmod(d, ci.bch)
        pl = planes[c][y, x]
        if sal:
            for b in range(frm, to + 1):
                block[b] = _fdiv2(int(pl[_ZIG2RAST[b]]), sal)
        else:
            for b in range(frm, to + 1):
                block[b] = int(pl[_ZIG2RAST[b]])

    while True:
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
        args = f"scan={scnc} kind={scan_kind(info)}"
        while len(scnp) < scnc + 2:
            scnp.append(0)
        scnp[scnc] = pos()
        scnp[scnc + 1] = 0

        if use_native is None:
            use_native = _native_available()
        if use_native:
            from .. import _native
            try:
                with timing.span("re-emit.native", "recode_native_s",
                                 args=args):
                    scan_bytes, rstp_new = _native.native_recode_any_scan(
                        info, planes_c, info.jpegtype, padbit, pos())
            except RuntimeError:
                if not truncated:
                    raise
                # redo this one scan in Python below: its graceful-stop
                # path byte-aligns and ends generation at the
                # unencodable EOB run (past the original_size cut)
                scan_bytes = None
            if scan_bytes is not None:
                assert huffw.bits == 0
                huffw.chunks += scan_bytes
                huffw.nbytes += len(scan_bytes)
                rstp.extend(rstp_new)
                scnc += 1
                timing.add("recode_scan_bytes", len(scan_bytes))
                continue

        # the Python loop's time for this scan, and its bytes
        start = pos()
        python_span = timing.span("re-emit.python", args=args).__enter__()
        try:
            cmp = sc.cs_cmp[0]
            csc = 0
            mcu = 0
            sub = 0
            dpos = 0
            while True:
                lastdc[0] = lastdc[1] = lastdc[2] = lastdc[3] = 0
                sta = 0
                eobrun = 0
                rstw = info.rsti

                if sc.cs_cmpc > 1:
                    if info.jpegtype == 1:
                        while sta == 0:
                            load_block(cmp, dpos, 0, 63)
                            dc = block[0]
                            block[0] -= lastdc[cmp]
                            lastdc[cmp] = dc
                            ci = info.cmpnfo[cmp]
                            _encode_block_seq(huffw, info.hcodes[0][ci.huffdc],
                                              info.hcodes[1][ci.huffac], block)
                            sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                                info, sc, mcu, cmp, csc, sub, dpos, rstw)
                    elif sc.cs_sah == 0:
                        while sta == 0:
                            ci = info.cmpnfo[cmp]
                            y, x = divmod(dpos, ci.bch)
                            tmp = int(planes[cmp][y, x, 0]) >> sc.cs_sal
                            diff = tmp - lastdc[cmp]
                            lastdc[cmp] = tmp
                            s = (diff if diff > 0 else -diff).bit_length()
                            dctbl = info.hcodes[0][ci.huffdc]
                            huffw.write(dctbl.cval[s], dctbl.clen[s])
                            huffw.write(envli(s, diff), s)
                            sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                                info, sc, mcu, cmp, csc, sub, dpos, rstw)
                    else:
                        while sta == 0:
                            ci = info.cmpnfo[cmp]
                            y, x = divmod(dpos, ci.bch)
                            bit = (int(planes[cmp][y, x, 0]) >> sc.cs_sal) & 1
                            huffw.write(bit, 1)
                            sta, mcu, cmp, csc, sub, dpos, rstw = _next_mcupos(
                                info, sc, mcu, cmp, csc, sub, dpos, rstw)
                else:
                    if info.jpegtype == 1:
                        while sta == 0:
                            load_block(cmp, dpos, 0, 63)
                            dc = block[0]
                            block[0] -= lastdc[cmp]
                            lastdc[cmp] = dc
                            ci = info.cmpnfo[cmp]
                            _encode_block_seq(huffw, info.hcodes[0][ci.huffdc],
                                              info.hcodes[1][ci.huffac], block)
                            sta, dpos, rstw = _next_mcuposn(info, cmp, dpos, rstw)
                    elif sc.cs_to == 0:
                        if sc.cs_sah == 0:
                            while sta == 0:
                                ci = info.cmpnfo[cmp]
                                y, x = divmod(dpos, ci.bch)
                                tmp = int(planes[cmp][y, x, 0]) >> sc.cs_sal
                                diff = tmp - lastdc[cmp]
                                lastdc[cmp] = tmp
                                s = (diff if diff > 0 else -diff).bit_length()
                                dctbl = info.hcodes[0][ci.huffdc]
                                huffw.write(dctbl.cval[s], dctbl.clen[s])
                                huffw.write(envli(s, diff), s)
                                sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                                rstw)
                        else:
                            while sta == 0:
                                ci = info.cmpnfo[cmp]
                                y, x = divmod(dpos, ci.bch)
                                bit = (int(planes[cmp][y, x, 0])
                                       >> sc.cs_sal) & 1
                                huffw.write(bit, 1)
                                sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                                rstw)
                    else:
                        ci = info.cmpnfo[cmp]
                        actbl = info.hcodes[1][ci.huffac]
                        if sc.cs_sah == 0:
                            while sta == 0:
                                load_block(cmp, dpos, sc.cs_from, sc.cs_to,
                                           sc.cs_sal)
                                eob, eobrun = _encode_ac_prg_fs(
                                    huffw, actbl, block, eobrun,
                                    sc.cs_from, sc.cs_to)
                                sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                                rstw)
                            eobrun = _encode_eobrun(huffw, actbl, eobrun)
                        else:
                            while sta == 0:
                                load_block(cmp, dpos, sc.cs_from, sc.cs_to,
                                           sc.cs_sal)
                                eob, eobrun = _encode_ac_prg_sa(
                                    huffw, storw, actbl, block, eobrun,
                                    sc.cs_from, sc.cs_to)
                                sta, dpos, rstw = _next_mcuposn(info, cmp, dpos,
                                                                rstw)
                            eobrun = _encode_eobrun(huffw, actbl, eobrun)
                            _encode_crbits(huffw, storw)

                huffw.pad(huffw.fillbit)
                if sta == -1:
                    raise RecodeError("encode error in progressive recode")
                if sta == 2:
                    scnc += 1
                    break
                if sta == 1 and info.rsti > 0:
                    rstp.append(pos() - 1)
        except RecodeError:
            if not truncated:
                raise
            # unencodable EOB run while regenerating a truncated
            # container: everything from this flush on lies past the
            # original_size cut merge_jpeg applies.  Byte-align what
            # was emitted and stop generating scans -- the cut then
            # reproduces the original truncated bytes exactly.
            huffw.pad(huffw.fillbit)
            scnc += 1
            break
        finally:
            python_span.__exit__(None, None, None)
            timing.add("recode_scan_bytes", pos() - start)

    huffdata = bytes(huffw.chunks)
    if scnc >= len(scnp):
        scnp.append(0)
    scnp[scnc] = len(huffdata)
    if rstp:
        rstp.append(len(huffdata))
    return huffdata, scnp, rstp, scnc


def merge_jpeg(hdrdata: bytes, huffdata: bytes, scnp, rstp, scnc,
               rst_cnt, rst_cnt_set: bool, rst_err, garbage: bytes,
               max_file_size: int, prefix_garbage: Optional[bytes],
               embedded_jpeg: bool) -> bytes:
    """Phase 2: merge_jpeg_streaming flush pass (jpgcoder.cc:2560-2745)."""
    grbs = len(garbage)
    out = BoundedWriter(max_file_size - grbs)
    if prefix_garbage:
        out.write(prefix_garbage)
    if embedded_jpeg or prefix_garbage is None:
        out.write(b"\xff\xd8")
    hdrs = len(hdrdata)
    hpos = 0
    scan = 1
    rpos = 0
    rst_err = list(rst_err)

    def rst_cnt_ok(scan_no: int, num_this_scan: int) -> bool:
        if not rstp:
            return False
        if not rst_cnt_set:
            return True
        return len(rst_cnt) > scan_no - 1 and \
            num_this_scan < rst_cnt[scan_no - 1]

    while True:
        # write header up to & including next SOS
        tmp = hpos
        stype = 0
        while stype != 0xDA:
            if 3 + hpos >= hdrs:
                break
            stype = hdrdata[hpos + 1]
            length = 2 + (hdrdata[hpos + 2] << 8) + hdrdata[hpos + 3]
            hpos += length
        actual = min(hpos, hdrs)
        out.write(hdrdata[tmp:actual])
        for _ in range(actual, hpos):
            out.write_byte(0)
        if stype != 0xDA:
            break
        if scan > scnc + 1:
            break
        cpos = 0
        num_rst_this_scan = 0
        ipos = scnp[scan - 1]
        end = scnp[scan] if scan < len(scnp) and scnp[scan] else len(huffdata)
        # bulk 0xFF stuffing between restart positions; when the rst gate
        # fails once, rpos freezes and no further markers are emitted
        # (matching the byte loop in jpgcoder.cc:2560-2745)
        while ipos < end and rpos < len(rstp) and ipos <= rstp[rpos] < end:
            p = rstp[rpos]
            out.write(huffdata[ipos:p + 1].replace(b"\xff", b"\xff\x00"))
            ipos = p + 1
            if rst_cnt_ok(scan, num_rst_this_scan):
                out.write_byte(0xFF)
                out.write_byte(0xD0 + (cpos & 7))
                rpos += 1
                cpos += 1
                num_rst_this_scan += 1
            else:
                break
        if ipos < end:
            out.write(huffdata[ipos:end].replace(b"\xff", b"\xff\x00"))
            ipos = end
        # stray RST markers at scan end
        if scan - 1 < len(rst_err):
            while rst_err[scan - 1] > 0:
                out.write_byte(0xFF)
                out.write_byte(0xD0 + (cpos & 7))
                cpos += 1
                rst_err[scan - 1] -= 1
        scan += 1
        if out.has_exceeded_bound():
            break
    out.set_bound(max_file_size)
    out.write(garbage)
    return bytes(out.buf)


def recode_progressive_jpeg(hdrdata: bytes, planes, info: ImageInfo,
                            padbit: int, rst_cnt, rst_cnt_set: bool, rst_err,
                            garbage: bytes, max_file_size: int,
                            prefix_garbage: Optional[bytes] = None,
                            embedded_jpeg: bool = False,
                            truncated: bool = False) -> bytes:
    huffdata, scnp, rstp, scnc = regenerate_scans(
        hdrdata, planes, info, padbit, truncated=truncated)
    return merge_jpeg(hdrdata, huffdata, scnp, rstp, scnc, rst_cnt,
                      rst_cnt_set, rst_err, garbage, max_file_size,
                      prefix_garbage, embedded_jpeg)
