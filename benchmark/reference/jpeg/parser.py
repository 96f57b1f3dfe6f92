"""Raw JPEG stream splitter: header segments vs entropy-coded scan bytes.

Port of read_jpeg (reference jpgcoder.cc:2270-2470): strips 0xFF00 stuffing,
counts restart markers and their errors, records (huffman_pos -> file_pos)
offsets for thread handoffs, and captures garbage after EOI.

Verbatim copy of lepton_tpu/jpeg/parser.py: the port keeps its own host layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


class JpegParseError(Exception):
    pass


@dataclass
class ParsedJpeg:
    hdrdata: bytes = b""          # concatenated marker segments (no SOI/EOI)
    huffdata: bytes = b""         # destuffed entropy-coded bytes, all scans
    rst_cnt: List[int] = field(default_factory=list)   # RST markers per scan
    rst_err: List[int] = field(default_factory=list)   # stray RSTs per scan
    garbage: bytes = b""          # bytes from EOI onward (b"" if exactly EOI)
    scnc: int = 0                 # number of scans
    early_eof: bool = False
    jpgfilesize: int = 0
    # (huffdata_pos, file_pos) pairs for handoff crystallization
    huff_input_offsets: List[Tuple[int, int]] = field(default_factory=list)


def parse_jpeg(data: bytes, embedding: int = 0) -> ParsedJpeg:
    """Split a JPEG stream.  With `embedding=N` the first N bytes are an
    arbitrary prefix and the JPEG starts at offset N (the -embedding= mode,
    reference jpgcoder.cc:2275-2281); recorded file positions stay absolute
    into the full input so thread-handoff segment sizes match the reference's
    stream-position bookkeeping."""
    if embedding:
        out = parse_jpeg(data[embedding:])
        out.jpgfilesize = len(data)
        out.huff_input_offsets = [(h, f + embedding)
                                  for h, f in out.huff_input_offsets]
        return out
    if len(data) < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegParseError("not a JPEG (missing SOI)")
    out = ParsedJpeg()
    out.jpgfilesize = len(data)
    pos = 2  # after SOI
    hdr = bytearray()
    huff = bytearray()
    offsets = out.huff_input_offsets
    rst_cnt = out.rst_cnt
    rst_err = out.rst_err
    scnc = 0
    early_eof = False
    eoi_pos = None
    n = len(data)
    seg_type = 0

    while True:
        if seg_type == 0xDA:
            # entropy-coded data until next marker
            cpos = 0  # restart marker counter
            crst = 0
            while True:
                offsets.append((len(huff), pos))
                if pos >= n:
                    early_eof = True
                    break
                tmp = data[pos]
                pos += 1
                if tmp != 0xFF:
                    crst = 0
                    # fast scan of non-FF run
                    ff = data.find(b"\xff", pos)
                    if ff < 0:
                        huff.append(tmp)
                        huff += data[pos:]
                        pos = n
                        early_eof = True
                        break
                    huff.append(tmp)
                    huff += data[pos:ff]
                    pos = ff
                    tmp = data[pos]
                    pos += 1
                # 0xFF treatment
                if pos > n:
                    early_eof = True
                    break
                if pos == n:
                    early_eof = True
                    break
                nxt = data[pos]
                pos += 1
                if nxt == 0x00:
                    crst = 0
                    huff.append(0xFF)
                elif nxt == 0xD0 + (cpos & 7):
                    cpos += 1
                    crst += 1
                    while len(rst_cnt) <= scnc:
                        rst_cnt.append(0)
                    rst_cnt[scnc] += 1
                else:
                    # end of scan: stray-RST count bookkeeping
                    while len(rst_err) < scnc:
                        rst_err.append(0)
                    rst_err.append(crst)
                    scnc += 1
                    seg_type = nxt
                    break
            else:
                pass
            if early_eof:
                break
            # fall through with marker (0xFF, seg_type) already consumed
            if seg_type == 0xD9:  # EOI
                eoi_pos = pos - 2
                break
        else:
            if pos + 2 > n:
                raise JpegParseError("unexpected end of data in header")
            if data[pos] != 0xFF:
                raise JpegParseError(
                    f"size mismatch in marker segment FF {seg_type:02x}")
            seg_type = data[pos + 1]
            pos += 2
            if seg_type == 0xD9:  # EOI
                eoi_pos = pos - 2
                break
        # common: read segment body for non-EOI markers.  EOF inside a
        # header segment is a hard reject: the reference only crystallizes
        # hdrs/hufs at EOI (standard_eof) or mid-scan EOF (early_eof), so
        # any header-mode EOF leaves hdrs==0 -> "unexpected end of data
        # encountered in header" -> UNSUPPORTED_JPEG (jpgcoder.cc:2398,
        # 2425-2429; found by tools/soak.py: we used to accept truncated
        # inter-scan DHTs and then mis-roundtrip them)
        if seg_type == 0xDA or seg_type != 0xD9:
            if pos + 2 > n:
                raise JpegParseError("unexpected end of data in header")
            length = 2 + (data[pos] << 8) + data[pos + 1]
            if length < 4:
                raise JpegParseError("bad marker segment length")
            if pos - 2 + length > n:
                raise JpegParseError("unexpected end of data in header")
            hdr += data[pos - 2: pos - 2 + length]
            pos += length - 2

    if not hdr:
        raise JpegParseError("unexpected end of data in header")
    if not huff:
        raise JpegParseError("unexpected end of data in huffman")

    out.hdrdata = bytes(hdr)
    out.huffdata = bytes(huff)
    out.scnc = scnc
    out.early_eof = early_eof
    if early_eof or eoi_pos is None:
        # the reference records the last two consumed bytes as garbage
        # (jpgcoder.cc:2434-2454); the recode byte-bound makes this exact
        out.garbage = data[-2:] if len(data) >= 2 else data
        if out.garbage == b"\xff\xd9":
            out.garbage = b""
        out.early_eof = True
    else:
        trailing = data[eoi_pos:]
        out.garbage = b"" if trailing == b"\xff\xd9" else trailing
    return out
