"""JFIF header parsing: image geometry, quantization + Huffman tables.

Port of parse_jfif_jpg / setup_imginfo_jpg (reference jpgcoder.cc:4450-4845).
The header scan is replayed from the stored raw hdrdata exactly as the
reference does, so table/scan state evolves identically across scans.

Verbatim copy of lepton_tpu/jpeg/imageinfo.py: the port keeps its own host layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .huffman import HuffCodes


# runtime equivalent of the reference's ALLOW_3_OR_4_SCALING_FACTOR build
# flag: encode-side opt-in via CLI -allow34sampling; decode of .lep headers
# always passes allow_34 (the container implies a consenting encoder)
ALLOW_3_OR_4_SCALING_FACTOR = False


class UnsupportedJpeg(Exception):
    pass


@dataclass
class ComponentInfo:
    jid: int = 0           # JPEG component id
    sfv: int = 0           # horizontal sampling factor (reference naming)
    sfh: int = 0           # vertical sampling factor
    qtable_index: int = 0
    huffdc: int = 0
    huffac: int = 0
    bcv: int = 0           # block rows (padded to MCU multiple)
    bch: int = 0           # block cols
    bc: int = 0
    ncv: int = 0           # actual (non-padded) block rows
    nch: int = 0
    mbs: int = 0           # blocks per MCU


@dataclass
class ScanInfo:
    cs_cmpc: int = 0
    cs_cmp: List[int] = field(default_factory=list)
    cs_from: int = 0
    cs_to: int = 0
    cs_sah: int = 0
    cs_sal: int = 0


class ImageInfo:
    """Mutable header-replay state (tables get redefined between scans)."""

    def __init__(self):
        self.qtables = [np.zeros(64, dtype=np.uint16) for _ in range(4)]
        self.hcodes: List[List[Optional[HuffCodes]]] = [
            [None] * 4, [None] * 4]
        self.rsti = 0
        self.jpegtype = 0
        self.imgwidth = 0
        self.imgheight = 0
        self.cmpc = 0
        self.cmpnfo = [ComponentInfo() for _ in range(4)]
        self.scan = ScanInfo()
        self.mcuv = 0
        self.mcuh = 0
        self.mcuc = 0
        self.sfhm = 0
        self.sfvm = 0

    # -- segment parsers -------------------------------------------------
    _allow_34 = False

    def parse_segment(self, seg: bytes) -> None:
        stype = seg[1]
        if stype == 0xC4:
            self._parse_dht(seg)
        elif stype == 0xDB:
            self._parse_dqt(seg)
        elif stype == 0xDD:
            self.rsti = (seg[4] << 8) + seg[5]
        elif stype == 0xDA:
            self._parse_sos(seg)
        elif stype in (0xC0, 0xC1, 0xC2):
            self._parse_sof(seg)
        elif stype in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
                       0xCE, 0xCF):
            raise UnsupportedJpeg(f"unsupported SOF marker ff{stype:02x}")
        # APPn / COM ignored

    def _parse_dht(self, seg: bytes) -> None:
        hpos = 4
        length = len(seg)
        while hpos < length:
            lval = seg[hpos] >> 4
            rval = seg[hpos] & 15
            if lval >= 2 or rval >= 4:
                break
            hpos += 1
            counts = seg[hpos: hpos + 16]
            values = seg[hpos + 16: hpos + 16 + sum(counts)]
            self.hcodes[lval][rval] = HuffCodes(counts, values)
            hpos += 16 + sum(counts)

    def _parse_dqt(self, seg: bytes) -> None:
        hpos = 4
        length = len(seg)
        while hpos < length:
            lval = seg[hpos] >> 4
            rval = seg[hpos] & 15
            if lval >= 2 or rval >= 4:
                break
            hpos += 1
            if lval == 0:
                for i in range(64):
                    v = seg[hpos + i] if hpos + i < length else 0
                    self.qtables[rval][i] = v
                    if v == 0:
                        break
                hpos += 64
            else:
                for i in range(64):
                    v = ((seg[hpos + 2 * i] << 8) + seg[hpos + 2 * i + 1]
                         if hpos + 2 * i + 1 < length else 0)
                    self.qtables[rval][i] = v
                    if v == 0:
                        break
                hpos += 128

    def _parse_sof(self, seg: bytes) -> None:
        stype = seg[1]
        self.jpegtype = 2 if stype == 0xC2 else 1
        hpos = 4
        if seg[hpos] != 8:
            raise UnsupportedJpeg("only 8-bit precision supported")
        self.imgheight = (seg[hpos + 1] << 8) + seg[hpos + 2]
        self.imgwidth = (seg[hpos + 3] << 8) + seg[hpos + 4]
        self.cmpc = min(seg[hpos + 5], 4)
        hpos += 6
        for cmp in range(self.cmpc):
            ci = self.cmpnfo[cmp]
            ci.jid = seg[hpos]
            ci.sfv = seg[hpos + 1] >> 4
            ci.sfh = seg[hpos + 1] & 15
            if ci.sfv > 4 or ci.sfh > 4:
                raise UnsupportedJpeg("sampling factor beyond 4 unsupported")
            if not (ALLOW_3_OR_4_SCALING_FACTOR or self._allow_34) and \
                    (ci.sfv > 2 or ci.sfh > 2):
                raise UnsupportedJpeg("sampling factor beyond 2 unsupported")
            ci.qtable_index = seg[hpos + 2]
            hpos += 3

    def _parse_sos(self, seg: bytes) -> None:
        hpos = 4
        sc = ScanInfo()
        sc.cs_cmpc = seg[hpos]
        if sc.cs_cmpc > self.cmpc:
            raise UnsupportedJpeg("too many components in scan")
        hpos += 1
        for _ in range(sc.cs_cmpc):
            jid = seg[hpos]
            cmp = next((i for i in range(self.cmpc)
                        if self.cmpnfo[i].jid == jid), None)
            if cmp is None:
                raise UnsupportedJpeg("component id mismatch in SOS")
            sc.cs_cmp.append(cmp)
            self.cmpnfo[cmp].huffdc = seg[hpos + 1] >> 4
            self.cmpnfo[cmp].huffac = seg[hpos + 1] & 15
            hpos += 2
        sc.cs_from = seg[hpos]
        sc.cs_to = seg[hpos + 1]
        sc.cs_sah = seg[hpos + 2] >> 4
        sc.cs_sal = seg[hpos + 2] & 15
        if sc.cs_from > sc.cs_to or sc.cs_from > 63 or sc.cs_to > 63:
            raise UnsupportedJpeg("spectral selection out of range")
        self.scan = sc

    # -- geometry --------------------------------------------------------
    def finalize_geometry(self) -> None:
        """setup_imginfo_jpg tail (jpgcoder.cc:4487-4530)."""
        if self.cmpc == 0 or self.jpegtype == 0:
            raise UnsupportedJpeg("header contains incomplete information")
        for cmp in range(self.cmpc):
            ci = self.cmpnfo[cmp]
            if ci.sfv == 0 or ci.sfh == 0 or \
                    self.qtables[ci.qtable_index][0] == 0:
                raise UnsupportedJpeg("header information is incomplete")
        self.sfhm = max(ci.sfh for ci in self.cmpnfo[:self.cmpc])
        self.sfvm = max(ci.sfv for ci in self.cmpnfo[:self.cmpc])
        self.mcuv = -(-self.imgheight // (8 * self.sfhm))
        self.mcuh = -(-self.imgwidth // (8 * self.sfvm))
        self.mcuc = self.mcuv * self.mcuh
        for cmp in range(self.cmpc):
            ci = self.cmpnfo[cmp]
            ci.mbs = ci.sfv * ci.sfh
            ci.bcv = self.mcuv * ci.sfh
            ci.bch = self.mcuh * ci.sfv
            ci.bc = ci.bcv * ci.bch
            ci.ncv = -(-self.imgheight * ci.sfh // (8 * self.sfhm))
            ci.nch = -(-self.imgwidth * ci.sfv // (8 * self.sfvm))


def scan_kind(info: ImageInfo) -> str:
    """The kind of info's current scan, as the per-scan spans name it:
    "sequential" in a baseline frame; in a progressive one "dc_first" or
    "dc_refine" (spectral start 0), "ac_first" or "ac_refine", a refine
    scan being one with a successive-approximation high bit."""
    if info.jpegtype == 1:
        return "sequential"
    sc = info.scan
    return (("dc" if sc.cs_from == 0 else "ac")
            + ("_refine" if sc.cs_sah else "_first"))


def scan_header_segments(hdrdata: bytes):
    """Yield (type, segment_bytes) for each segment in stored header data."""
    hpos = 0
    n = len(hdrdata)
    while hpos + 3 < n:
        stype = hdrdata[hpos + 1]
        length = 2 + (hdrdata[hpos + 2] << 8) + hdrdata[hpos + 3]
        yield stype, hdrdata[hpos: hpos + length]
        hpos += length


def image_info_from_header(hdrdata: bytes,
                           allow_34: bool = False) -> ImageInfo:
    """setup_imginfo_jpg: parse everything except DHT/DRI (jpgcoder.cc:4459)."""
    info = ImageInfo()
    info._allow_34 = allow_34
    for stype, seg in scan_header_segments(hdrdata):
        if stype not in (0xDA, 0xC4, 0xDD):
            info.parse_segment(seg)
    info.finalize_geometry()
    return info
