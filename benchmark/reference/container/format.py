""".lep container reader and writer, formats v1 to v3.

Frozen copy of lepton_tpu_torch/container/format.py (itself a copy of
lepton_tpu/container/format.py: write_ujpg, reference jpgcoder.cc:3779-4110;
read_container / _parse_header_block, read_ujpg :4117-4360), cut to
version 1, whose header block is compressed with zlib; a v2 or v3 header
raises ContainerError.

  magic(2) version(1) mode(1:'Z'/'X'/'Y') nthreads(1) zero(3) git(12)
  orig_size(LE4) | hdr_size(LE4) compressed_header | 'CMP' mux-streams
  trailing LE4 total file size

The compressed header block carries markers: HDR (raw JPEG header
segments), P0D (pad bits), 'H' (thread handoffs), CRS/FRS (restart
counts/errors), EEE (truncation bounds), PGR/PGE (prefix garbage /
embedded), GRB (trailing garbage).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import List, Optional

from .. import constants as C
from ..jpeg.decoder import ThreadHandoff
from .handoff import deserialize_handoffs, serialize_handoffs


class ContainerError(Exception):
    pass


@dataclass
class LeptonHeader:
    version: int = 1
    mode: int = ord("Z")          # 'Z' baseline, 'X' progressive, 'Y' slice
    num_threads: int = 1
    git_revision: bytes = b"\x00" * 12
    original_size: int = 0
    hdrdata: bytes = b""
    padbit: int = -1
    handoffs: List[ThreadHandoff] = field(default_factory=list)
    rst_cnt: List[int] = field(default_factory=list)
    rst_cnt_set: bool = False
    rst_err: List[int] = field(default_factory=list)
    garbage: bytes = b"\xff\xd9"
    prefix_garbage: "bytes | None" = None
    embedded_jpeg: bool = False
    early_eof: bool = False
    max_cmp: int = 0
    max_bpos: int = 0
    max_sah: int = 0
    max_dpos: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    # unconsumed mega-header bytes after a CNT continuation marker
    # (lepcat streams, concat.cc:86-99 / jpgcoder.cc:4328-4343)
    pending_header: Optional[bytes] = None


def _need_brotli(version: int) -> None:
    raise ContainerError(f"container v{version}: the reference reads and "
                         "writes v1 (zlib) headers only")


def _compress_header(payload: bytes, version: int) -> bytes:
    if version != 1:
        _need_brotli(version)
    return zlib.compress(payload, 9)


def _decompress_header(payload: bytes, version: int) -> bytes:
    if version != 1:
        _need_brotli(version)
    return zlib.decompress(payload)


def build_header_block(hdr: LeptonHeader) -> bytes:
    """The marker block that gets zlib or brotli compressed."""
    out = bytearray()
    out += b"HDR"
    out += len(hdr.hdrdata).to_bytes(4, "little")
    out += hdr.hdrdata
    out += b"P0D"
    out.append(hdr.padbit & 0xFF)
    # luma-splits marker 'H' + serialized handoffs (which embed their own
    # 'H' + count prefix, thread_handoff.cc serialize)
    out += b"H"
    out += serialize_handoffs(hdr.handoffs)
    if hdr.rst_cnt:
        out += b"CRS"
        out += len(hdr.rst_cnt).to_bytes(4, "little")
        for v in hdr.rst_cnt:
            out += v.to_bytes(4, "little")
    if hdr.rst_err:
        out += b"FRS"
        out += len(hdr.rst_err).to_bytes(4, "little")
        out += bytes(hdr.rst_err)
    if hdr.early_eof:
        out += b"EEE"
        out += hdr.max_cmp.to_bytes(4, "little")
        out += hdr.max_bpos.to_bytes(4, "little")
        out += hdr.max_sah.to_bytes(4, "little")
        for i in range(4):
            out += hdr.max_dpos[i].to_bytes(4, "little")
    if hdr.prefix_garbage is not None:
        out += b"PGE" if hdr.embedded_jpeg else b"PGR"
        out += len(hdr.prefix_garbage).to_bytes(4, "little")
        out += hdr.prefix_garbage
    if hdr.garbage != b"\xff\xd9":
        # explicit GRB, including an empty one (generic_compress.cc:141-150)
        out += b"GRB"
        out += len(hdr.garbage).to_bytes(4, "little")
        out += hdr.garbage
    return bytes(out)


def write_container(hdr: LeptonHeader, mux_data: bytes,
                    magic: bytes = C.LEPTON_HEADER) -> bytes:
    out = bytearray()
    out += magic
    out.append(hdr.version)
    out.append(hdr.mode)
    out.append(hdr.num_threads)
    out += b"\x00\x00\x00"
    out += hdr.git_revision[:12].ljust(12, b"\x00")
    out += hdr.original_size.to_bytes(4, "little")
    compressed = _compress_header(build_header_block(hdr), hdr.version)
    out += len(compressed).to_bytes(4, "little")
    out += compressed
    out += b"CMP"
    out += mux_data
    total = len(out) + 4
    out += total.to_bytes(4, "little")
    return bytes(out)


def read_container(data: bytes, pending_header: Optional[bytes] = None):
    """Returns (LeptonHeader, mux_region_bytes).  pending_header: the rest
    of the previous container's header block after its CNT marker, which
    the continuation containers of a -lepcat stream read in place of their
    own (their header-size field is zero; jpgcoder.cc:4138-4142)."""
    if data[:2] not in (C.LEPTON_HEADER, C.UJG_HEADER):
        raise ContainerError("bad magic")
    hdr = LeptonHeader()
    hdr.version = data[2]
    if hdr.version not in (1, 2, 3, 4):
        raise ContainerError(f"unsupported version {hdr.version}")
    hdr.mode = data[3]
    hdr.num_threads = data[4]
    if hdr.num_threads == 0:
        raise ContainerError("zero threads")
    hdr.git_revision = data[8:20]
    hdr.original_size = int.from_bytes(data[20:24], "little")
    ch_size = int.from_bytes(data[24:28], "little")
    if pending_header:
        block = pending_header
    else:
        block = _decompress_header(data[28:28 + ch_size], hdr.version)
    pos = 28 + ch_size
    hdr.pending_header = _parse_header_block(hdr, block)
    if data[pos:pos + 3] != b"CMP":
        raise ContainerError("CMP marker missing")
    pos += 3
    trailing_size = int.from_bytes(data[-4:], "little")
    end = len(data) - 4 if trailing_size == len(data) else len(data)
    return hdr, data[pos:end]


def _parse_header_block(hdr: LeptonHeader, block: bytes) -> Optional[bytes]:
    """Parse one file's markers; returns the remainder after a CNT
    continuation marker (None when the block ends normally)."""
    pos = 0
    n = len(block)
    if block[pos:pos + 3] != b"HDR":
        raise ContainerError("HDR marker not found")
    pos += 3
    hs = int.from_bytes(block[pos:pos + 4], "little")
    pos += 4
    hdr.hdrdata = block[pos:pos + hs]
    pos += hs
    mrk = block[pos:pos + 3]
    if mrk == b"P0D":
        pos += 3
        pb = block[pos]
        pos += 1
        hdr.padbit = pb - 256 if pb >= 128 else pb
    elif mrk == b"PAD":
        pos += 3
        pb = block[pos]
        pos += 1
        pb = pb - 256 if pb >= 128 else pb
        if pb not in (0, 1, -1):
            raise ContainerError("bad legacy padbit")
        hdr.padbit = 0x7F if pb == 1 else pb
    else:
        raise ContainerError("PAD marker not found")
    while pos + 3 <= n:
        mrk = block[pos:pos + 3]
        pos += 3
        if mrk == b"CRS":
            cnt = int.from_bytes(block[pos:pos + 4], "little")
            pos += 4
            hdr.rst_cnt = [int.from_bytes(block[pos + 4 * i:pos + 4 * i + 4],
                                          "little") for i in range(cnt)]
            hdr.rst_cnt_set = True
            pos += 4 * cnt
        elif mrk[:2] == b"HH":
            num = mrk[2]
            rec = block[pos - 2: pos + 16 * num]
            hdr.handoffs = deserialize_handoffs(rec)
            pos += 16 * num
        elif mrk == b"FRS":
            cnt = int.from_bytes(block[pos:pos + 4], "little")
            pos += 4
            hdr.rst_err = list(block[pos:pos + cnt])
            pos += cnt
        elif mrk == b"GRB":
            cnt = int.from_bytes(block[pos:pos + 4], "little")
            pos += 4
            hdr.garbage = block[pos:pos + cnt]
            pos += cnt
        elif mrk in (b"PGR", b"PGE"):
            hdr.embedded_jpeg = mrk == b"PGE"
            cnt = int.from_bytes(block[pos:pos + 4], "little")
            pos += 4
            hdr.prefix_garbage = block[pos:pos + cnt]
            pos += cnt
        elif mrk == b"SIZ":
            hdr.original_size = int.from_bytes(block[pos:pos + 4], "little")
            pos += 4
        elif mrk == b"EEE":
            hdr.early_eof = True
            hdr.max_cmp = int.from_bytes(block[pos:pos + 4], "little")
            hdr.max_bpos = int.from_bytes(block[pos + 4:pos + 8], "little")
            hdr.max_sah = int.from_bytes(block[pos + 8:pos + 12], "little")
            hdr.max_dpos = [
                int.from_bytes(block[pos + 12 + 4 * i:pos + 16 + 4 * i],
                               "little") for i in range(4)]
            pos += 28
        elif mrk == b"CNT":
            return block[pos:]
        elif mrk == b"CMP":
            break
        else:
            raise ContainerError(f"unknown header marker {mrk!r}")
    return None
