""".lep container writer, format v1.

Copy of the writer half of lepton_tpu/container/format.py (write_ujpg,
reference jpgcoder.cc:3779-4110).  Only version 1 headers (zlib) are
written: v2 and above compress the header with brotli, which this port does
not carry yet, and raise.

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
from typing import List

from .. import constants as C
from ..jpeg.decoder import ThreadHandoff
from .handoff import serialize_handoffs


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
    rst_err: List[int] = field(default_factory=list)
    garbage: bytes = b"\xff\xd9"
    prefix_garbage: "bytes | None" = None
    embedded_jpeg: bool = False
    early_eof: bool = False
    max_cmp: int = 0
    max_bpos: int = 0
    max_sah: int = 0
    max_dpos: List[int] = field(default_factory=lambda: [0, 0, 0, 0])


def _compress_header(payload: bytes, version: int) -> bytes:
    if version == 1:
        return zlib.compress(payload, 9)
    raise ContainerError(f"container v{version} needs brotli headers")


def build_header_block(hdr: LeptonHeader) -> bytes:
    """The marker block that gets zlib compressed."""
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
