"""Stored-mode ("level 0") zlib framing for decode output.

Mirror of the reference's Zlib0Writer (io/Zlib0.cc:40-131): a valid zlib
stream built purely from stored deflate blocks, so the wrapping costs 5
bytes per 64K plus the 2-byte header and adler32 trailer.  Used when the
input was a zlib-wrapped lepton file or -zlib0 was given.

Copy of lepton_tpu/container/zlib0.py (33 lines).
"""
from __future__ import annotations

import zlib

_CHUNK = 65535
# header byte pair chosen so the 16-bit value % 31 == desired_checksum-31
_HEADER = bytes([0x78, 0x01])


def zlib0_wrap(data: bytes) -> bytes:
    out = bytearray(_HEADER)
    n = len(data)
    pos = 0
    while True:
        chunk = data[pos:pos + _CHUNK]
        pos += len(chunk)
        last = pos >= n
        ln = len(chunk)
        out.append(0x01 if last else 0x00)
        out += bytes([ln & 0xFF, (ln >> 8) & 0xFF,
                      (~ln) & 0xFF, ((~ln) >> 8) & 0xFF])
        out += chunk
        if last:
            break
    out += (zlib.adler32(data) & 0xFFFFFFFF).to_bytes(4, "big")
    return bytes(out)
