"""JPEG Huffman code tables: build, decode (LUT), encode.

Reference: build_huffcodes (jpgcoder.cc:5507-5600), next_huffcode
(jpgcoder.cc:5407-5425).  Decoding uses a 16-bit peek LUT instead of the
reference's bit-by-bit tree walk; both consume identical bits for valid
codes, and invalid codes map to an error symbol just like a dead tree node.

Verbatim copy of lepton_tpu/jpeg/huffman.py: the port keeps its own host layers.
"""
from __future__ import annotations

import numpy as np


class HuffCodes:
    __slots__ = ("clen", "cval", "max_eobrun", "lut", "valid")

    def __init__(self, counts: bytes, values: bytes):
        """counts: 16 bytes (codes per length); values: symbol list."""
        clen = [0] * 256
        cval = [0] * 256
        k = 0
        code = 0
        for i in range(16):
            cnt = counts[i] if i < len(counts) else 0
            for _ in range(cnt):
                v = values[k] if k < len(values) else 0
                clen[v] = 1 + i
                cval[v] = code
                k += 1
                code += 1
            code <<= 1
        self.clen = clen
        self.cval = cval
        self.max_eobrun = 0
        for i in range(14, -1, -1):
            if clen[(i << 4) & 255] > 0:
                self.max_eobrun = (2 << i) - 1
                break
        # 16-bit peek decode LUT: lut[peek] = (symbol << 5) | length,
        # length 0 marks an invalid/dead path
        lut = np.zeros(1 << 16, dtype=np.uint32)
        for sym in range(256):
            ln = clen[sym]
            if ln == 0:
                continue
            if cval[sym] >= (1 << ln):
                # oversubscribed (corrupt) DHT: the reference truncates
                # its decode tree and leaves these as dead nodes
                # (jpgcoder.cc:5575-5597); skip = same dead-path decode
                continue
            prefix = cval[sym] << (16 - ln)
            span = 1 << (16 - ln)
            lut[prefix: prefix + span] = (sym << 5) | ln
        self.lut = lut
        self.valid = any(clen)

    def decode(self, reader) -> int:
        """Returns the symbol, or -1 on an invalid code (dead tree node)."""
        pos = reader.pos
        navail = reader.nbits - pos
        if navail >= 16:
            peek = reader._extract(pos, 16)
        else:
            peek = reader._extract(pos, navail) << (16 - navail) if navail else 0
        entry = int(self.lut[peek])
        ln = entry & 31
        if ln == 0:
            # walk off the end like the reference tree (consumes up to 16)
            reader.read(16 if navail >= 16 else navail)
            return -1
        reader.read(ln)
        return entry >> 5


def envli(s: int, v: int) -> int:
    """JPEG variable-length-integer encoding (jpgcoder.cc:116)."""
    return v if v > 0 else v - 1 + (1 << s)


def devli(s: int, n: int) -> int:
    """Inverse of envli (jpgcoder.cc:117 DEVLI)."""
    if s == 0:
        return n
    if n >= (1 << (s - 1)):
        return n
    return n + 1 - (1 << s)
