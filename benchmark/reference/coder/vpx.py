"""Scalar-exact VP8/VPX boolean arithmetic coder.

Bit-exact with the reference implementation:
  - writer: src/vp8/encoder/boolwriter.{hh,cc} (vpx_write / vpx_start_encode /
    vpx_stop_encode)
  - reader: src/vp8/decoder/boolreader.{hh,cc} (vpx_read / vpx_reader_fill /
    vpx_reader_init)

Copy of lepton_tpu/coder/vpx.py (:1-135), the correctness nucleus of the
scalar segment codec (codec/blocks.py); the card's VPX coder
(kernels/vpx_coder.py) is held against it in the tests.
"""
from __future__ import annotations

from ..constants import VPX_NORM as _VPX_NORM_NP

VPX_NORM = bytes(int(v) for v in _VPX_NORM_NP)  # plain ints for bit math

LOTS_OF_BITS = 0x40000000
_MASK64 = (1 << 64) - 1


class BoolWriter:
    """VPX boolean writer over a growable byte buffer."""

    __slots__ = ("lowvalue", "range", "count", "buf")

    def __init__(self):
        self.lowvalue = 0
        self.range = 255
        self.count = -24
        self.buf = bytearray()
        self.put_bit(0, 128)  # marker bit (vpx_start_encode)

    def put_bit(self, bit: int, probability: int) -> None:
        """Exact port of vpx_write (boolwriter.hh:48-118)."""
        lowvalue = self.lowvalue
        rng = self.range
        count = self.count
        split = 1 + (((rng - 1) * probability) >> 8)
        if bit:
            lowvalue = (lowvalue + split) & 0xFFFFFFFF
            rng -= split
        else:
            rng = split
        shift = VPX_NORM[rng]
        rng <<= shift
        count += shift
        if count >= 0:
            offset = shift - count
            if (lowvalue << (offset - 1)) & 0x80000000:
                # carry propagation into already-emitted bytes
                buf = self.buf
                x = len(buf) - 1
                while x >= 0 and buf[x] == 0xFF:
                    buf[x] = 0
                    x -= 1
                assert x >= 0, "carry out of buffer start"
                buf[x] += 1
            self.buf.append((lowvalue >> (24 - offset)) & 0xFF)
            lowvalue = (lowvalue << offset) & 0xFFFFFF
            shift = count
            count -= 8
        lowvalue = (lowvalue << shift) & 0xFFFFFFFF
        self.lowvalue = lowvalue
        self.range = rng
        self.count = count

    def finish(self) -> bytes:
        """vpx_stop_encode: flush 32 zero bits and avoid mux-marker clash."""
        for _ in range(32):
            self.put_bit(0, 128)
        if len(self.buf) and (self.buf[-1] & 0xE0) == 0xC0:
            self.buf.append(0)
        return bytes(self.buf)


class BoolReader:
    """VPX boolean reader over a fully-buffered stream.

    The reference pulls from a PacketReader abstraction; the bit semantics
    are independent of packetization, so a flat buffer is equivalent.
    """

    __slots__ = ("data", "pos", "value", "count", "range")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.value = 0
        self.count = -8
        self.range = 255
        self._fill()
        self.get_bit(128)  # marker bit (vpx_reader_init)

    def _fill(self) -> None:
        """Equivalent of vpx_reader_fill for a flat buffer."""
        shift = 48 - self.count
        data = self.data
        pos = self.pos
        value = self.value
        count = self.count
        n = len(data)
        while shift >= 0:
            if pos < n:
                value |= data[pos] << shift
                pos += 1
                count += 8
                shift -= 8
            else:
                count += LOTS_OF_BITS
                break
        self.pos = pos
        self.value = value
        self.count = count

    def get_bit(self, prob: int) -> int:
        """Exact port of vpx_read (boolreader.hh:376-416)."""
        if self.count < 0:
            self._fill()
        rng = self.range
        split = (rng * prob + (256 - prob)) >> 8
        bigsplit = split << 56
        value = self.value
        if value >= bigsplit:
            bit = 1
            rng -= split
            value -= bigsplit
        else:
            bit = 0
            rng = split
        shift = VPX_NORM[rng]
        self.range = rng << shift
        self.value = (value << shift) & _MASK64
        self.count -= shift
        return bit
