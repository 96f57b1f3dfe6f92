"""Big-endian bit I/O over JPEG entropy-coded (destuffed) scan data.

Semantically equivalent to the reference's abitreader/abitwriter
(src/lepton/bitops.hh:66-360) including the overhang-byte contract used for
thread handoffs:

  - getpos(): (bits_consumed >> 3) + 1 (the reference's byte cursor)
  - overhang(): (rem, byte) where rem = bits_consumed & 7 and byte holds the
    already-consumed top bits of the in-progress byte
  - pad(fillbit): pads to a byte boundary with bits taken from the fillbit
    pattern (LSB first), as recorded by unpad() on decode

Verbatim copy of lepton_tpu/jpeg/bitio.py: the port keeps its own host layers.
"""
from __future__ import annotations


class BitReader:
    __slots__ = ("data", "nbits", "pos", "eof")

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = len(data) * 8
        self.pos = 0  # bits consumed
        self.eof = len(data) == 0

    def read(self, n: int) -> int:
        """Read n bits MSB-first; zero-fills and sets eof past the end."""
        if self.eof or n == 0:
            return 0
        data = self.data
        pos = self.pos
        end = pos + n
        if end >= self.nbits:
            avail = self.nbits - pos
            # take the available bits, shift up as if zero-padded
            val = self._extract(pos, avail) << (n - avail) if avail else 0
            self.pos = self.nbits
            self.eof = True
            return val & ((1 << n) - 1)
        val = self._extract(pos, n)
        self.pos = end
        if self.pos == self.nbits:
            self.eof = True
        return val

    def _extract(self, pos: int, n: int) -> int:
        first = pos >> 3
        last = (pos + n - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        total_bits = (last - first + 1) * 8
        chunk >>= total_bits - (pos - (first << 3)) - n
        return chunk & ((1 << n) - 1)

    def getpos(self) -> int:
        return (self.pos >> 3) + 1

    def overhang(self):
        rem = self.pos & 7
        if rem == 0:
            return 0, 0
        byte = self.data[self.pos >> 3]
        return rem, byte & ((0xFF << (8 - rem)) & 0xFF)

    def remainder_bits(self) -> int:
        rem = self.pos & 7
        return (8 - rem) if rem else 0

    def unpad(self, fillbit: int) -> int:
        """Consume pad bits up to the byte boundary and return the recorded
        fill pattern (bitops.hh:315-333)."""
        if (self.pos & 7) == 0 or self.eof:
            return fillbit
        last_bit = self.read(1)
        fill = last_bit
        offset = 1
        while self.pos & 7:
            last_bit = self.read(1)
            fill |= last_bit << offset
            offset += 1
        while offset < 7:
            fill |= last_bit << offset
            offset += 1
        return fill


class BitWriter:
    __slots__ = ("chunks", "nbytes", "buf", "bits", "fillbit", "size_bound",
                 "bound_hit")

    def __init__(self, size_bound: int = 0):
        self.chunks = bytearray()
        self.nbytes = 0
        self.buf = 0      # partial byte bits (top-aligned in a byte)
        self.bits = 0     # number of valid bits in buf (0..7)
        self.fillbit = 1
        # reference adds 8 slack bytes to a nonzero bound (bitops.cc:74-76)
        self.size_bound = size_bound + 8 if size_bound else 0
        self.bound_hit = False

    def bound_reached(self) -> bool:
        return bool(self.size_bound) and self.nbytes >= self.size_bound

    def write(self, val: int, n: int) -> None:
        if n == 0 or self.bound_reached():
            if self.bound_reached():
                self.bound_hit = True
            return
        val &= (1 << n) - 1
        acc = (self.buf << n) | val
        total = self.bits + n
        chunks = self.chunks
        while total >= 8:
            total -= 8
            chunks.append((acc >> total) & 0xFF)
            self.nbytes += 1
        self.buf = acc & ((1 << total) - 1)
        self.bits = total

    def pad(self, fillbit: int) -> None:
        offset = 1
        while self.bits & 7:
            self.write(1 if (fillbit & offset) else 0, 1)
            offset <<= 1

    def no_remainder(self) -> bool:
        return self.bits == 0 or self.bound_reached()

    def get_num_overhang_bits(self) -> int:
        return self.bits

    def get_overhang_byte(self) -> int:
        return (self.buf << (8 - self.bits)) & 0xFF if self.bits else 0

    def reset_from_overhang(self, overhang_byte: int, num_bits: int) -> None:
        self.chunks = bytearray()
        if self.size_bound:
            self.size_bound -= self.nbytes
        self.nbytes = 0
        self.bits = num_bits
        self.buf = (overhang_byte >> (8 - num_bits)) if num_bits else 0

    def take_bytes(self) -> bytearray:
        """Drain the whole bytes written so far (overhang stays buffered).

        Mirrors reset_crystallized_bytes (bitops.hh:216-224): the size bound
        tracks the remaining budget after each drain.
        """
        out = self.chunks
        self.chunks = bytearray()
        if self.size_bound:
            self.size_bound -= self.nbytes
        self.nbytes = 0
        return out

    def getpos(self) -> int:
        return self.nbytes
