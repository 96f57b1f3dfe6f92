"""The least time a kernel's work needs, by the bytes it must move.

Counted from quantities that the format fixes, whatever implements it: a
layer's share of its roofline is least_ms(bytes) over the kernel's time.
Every bound of the port's kernels is set by bytes (chip_smoke.py's counts
at :2666 and :2822 as of the benchmark's first commit, which this copies
without their bound by operations, whose operation counts were guesses,
and without the reader's arena term, the kernel's own scratch space).

  coder   each coded symbol read once, at SYMBOL_BYTES, and each stream
          byte and each lane's length written once
  reader  each stream byte read once, and each block's 64 int16
          coefficients written once
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3 (NVIDIA's data sheet)
SYMBOL_BYTES = 4 + 1          # a symbol's int32 branch index and uint8 bit
LANE_LENGTH_BYTES = 4         # a lane's int32 stream length
BLOCK_BYTES = 64 * 2          # a block's 64 int16 coefficients


def least_ms(moved: int) -> float:
    """ms to move `moved` bytes at the card's peak bandwidth."""
    return moved / HBM_BYTES_PER_S * 1e3


def coder_bytes(symbols: int, stream_bytes: int, lanes: int) -> int:
    return symbols * SYMBOL_BYTES + stream_bytes + lanes * LANE_LENGTH_BYTES


def reader_bytes(stream_bytes: int, blocks: int) -> int:
    return stream_bytes + blocks * BLOCK_BYTES


def jpeg_blocks(jpeg: bytes) -> int:
    """The blocks of a JPEG's coefficient planes: each component's rows and
    columns of blocks, padded to whole MCUs, from its frame header."""
    pos = 2
    while pos + 4 <= len(jpeg):
        if jpeg[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        marker = jpeg[pos + 1]
        length = int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        if marker in (0xC0, 0xC1, 0xC2):
            seg = jpeg[pos + 4:pos + 2 + length]
            height = int.from_bytes(seg[1:3], "big")
            width = int.from_bytes(seg[3:5], "big")
            comps = [(seg[6 + 3 * c + 1] >> 4, seg[6 + 3 * c + 1] & 15)
                     for c in range(seg[5])]
            hmax = max(h for h, _ in comps)
            vmax = max(v for _, v in comps)
            mcuh = -(-width // (8 * hmax))
            mcuv = -(-height // (8 * vmax))
            return sum(mcuh * h * mcuv * v for h, v in comps)
        pos += 2 + length
    raise ValueError("no frame header")
