"""ThreadHandoff serialization + thread-split selection.

Copy of lepton_tpu/container/handoff.py (reference
src/lepton/thread_handoff.{hh,cc} 16-byte records, and the split selection
of write_ujpg, jpgcoder.cc:3861-3945).
"""
from __future__ import annotations

from typing import List

from ..jpeg.decoder import ThreadHandoff

BYTES_PER_HANDOFF = 16


def serialize_handoffs(handoffs: List[ThreadHandoff]) -> bytes:
    out = bytearray()
    out.append(ord("H"))
    out.append(len(handoffs))
    for th in handoffs:
        out += th.luma_y_start.to_bytes(2, "little")
        out += (th.segment_size & 0xFFFFFFFF).to_bytes(4, "little")
        out.append(th.overhang_byte & 0xFF)
        out.append(th.num_overhang_bits & 0xFF)
        for i in range(4):
            dc = th.last_dc[i] if i < len(th.last_dc) else 0
            out += (dc & 0xFFFF).to_bytes(2, "little")
    return bytes(out)


def deserialize_handoffs(data: bytes) -> List[ThreadHandoff]:
    if len(data) < 2 or data[0] != ord("H"):
        raise ValueError("bad handoff record")
    num = data[1]
    if len(data) - 2 < BYTES_PER_HANDOFF * num:
        raise ValueError("short handoff record")
    out = []
    p = 2
    for _ in range(num):
        th = ThreadHandoff()
        th.luma_y_start = int.from_bytes(data[p:p + 2], "little")
        th.segment_size = int.from_bytes(data[p + 2:p + 6], "little")
        th.overhang_byte = data[p + 6]
        th.num_overhang_bits = data[p + 7]
        th.last_dc = []
        for i in range(4):
            dc = int.from_bytes(data[p + 8 + 2 * i:p + 10 + 2 * i], "little")
            if dc >= 32768:
                dc -= 65536
            th.last_dc.append(dc)
        out.append(th)
        p += BYTES_PER_HANDOFF
    for i in range(1, len(out)):
        out[i - 1].luma_y_end = out[i].luma_y_start
    return out


def choose_num_threads(num_rows: int, framebuffer_byte_size: int,
                       max_threads: int = 8, min_threads: int = 1) -> int:
    """Thread-count heuristic (jpgcoder.cc:3898-3916)."""
    nt = max_threads
    if num_rows // 2 < nt:
        desired = max(num_rows // 2, min_threads)
        nt = min(max(desired, 1), nt)
    if framebuffer_byte_size < 125000:
        nt = min(max(min_threads, 1), nt)
    elif framebuffer_byte_size < 250000:
        nt = min(max(min_threads, 2), nt)
    elif framebuffer_byte_size < 500000:
        nt = min(max(min_threads, 4), nt)
    return nt


def select_splits(row_handoffs: List[ThreadHandoff], num_threads: int,
                  even_split: bool = False) -> List[ThreadHandoff]:
    """Split rows into segments proportional to compressed size
    (write_ujpg, jpgcoder.cc:3917-3960)."""
    n = len(row_handoffs)
    split_indices = [0] * num_threads
    if not even_split:
        for i in range(num_threads - 1):
            desired = row_handoffs[-1].segment_size
            desired -= row_handoffs[0].segment_size
            desired = desired * (i + 1) // num_threads
            desired += row_handoffs[0].segment_size
            # lower_bound by segment_size over [1, n)
            lo, hi = 1, n
            while lo < hi:
                mid = (lo + hi) // 2
                if row_handoffs[mid].segment_size < desired:
                    lo = mid + 1
                else:
                    hi = mid
            split = lo
            if split != 1:
                split -= 1
            split_indices[i] = split
    else:
        for i in range(num_threads - 1):
            split_indices[i] = n * (i + 1) // num_threads
    # degenerate splits -> even fallback (jpgcoder.cc:3946-3953)
    for i in range(num_threads - 1):
        if split_indices[i] == split_indices[i + 1]:
            for j in range(num_threads - 1):
                split_indices[j] = (j + 1) * n // num_threads
            break
    split_indices[num_threads - 1] = n - 1

    selected: List[ThreadHandoff] = []
    last = 0
    for i in range(num_threads):
        begin, end = last, split_indices[i]
        last = end
        a, b = row_handoffs[begin], row_handoffs[end]
        th = ThreadHandoff(
            luma_y_start=a.luma_y_start,
            luma_y_end=b.luma_y_start,
            segment_size=b.segment_size - a.segment_size,
            overhang_byte=a.overhang_byte,
            num_overhang_bits=a.num_overhang_bits,
            last_dc=list(a.last_dc))
        if i + 1 == num_threads and row_handoffs[end].num_overhang_bits:
            th.segment_size += 1  # room for the final overhang byte
        selected.append(th)
    return selected
