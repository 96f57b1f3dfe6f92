"""Decompression memory bound oracle.

Equivalent of decompression_memory_bound (reference jpgcoder.cc:1236-1330):
computes the exact buffer footprint a decode will need so callers can
enforce a declared memory envelope (-recodememory=).

Copy of lepton_tpu/util/membound.py but for its unused check_memory_bound;
the host decode it bounds is host.decompress_streaming and
host.decompress, the same C codec.
"""
from __future__ import annotations

from ..model.tables import ARENA_SIZE


def decompression_memory_bound(info, num_threads: int,
                               original_size: int,
                               streaming: bool = True) -> int:
    """Upper bound in bytes for decoding one .lep of this geometry.

    `streaming` reflects the O(width) ring-plane decode
    (host.decompress_streaming, the reference's 2-row memory-optimized mode
    chosen at jpgcoder.cc:4216): plane memory is a few rows per component,
    not the full framebuffer."""
    if streaming:
        planes = 0
        for c in range(info.cmpc):
            ci = info.cmpnfo[c]
            cm = max(1, ci.bcv // info.mcuv) if info.mcuv else 1
            rr = 1
            while rr < cm + 1:
                rr <<= 1
            planes += rr * ci.bch * 64 * 2
        # the streaming decode runs segments SEQUENTIALLY: exactly one
        # C StreamDecoder arena is live at a time (created, run, closed
        # before the next — host.decompress_streaming ensure_decoded),
        # plus the image's template/working arena (NativeImage.arena)
        models = 2 * ARENA_SIZE * 3
    else:
        planes = sum(info.cmpnfo[c].bc * 64 * 2 for c in range(info.cmpc))
        models = (num_threads + 1) * ARENA_SIZE * 3
    # neighbor rings: 2 rows x width x (nz + 16 edge pixels)
    rings = sum(2 * info.cmpnfo[c].bch * 40 for c in range(info.cmpc)) \
        * (1 if streaming else num_threads)
    # Constants are calibrated, not guessed: the JAX package's
    # tests/test_sandbox.py (test_membound_calibrated) measures the
    # decode's actual Python-side peak via tracemalloc across corpus
    # geometries and asserts this oracle bounds it; the reference instead
    # derives its exact per-buffer sum from its arena bookkeeping
    # (jpgcoder.cc:1236-1316).
    # demuxed segment streams are held once (each segment's buffer is
    # released as its StreamDecoder takes ownership), plus mux overhead
    streams = original_size + 65536 * num_threads
    # re-emit output buffer + the final immutable bytes copy (both live
    # at the peak moment) + the C recode bit-writer scratch
    # (lepton_recode_rows tmp, out_bound + 64K)
    output = 3 * original_size + 196608
    # fixed decode overhead, measured: 16-bit Huffman peek LUTs
    # (8 x ~0.25MB), rebuilt header segments (~1MB), container header
    # block (~1MB), allocator metadata/fragmentation slack (~2MB)
    fixed = 6 << 20
    return planes + models + rings + streams + output + fixed
