"""Encode geometry: which block rows each segment codes, in which order.

Copy of plan_rows and segment_top_rows from
lepton_tpu/kernels/encode_pipeline.py (:27-69).  Host-only numpy-free
planning over the row_spec interleave of lepton_codec.hh:41-100.  Its
_bucket, which rounds lane lengths up to a few jit shapes, has no use in
eager PyTorch and is not copied.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from ..codec.driver import row_spec_from_index


def plan_rows(heights: Sequence[int], mcuv: int,
              max_coded_heights: Sequence[int],
              splits_y: Sequence[int]) -> List[List[Tuple[int, int]]]:
    """Per-segment (component, row) visit lists in row_spec order.

    splits_y: luma_y_start of each segment (ascending); the last segment
    runs to the end (is_last_thread semantics of _run_segment).
    """
    nseg = len(splits_y)
    bounds = list(splits_y) + [1 << 30]
    out = [[] for _ in range(nseg)]
    index = 0
    heights = list(heights) + [0] * max(0, 3 - len(heights))
    mh = list(max_coded_heights) + [0] * max(0, 3 - len(max_coded_heights))
    while True:
        spec = row_spec_from_index(index, heights, mcuv, mh)
        index += 1
        if spec.done:
            break
        if spec.skip:
            continue
        # the owning segment: largest s with bounds[s] <= luma_y
        s = 0
        for k in range(nseg):
            if bounds[k] <= spec.luma_y:
                s = k
        out[s].append((spec.component, spec.curr_y))
    return out


def segment_top_rows(plans: List[List[Tuple[int, int]]],
                     ncomp: int) -> List[set]:
    """Rows whose above-context is absent: the first processed row of
    each component within each segment (is_top_row reset,
    lepton_codec.hh:173-181)."""
    tops = [set() for _ in range(ncomp)]
    for plan in plans:
        seen = set()
        for comp, y in plan:
            if comp not in seen:
                seen.add(comp)
                tops[comp].add(y)
    return tops

