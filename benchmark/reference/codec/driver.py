"""Row scheduling and the per-segment encode/decode drivers.

Copy of lepton_tpu/codec/driver.py (:1-198):
  - RowSpec and row_spec_from_index (LeptonCodec_row_spec_from_index,
    reference lepton_codec.hh:41-100): it interleaves channels per MCU row
    identically on encode, decode and recode;
  - SegmentState, ImageData, encode_segment and decode_segment
    (process_row_range, vp8_encoder.cc:239-445 / vp8_decode_thread,
    lepton_codec.cc): each thread-segment covers [min_luma_y, max_luma_y)
    with an independent model + bool-coder stream and fresh neighbor
    state.

One difference, on purpose: encode_segment and decode_segment take the
trained-model template (LEPTON_COMPRESSION_MODEL, normalized as host.py
loads it) as each segment's start state, as the C codec does; the JAX
package's Python codec always starts from the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..coder.vpx import BoolReader, BoolWriter
from ..model.context import ColorTables
from ..model.tables import Model
from .blocks import Coder, decode_block, encode_block

NUM_CMP_SLOTS = 3  # ColorChannel::NumBlockTypes without ALLOW_FOUR_COLORS


@dataclass
class RowSpec:
    min_row_luma_y: int
    next_row_luma_y: int
    luma_y: int
    component: int
    curr_y: int
    mcu_row_index: int
    last_row_to_complete_mcu: bool
    skip: bool
    done: bool


def row_spec_from_index(decode_index: int, heights, mcuv: int,
                        max_coded_heights, num_cmp: int = None) -> RowSpec:
    """Exact port of LeptonCodec_row_spec_from_index (lepton_codec.hh:41).
    num_cmp = NumBlockTypes: 3, or 4 for CMYK (ALLOW_FOUR_COLORS)."""
    if num_cmp is None:
        num_cmp = 4 if len([h for h in heights if h]) == 4 else NUM_CMP_SLOTS
    component_multiple = [0] * num_cmp
    mcu_multiple = 0
    for i in range(num_cmp):
        component_multiple[i] = heights[i] // mcuv if heights[i] else 0
        mcu_multiple += component_multiple[i]
    mcu_row = decode_index // mcu_multiple
    place_within_scan = decode_index - mcu_row * mcu_multiple
    spec = RowSpec(
        min_row_luma_y=mcu_row * component_multiple[0],
        next_row_luma_y=(mcu_row + 1) * component_multiple[0],
        luma_y=mcu_row * component_multiple[0],
        component=num_cmp, curr_y=0, mcu_row_index=mcu_row,
        last_row_to_complete_mcu=False, skip=False, done=False)
    i = num_cmp - 1
    while True:
        if place_within_scan < component_multiple[i]:
            spec.component = i
            spec.curr_y = mcu_row * component_multiple[i] + place_within_scan
            spec.last_row_to_complete_mcu = (
                place_within_scan + 1 == component_multiple[i] and i == 0)
            if spec.curr_y >= max_coded_heights[i]:
                spec.skip = True
                spec.done = True
                for j in range(num_cmp - 1):
                    if mcu_row * component_multiple[j] < max_coded_heights[j]:
                        spec.done = False
            if i == 0:
                spec.luma_y = spec.curr_y
            break
        place_within_scan -= component_multiple[i]
        if i == 0:
            spec.skip = True
            spec.done = True
            break
        i -= 1
    return spec


class SegmentState:
    """Per-segment mutable codec state: model + neighbor rings.  template:
    ARENA_SIZE x (false count, true count, prob) start bytes, or None for
    the identity model."""

    def __init__(self, widths, template: Optional[bytes] = None):
        self.model = Model()
        if template is not None:
            self.model.raw[:] = template
        self.is_top_row = [True] * max(NUM_CMP_SLOTS, len(widths))
        # 2-row ring of summaries: [comp][ring][x] -> [nz, edge_pixels int16[16]]
        self.summaries = []
        for w in widths:
            ring = [[[0, np.zeros(16, dtype=np.int16)] for _ in range(w)]
                    for _ in range(2)]
            self.summaries.append(ring)


class ImageData:
    """Shared image geometry + coefficient planes (colldata equivalent)."""

    def __init__(self, planes: List[np.ndarray],
                 colors: List[ColorTables], mcuv: int,
                 max_coded_heights=None, component_sizes=None):
        # planes[c]: int16[bcv][bch][64] raster-order coefficients
        self.planes = planes
        self.colors = colors
        self.mcuv = mcuv
        self.ncomp = len(planes)
        nslots = max(NUM_CMP_SLOTS, self.ncomp)
        self.heights = [0] * nslots
        self.widths = [0] * nslots
        for i, p in enumerate(planes):
            self.heights[i] = p.shape[0]
            self.widths[i] = p.shape[1]
        if max_coded_heights is None:
            max_coded_heights = list(self.heights)
        self.max_coded_heights = list(max_coded_heights) + [0] * max(
            0, nslots - len(max_coded_heights))
        if component_sizes is None:
            component_sizes = [p.shape[0] * p.shape[1] for p in planes]
        self.component_sizes = component_sizes

    def color_index(self, comp: int) -> int:
        return 0 if comp == 0 else 1


def _process_row(image: ImageData, state: SegmentState, coder: Coder,
                 comp: int, y: int, encode: bool) -> None:
    plane = image.planes[comp]
    width = plane.shape[1]
    colors = image.colors[comp]
    ci = image.color_index(comp)
    top = state.is_top_row[comp]
    if top:
        state.is_top_row[comp] = False
    ring = state.summaries[comp]
    cur = ring[y & 1]
    abv = ring[1 - (y & 1)]
    row = plane[y]
    above_row = plane[y - 1] if not top else None
    size_limit = image.component_sizes[comp]
    base = y * width
    fn = encode_block if encode else decode_block
    for x in range(width):
        left = row[x - 1] if x > 0 else None
        above = above_row[x] if above_row is not None else None
        aboveleft = (above_row[x - 1]
                     if (above_row is not None and x > 0) else None)
        left_summary = cur[x - 1] if x > 0 else None
        above_summary = abv[x] if not top else None
        fn(coder, ci, colors, row[x], left, above, aboveleft,
           left_summary, above_summary, cur[x])
        if base + x + 1 >= size_limit:
            return


def _run_segment(image: ImageData, coder: Coder, min_y: int, max_y: int,
                 is_last_thread: bool, encode: bool,
                 template: Optional[bytes] = None) -> None:
    state = SegmentState([image.widths[i] for i in range(image.ncomp)],
                         template)
    coder.arena = state.model.raw
    index = 0
    while True:
        spec = row_spec_from_index(index, image.heights, image.mcuv,
                                   image.max_coded_heights)
        index += 1
        if spec.done:
            break
        if spec.luma_y >= max_y and not is_last_thread:
            break
        if spec.skip:
            continue
        if spec.luma_y < min_y:
            continue
        _process_row(image, state, coder, spec.component, spec.curr_y, encode)


def encode_segment(image: ImageData, min_y: int, max_y: int,
                   is_last_thread: bool, ans: bool = False,
                   template: Optional[bytes] = None) -> bytes:
    """Encode one thread-segment into an independent arithmetic stream,
    from `template` (SegmentState) or the identity model."""
    if ans:
        from ..coder.ans import ANSWriter
        writer = ANSWriter()
    else:
        writer = BoolWriter()
    coder = Coder(writer=writer, ans=ans)
    _run_segment(image, coder, min_y, max_y, is_last_thread, True, template)
    return writer.finish()


def decode_segment(image: ImageData, data: bytes, min_y: int, max_y: int,
                   is_last_thread: bool, ans: bool = False,
                   template: Optional[bytes] = None) -> None:
    """Decode one thread-segment stream into the shared planes, from
    `template` (SegmentState) or the identity model."""
    if ans:
        from ..coder.ans import ANSReader
        reader = ANSReader(data)
    else:
        reader = BoolReader(data)
    coder = Coder(reader=reader, ans=ans)
    _run_segment(image, coder, min_y, max_y, is_last_thread, False, template)
