"""Row scheduling: the flat index -> (component, row) interleave.

Copy of RowSpec and row_spec_from_index from lepton_tpu/codec/driver.py
(LeptonCodec_row_spec_from_index, reference lepton_codec.hh:41-100): it
interleaves channels per MCU row identically on encode, decode and recode.
"""
from __future__ import annotations

from dataclasses import dataclass

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
