"""The token decoder kernel's branch cache, from the CPU: its shared-memory
budget, the constants the wrapper shares with csrc/vpx_decoder.cu, the
replay of what the cache holds (vpx_decoder.cache_fill) against a read-by-
read model of the kernel's lookup, a sizing guard on a lane of the main
path's size, and the kernels' reciprocal branch update
(csrc/vpx_branch.cuh) replayed in Python integers against the division.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_decode_cache.py -q
"""
import re

import numpy as np
import pytest

import chip_smoke
from lepton_tpu_torch import api
from lepton_tpu_torch.kernels import batch_encode, cuda_build, vpx_coder
from lepton_tpu_torch.kernels import vpx_decoder as vd
from lepton_tpu_torch.model.branch import adv_update_branch, update_branch
from lepton_tpu_torch.model.tables import ARENA_SIZE
from lepton_tpu_torch.probes import decoder_ablation


def _constant(name: str) -> int:
    src = open(cuda_build.source("vpx_decoder")).read()
    m = re.search(rf"constexpr \w+ {name} = (0x[0-9A-Fa-f]+|\d+)u?;", src)
    assert m, f"{name} not found in vpx_decoder.cu"
    return int(m.group(1), 0)


def test_wrapper_constants_match_the_kernel():
    assert _constant("kFixedSmem") == vd.FIXED_SMEM
    assert _constant("kProbes") == vd.CACHE_PROBES
    assert _constant("kHashMul") == vd.CACHE_HASH


def test_shared_memory_budget():
    """Both readers are one kernel template with one layout: the fixed part
    and the cache the wrapper asks for fit in the 232,448 bytes a CTA may
    hold on the H100, and a cache of twice the size would not."""
    slots = vd.cache_slots()
    assert slots >= 16384
    assert vd.smem_bytes(slots) <= vd.SMEM_LIMIT == 232448
    assert vd.smem_bytes(2 * slots) > vd.SMEM_LIMIT


def _lookup_model(reads, slots):
    """The kernel's Model::read, read by read, on a dict of slots, with a
    read count in place of each branch's value: (hits, inserts,
    fall-through reads, {key: reads counted where the branch lives})."""
    tags, vals, arena = {}, {}, {}
    hits = inserts = falls = 0
    for idx in reads:
        key = idx + 1
        home = ((key * vd.CACHE_HASH) & 0xFFFFFFFF) * slots >> 32
        for i in range(vd.CACHE_PROBES):
            slot = (home + i) % slots
            if tags.get(slot) == key:
                hits += 1
                break
            if slot not in tags:
                tags[slot] = key
                vals[slot] = arena.get(idx, 0)
                inserts += 1
                break
        else:
            arena[idx] = arena.get(idx, 0) + 1
            falls += 1
            continue
        vals[slot] += 1
    final = {tags[s]: v for s, v in vals.items()}
    final.update({i + 1: v for i, v in arena.items()})
    return hits, inserts, falls, final


@pytest.mark.parametrize("slots", [1, 8, 64, 16384])
def test_cache_fill_replays_the_lookup(slots):
    """cache_fill (first uses only) counts what the read-by-read lookup
    does, and every read of every branch lands on one copy of it."""
    rng = np.random.default_rng(slots)
    reads = rng.integers(0, ARENA_SIZE, 300)
    reads = np.concatenate([reads, reads[rng.integers(0, 300, 3000)]])
    hits, inserts, falls, final = _lookup_model(reads.tolist(), slots)
    assert vd.cache_fill(reads, slots) == (inserts, falls,
                                           len(np.unique(reads)))
    assert hits + inserts + falls == len(reads)
    uniq, counts = np.unique(reads, return_counts=True)
    assert final == {int(u) + 1: int(c) for u, c in zip(uniq, counts)}


def test_main_path_lanes_fit_the_cache():
    """Lanes of the main path's size (a 2016x1512 photo in 4 segments, over
    a million reads each) touch under a quarter of cache_slots() distinct
    branches, so none falls through to device memory."""
    jpeg = chip_smoke.make_photo(chip_smoke.SEED, 2016, 1512)
    parsed, info, dec = api._parse(jpeg)
    splits, _ = api._plan(dec, 4)
    idx, _, _ = batch_encode.assemble_lanes(
        [api._describe(info, dec, splits)], "cpu", framed=False)
    idx = idx.numpy()
    assert len(idx) == 4
    slots = vd.cache_slots()
    for row in idx:
        row = row[row != vpx_coder.PAD]
        assert len(row) > 1_000_000
        inserts, falls, distinct = vd.cache_fill(row, slots)
        assert distinct < slots // 4
        assert (inserts, falls) == (distinct, 0)


def test_ablation_edits_apply():
    """Every edit of probes/decoder_ablation finds its one anchor in the
    kernel source, so the ablations still build from it."""
    base = decoder_ablation.variant_source([])
    for name, edits in decoder_ablation.ABLATIONS.items():
        assert (decoder_ablation.variant_source(edits) != base) == bool(edits)


def _recip_update(fc, tc, obs, adv):
    """vpx_branch.cuh's update in Python integers: next_counts, then the
    quotient as __umulhi with rcp[d] = ceil(2^32 / d) (n itself for d ==
    1), then update_branch or update_branch_adv."""
    f0, t0 = (129, (1 + tc) >> 1) if fc == 0xFF else (fc + 1, tc)
    f1, t1 = ((1 + fc) >> 1, 129) if tc == 0xFF else (fc, tc + 1)
    nf, nt = (f1, t1) if obs else (f0, t0)
    num, d = nf << 8, nf + nt
    assert 1 <= d < 512 and num < 1 << 16
    q = num if d == 1 else (num * (((1 << 32) + d - 1) // d)) >> 32
    if adv:
        return nf, nt, (q & 0xFF) | 1
    if obs and tc == 0xFF and fc == 1:
        return 1, 0xFF, 0
    if not obs and fc == 0xFF and tc == 1:
        return 0xFF, 1, 255
    return nf, nt, q & 0xFF


@pytest.mark.parametrize("adv", [False, True], ids=["vpx", "adv"])
def test_reciprocal_update_every_state(adv):
    """The kernels' reciprocal branch update equals model/branch.py's
    division rules on all 2^17 (fc, tc, bit) states."""
    for fc in range(256):
        for tc in range(256):
            for obs in (False, True):
                if adv:
                    want = adv_update_branch(fc, tc, obs)
                else:
                    want = update_branch(fc, tc, 0, obs)
                    want = (want[0], want[1], want[2] & 0xFF)
                assert _recip_update(fc, tc, obs, adv) == want, (fc, tc, obs)
