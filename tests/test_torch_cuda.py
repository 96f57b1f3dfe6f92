"""The port on a CUDA card: symbolize's kernels (symbol_counts and
symbol_emit), the encode coders' kernels (the probability
stage and the VPX and rANS walks) and the decoder kernel (both readers)
against their plain versions, the roofline probe against its plain loop,
and the whole encode and decode, containers v1 to v3, on cuda against the
same on the CPU; and the bounds-checked builds (in subprocesses): their
negative checks raise, and their outputs equal the default builds'.

This file imports no JAX, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips.  Streams, planes and JPEGs are compared
byte for byte: the tolerance is zero.
"""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from lepton_tpu_torch import api, sanitize
from lepton_tpu_torch.kernels import (ans_coder, batch_encode, contexts,
                                      cuda_build, symbolize, vpx_coder,
                                      vpx_decoder)
from lepton_tpu_torch.kernels import branch_probs as bp
from lepton_tpu_torch.model.tables import ARENA_SIZE, arena_from_template
from lepton_tpu_torch.probes import decode_roofline
from lepton_tpu_torch.util import timing


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _template():
    """A random trained model (prob bytes 1..254): (packed, coder arena)."""
    raw = np.random.default_rng(42).integers(0, 256, (ARENA_SIZE, 3),
                                             dtype=np.uint8)
    raw[:, 2] = 1 + raw[:, 2] % 254
    packed = api.pack_model(raw)
    return packed, arena_from_template(packed)


def _counts(*walks):
    """The launch counts of the probability stage's two kernels and of
    `walks`."""
    return tuple(f.launches for f in (bp.run_heads, bp.walk_runs) + walks)


def _streams(idxs, bits, template, device):
    out, nb = vpx_coder.encode_streams(
        torch.as_tensor(idxs, device=device),
        torch.as_tensor(bits, device=device),
        None if template is None else template.to(device))
    return vpx_coder.finalize(out, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_kernel_matches_plain(cuda, start):
    """Branch reuse and a 1500-symbol carry chain, from the identity arena
    and from a random trained template."""
    template = None
    if start == "template":
        raw = np.random.default_rng(42).integers(0, 256, (ARENA_SIZE, 3),
                                                 dtype=np.uint8)
        raw[:, 2] = 1 + raw[:, 2] % 254
        template = arena_from_template(api.pack_model(raw))
    idxs, bits = vpx_coder.build_symbol_streams(
        chip_smoke.adversarial_segments())
    before = _counts(vpx_coder.vpx_walk)
    assert (_streams(idxs, bits, template, cuda)
            == _streams(idxs, bits, template, "cpu"))
    assert _counts(vpx_coder.vpx_walk) == tuple(n + 1 for n in before)


def _stage(framed, start, device):
    """chip_smoke.stage_inputs on `device`: (idx, bit, nsyms) and the start
    template (None from the identity)."""
    lanes, tpl = chip_smoke.stage_inputs(device, framed)
    return lanes, tpl if start == "template" else None


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
@pytest.mark.parametrize("rule", ["vpx", "adv"])
def test_branch_probs_kernel_matches_plain(cuda, rule, start):
    """Empty, one-symbol, odd and even lanes with branch reuse, FIXED_PROB
    and PAD slots, one branch past both count overflows, from the identity
    and from a template with a prob-0 branch; then a 0 bit at that branch
    (flagged under the adv rule only).  Each of the stage's two kernels
    equals its plain version, and the stage equals the plain stage."""
    (idx, bit, nsyms), tpl = _stage(rule == "vpx", start, cuda)
    ns = None if rule == "vpx" else nsyms
    keys, shift = bp.group(idx, bit, ns)
    heads = bp.run_heads(keys, shift)
    want_heads = bp.run_heads_plain(keys, shift)
    # the kernel's list comes in no fixed order
    assert torch.equal(torch.sort(heads).values, want_heads)
    got = bp.walk_runs(keys, shift, heads, idx.shape, tpl, rule)
    want = bp.walk_runs_plain(keys, shift, want_heads, idx.shape, tpl, rule)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    before = _counts()
    probs, zero = bp.branch_probs(idx, bit, tpl, rule, ns)
    assert _counts() == tuple(n + 1 for n in before)
    want, wzero = bp.branch_probs_plain(idx, bit, tpl, rule, ns)
    assert torch.equal(probs, want) and torch.equal(zero, wzero)
    packed, _, bad = chip_smoke.prob0_lanes()
    idx, bit, nsyms = (torch.as_tensor(a, device=cuda)
                       for a in chip_smoke.unframed_lanes(bad))
    tpl = arena_from_template(packed).to(cuda)
    _, zero = bp.branch_probs(idx, bit, tpl, rule, nsyms)
    assert zero.tolist() == [False, rule == "adv"]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["vpx", "adv"])
def test_branch_update_every_state(cuda, rule):
    """Each of the 65,536 (fc, tc) count pairs as a template branch, met
    twice in lane b with bit b first: the second probability is the
    update's, and it equals model/branch.py's division on every (fc, tc,
    bit), so the kernels' reciprocal division (csrc/vpx_branch.cuh) is
    exact on the card."""
    from lepton_tpu_torch.model.branch import (adv_update_branch,
                                               update_branch)
    n = 1 << 16
    state = np.arange(n)
    tpl = np.full(ARENA_SIZE, 1 | 1 << 8 | 128 << 16, np.int32)
    tpl[:n] = (state & 0xFF) | (state >> 8) << 8 | 128 << 16
    idx = np.repeat(state, 2)[None].repeat(2, 0).astype(np.int32)
    bit = np.zeros_like(idx, dtype=np.uint8)
    bit[1, 0::2] = 1
    nsyms = torch.full((2,), 2 * n, dtype=torch.int32, device=cuda)
    probs, _ = bp.branch_probs(
        torch.as_tensor(idx, device=cuda), torch.as_tensor(bit, device=cuda),
        torch.as_tensor(tpl, device=cuda), rule,
        nsyms if rule == "adv" else None)
    probs = probs.cpu().numpy()
    assert (probs[:, 0::2] == 128).all()
    for b in (0, 1):
        if rule == "adv":
            want = [adv_update_branch(s & 0xFF, s >> 8, bool(b))[2]
                    for s in range(n)]
        else:
            want = [update_branch(s & 0xFF, s >> 8, 128, bool(b))[2] & 0xFF
                    for s in range(n)]
        assert np.array_equal(probs[b, 1::2], np.asarray(want))


@pytest.mark.cuda
def test_branch_probs_kernel_hot_branch(cuda):
    """64 lanes that all share one hot branch, 300,000 occurrences each:
    64 runs of 300,000 steps, the kernel's longest."""
    n = 300_000
    bits = np.random.default_rng(3).integers(0, 2, (64, n), dtype=np.uint8)
    idx = torch.full((64, n), 4321, dtype=torch.int32, device=cuda)
    bit = torch.as_tensor(bits, device=cuda)
    for rule in ("vpx", "adv"):
        stats = {}
        with timing.part(stats):
            probs, _ = bp.branch_probs(idx, bit, None, rule)
        assert stats["longest_run"] == n
        want, _ = bp.branch_probs_plain(idx.cpu(), bit.cpu(), None, rule)
        assert torch.equal(probs.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_vpx_walk_kernel_matches_plain(cuda, start):
    (idx, bit, _), tpl = _stage(True, start, cuda)
    probs, _ = bp.branch_probs(idx, bit, tpl, "vpx")
    before = vpx_coder.vpx_walk.launches
    got = vpx_coder.finalize(*vpx_coder.vpx_walk(idx, bit, probs))
    assert vpx_coder.vpx_walk.launches == before + 1
    assert got == vpx_coder.finalize(*vpx_coder.vpx_walk_plain(idx, bit,
                                                               probs))


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_ans_walk_kernel_matches_plain(cuda, start):
    (idx, bit, nsyms), tpl = _stage(False, start, cuda)
    probs, _ = bp.branch_probs(idx, bit, tpl, "adv", nsyms)
    before = ans_coder.ans_walk.launches
    got = ans_coder.finalize_ans(*ans_coder.ans_walk(probs, bit, nsyms))
    assert ans_coder.ans_walk.launches == before + 1
    assert got == ans_coder.finalize_ans(*ans_coder.ans_walk_plain(
        probs, bit, nsyms))


@pytest.mark.cuda
@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_walk_kernel_relaunches_on_overflow(cuda, coder, monkeypatch):
    """A 4-unit first cap: the walk kernel runs twice and gives the streams
    of a roomy first launch."""
    (idx, bit, nsyms), _ = _stage(coder == "vpx", "identity", cuda)
    if coder == "vpx":
        mod = vpx_coder
        probs, _ = bp.branch_probs(idx, bit)
        walk = vpx_coder.vpx_walk
        run = lambda: vpx_coder.finalize(*walk(idx, bit, probs))
    else:
        mod = ans_coder
        probs, _ = bp.branch_probs(idx, bit, None, "adv", nsyms)
        walk = ans_coder.ans_walk
        run = lambda: ans_coder.finalize_ans(*walk(probs, bit, nsyms))
    want = run()
    monkeypatch.setattr(mod, "default_cap", lambda L: 4)
    before = walk.launches
    assert run() == want
    assert walk.launches == before + 2


@pytest.mark.cuda
def test_compress_device_cuda_equals_cpu(cuda):
    data = chip_smoke.make_photo(3, 96, 64)
    assert api.compress_device(data, num_segments=4) \
        == api.compress_device(data, num_segments=4, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_decoder_kernel_matches_plain(cuda, start):
    """Two requests of different geometry and quality, 3 lanes, decoded in
    one launch and by the plain version on the same CUDA tensors."""
    packed = tpl = None
    if start == "template":
        raw = np.random.default_rng(42).integers(0, 256, (ARENA_SIZE, 3),
                                                 dtype=np.uint8)
        raw[:, 2] = 1 + raw[:, 2] % 254
        packed = api.pack_model(raw)
        tpl = arena_from_template(packed).to(cuda)
    pairs = [chip_smoke.small_lep(7, 96, 64, 90, 2, packed),
             chip_smoke.small_lep(8, 48, 32, 60, 1, packed)]
    plan = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                    for i, (_, lep) in enumerate(pairs)])
    inputs = plan.to(cuda)
    before = vpx_decoder.decode_lanes.launches
    coef, err = vpx_decoder.decode_lanes(**inputs, template=tpl)
    assert vpx_decoder.decode_lanes.launches == before + 1
    coef_p, err_p = vpx_decoder.decode_lanes_plain(**inputs, template=tpl)
    assert torch.equal(coef, coef_p) and torch.equal(err, err_p)
    assert not err.any()


@pytest.mark.cuda
def test_decompress_device_cuda_equals_cpu(cuda):
    data = chip_smoke.make_photo(4, 96, 64)
    lep = api.compress_device(data, num_segments=4)
    assert api.decompress_device(lep) == data
    assert api.batch_decompress_device([lep, lep]) \
        == api.batch_decompress_device([lep, lep], device="cpu")


def _jpeg(w, h, seed, mode, **kw) -> bytes:
    """A smooth gradient plus noise, saved by PIL (as
    tests/test_torch_encode._jpeg makes it; that module imports JAX)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 255 / w + yy * 255 / h) / 2
    ch = np.clip(base + rng.normal(0, 24, size=(h, w)), 0, 255)
    ch = ch.astype(np.uint8)
    img = Image.fromarray(ch, "L") if mode == "L" else Image.fromarray(
        np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)], -1), "RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


GEOMETRIES = [
    ("444_q95", 40, 24, "RGB", dict(quality=95, subsampling=0), 1, 1.0),
    ("422_q50", 48, 32, "RGB", dict(quality=50, subsampling=1), 2, 1.0),
    ("gray", 33, 17, "L", dict(quality=85), 1, 1.0),
    ("odd_dims", 37, 21, "RGB", dict(quality=80, subsampling=2), 1, 1.0),
    ("restart_markers", 48, 48, "RGB",
     dict(quality=80, restart_marker_blocks=4, subsampling=2), 3, 1.0),
    ("gray_segments", 24, 40, "L", dict(quality=90), 4, 1.0),
    ("early_eof", 64, 64, "RGB", dict(quality=80, subsampling=2), 1, 0.6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,w,h,mode,kw,k,cut", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_decoder_kernel_geometries(cuda, name, w, h, mode, kw, k, cut):
    """The decoder kernel on the geometries the 4:2:0 photos of
    chip_smoke.py do not reach: the JPEG comes back byte for byte."""
    data = _jpeg(w, h, len(name), mode, **kw)
    data = data[:int(len(data) * cut)]
    lep = chip_smoke.encode_in_segments(data, k)
    before = vpx_decoder.decode_lanes.launches
    assert api.decompress_device(lep) == data
    assert vpx_decoder.decode_lanes.launches == before + 1


def _ans_streams(lanes, template, device):
    idx, bit, nsyms = (torch.as_tensor(a, device=device) for a in lanes)
    out, nw = ans_coder.encode_streams_ans(
        idx, bit, nsyms, None if template is None else template.to(device))
    return ans_coder.finalize_ans(out, nw)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_ans_coder_kernel_matches_plain(cuda, start):
    """Empty, one-symbol, odd and even lanes, one branch past both count
    overflows, and a long lane, from the identity arena and a template."""
    template = _template()[1] if start == "template" else None
    lanes = chip_smoke.unframed_lanes(
        chip_smoke.ans_adversarial_segments(4000))
    before = _counts(ans_coder.ans_walk)
    assert (_ans_streams(lanes, template, cuda)
            == _ans_streams(lanes, template, "cpu"))
    assert _counts(ans_coder.ans_walk) == tuple(n + 1 for n in before)


@pytest.mark.cuda
def test_ans_coder_kernel_refuses_zero_freq(cuda):
    """A template's prob-0 branch that first sees a 1 bit codes as in the
    plain version; one that first sees a 0 bit (freq 0) raises on the card
    as on the CPU, instead of writing an undecodable stream."""
    chip_smoke.check_ans_zero_freq(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_ans_reader_matches_plain(cuda, start):
    """v3 files of two requests, 3 lanes, decoded by the ANS reader in one
    launch and by the plain version on the same CUDA tensors."""
    packed = tpl = None
    if start == "template":
        packed, tpl = _template()
        tpl = tpl.to(cuda)
    pairs = [chip_smoke.small_lep(7, 96, 64, 90, 2, packed, version=3),
             chip_smoke.small_lep(8, 48, 32, 60, 1, packed, version=3)]
    plan = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                    for i, (_, lep) in enumerate(pairs)],
                                   coder="ans")
    inputs = plan.to(cuda)
    before = (vpx_decoder.decode_lanes.launches,
              vpx_decoder.decode_lanes.ans_launches)
    coef, err = vpx_decoder.decode_lanes(**inputs, template=tpl)
    assert (vpx_decoder.decode_lanes.launches,
            vpx_decoder.decode_lanes.ans_launches) == (before[0],
                                                       before[1] + 1)
    coef_p, err_p = vpx_decoder.decode_lanes_plain(**inputs, template=tpl)
    assert torch.equal(coef, coef_p) and torch.equal(err, err_p)
    assert not err.any()


def _reader_inputs(coder, packed, device, seed=7):
    """Two requests of different geometry (3 lanes) of container v1 (VPX
    reader) or v3 (rANS reader), as decode_lanes' inputs on `device`."""
    version = 3 if coder == "ans" else 1
    pairs = [chip_smoke.small_lep(seed, 96, 64, 90, 2, packed,
                                  version=version),
             chip_smoke.small_lep(seed + 1, 48, 32, 60, 1, packed,
                                  version=version)]
    plan = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                    for i, (_, lep) in enumerate(pairs)],
                                   coder)
    return plan.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_decoder_tiny_cache_matches_plain(cuda, coder, start, monkeypatch):
    """With the full branch cache no read falls through; with one of 8
    slots most branches live in the arena in device memory.  Both give the
    plain version's planes and err flags."""
    packed = tpl = None
    if start == "template":
        packed, tpl = _template()
        tpl = tpl.to(cuda)
    inputs = _reader_inputs(coder, packed, cuda)
    want = vpx_decoder.decode_lanes_plain(**inputs, template=tpl)
    got = vpx_decoder.decode_lanes(**inputs, template=tpl)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = vpx_decoder.decode_lanes.cache_counts.cpu()
    assert full[:, 0].min() > 8 and not full[:, 1].any()
    monkeypatch.setattr(vpx_decoder, "cache_slots", lambda: 8)
    got = vpx_decoder.decode_lanes(**inputs, template=tpl)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tiny = vpx_decoder.decode_lanes.cache_counts.cpu()
    assert (tiny[:, 0] <= 8).all() and (tiny[:, 1] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_decoder_err_flag_matches_plain(cuda, coder, monkeypatch):
    """Random bytes in place of the streams: lanes whose 7x7 count passes
    49 set their flag, and planes and flags equal the plain version's, with
    the full branch cache and with one of 8 slots."""
    inputs = _reader_inputs(coder, None, cuda, seed=11)
    data = inputs["data"]
    noise = np.random.default_rng(5).integers(
        0, 256, tuple(data.shape) + (data.element_size(),), dtype=np.uint8)
    inputs["data"] = torch.as_tensor(noise, device=cuda).view(
        data.dtype).reshape(data.shape)
    want = vpx_decoder.decode_lanes_plain(**inputs)
    assert want[1].any()
    for slots in (vpx_decoder.cache_slots(), 8):
        monkeypatch.setattr(vpx_decoder, "cache_slots", lambda: slots)
        got = vpx_decoder.decode_lanes(**inputs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_decoder_refuses_oversized_cache(cuda, monkeypatch):
    """A cache over the card's shared memory raises before any launch."""
    inputs = _reader_inputs("vpx", None, cuda)
    monkeypatch.setattr(vpx_decoder, "cache_slots", lambda: 1 << 15)
    before = vpx_decoder.decode_lanes.launches
    with pytest.raises(ValueError, match="shared memory"):
        vpx_decoder.decode_lanes(**inputs)
    assert vpx_decoder.decode_lanes.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("version", [2, 3])
def test_compress_device_versions_cuda_equals_cpu(cuda, version):
    data = chip_smoke.make_photo(5, 96, 64)
    lep = api.compress_device(data, num_segments=4, version=version)
    assert lep == api.compress_device(data, num_segments=4, device="cpu",
                                      version=version)
    assert lep[2] == version and api.decompress_device(lep) == data


@pytest.mark.cuda
@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("name,w,h,mode,kw,k,cut", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_versions_round_trip_geometries(cuda, name, w, h, mode, kw, k, cut,
                                        version):
    """v2 and v3 files of every geometry, made on the card, come back byte
    for byte through one launch of their reader."""
    data = _jpeg(w, h, len(name), mode, **kw)
    data = data[:int(len(data) * cut)]
    lep = chip_smoke.encode_in_segments(data, k, version=version)
    counter = "ans_launches" if version == 3 else "launches"
    before = getattr(vpx_decoder.decode_lanes, counter)
    assert api.decompress_device(lep) == data
    assert getattr(vpx_decoder.decode_lanes, counter) == before + 1


@pytest.mark.cuda
def test_cuda_path_never_runs_plain(cuda, monkeypatch):
    """Encode and decode of v1, v2 and v3 on the card with every plain
    version, and phase A's torch ops, made to raise: the CUDA path
    launches the kernels only."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")
    for mod, name in ((vpx_coder, "encode_streams_plain"),
                      (vpx_coder, "vpx_walk_plain"),
                      (ans_coder, "encode_streams_ans_plain"),
                      (ans_coder, "ans_walk_plain"),
                      (bp, "branch_probs_plain"),
                      (bp, "run_heads_plain"),
                      (bp, "walk_runs_plain"),
                      (bp, "arena_probs_plain"),
                      (symbolize, "symbol_counts_plain"),
                      (symbolize, "emit_symbols_plain"),
                      (symbolize, "symbol_runs_plain"),
                      (batch_encode, "symbol_runs_plain"),
                      (batch_encode, "emit_symbols_plain"),
                      (symbolize, "symbolize_slice"),
                      (symbolize, "phase_a"),
                      (contexts, "phase_a"),
                      (vpx_decoder, "decode_lanes_plain")):
        monkeypatch.setattr(mod, name, boom)
    data = chip_smoke.make_photo(6, 96, 64)
    leps = [api.compress_device(data, num_segments=2, version=v)
            for v in (1, 2, 3)]
    assert api.batch_decompress_device(leps) == [data] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["11-bit AC coefficients",
                                  "a value past 11 bits",
                                  "a past-cut size_limit",
                                  "segment-top rows",
                                  "wrap-inducing coefficients",
                                  "a dense plane"])
def test_symbol_kernels_match_plain(cuda, what):
    """symbol_counts and symbol_emit on the card, which compute phase A
    from the coefficients, equal their plain versions (phase A, then the
    slab) on the same CUDA planes (counts, flags, idx, bit), one launch of
    each; a flagged block's first symbol is COEF_OUT_OF_RANGE.  The planes
    have segment-top rows, a size-limit cut, values that wrap phase A's
    int32 and int16 arithmetic, and a dense plane whose tiles stage their
    symbols in rounds."""
    plane = chip_smoke.hostile_planes(cuda)[what]
    before = (symbolize.symbol_counts.launches,
              symbolize.emit_symbols.launches)
    counts, over = symbolize.symbol_counts(plane)
    pc, po = symbolize.symbol_counts_plain(plane)
    assert torch.equal(counts, pc) and torch.equal(over, po)
    assert over.any().item() == (what in ("a value past 11 bits",
                                          "wrap-inducing coefficients"))
    n = counts.reshape(-1).to(torch.int64)
    offsets = (torch.cumsum(n, 0) - n).reshape(counts.shape)
    idx, bit = symbolize.emit_symbols(plane, offsets, int(n.sum()))
    pi, pb = symbolize.emit_symbols_plain(plane, offsets, int(n.sum()))
    assert torch.equal(idx, pi) and torch.equal(bit, pb)
    assert (symbolize.symbol_counts.launches,
            symbolize.emit_symbols.launches) == (before[0] + 1,
                                                 before[1] + 1)
    first = offsets.reshape(-1)[over.reshape(-1)]
    assert (idx[first] == symbolize.COEF_OUT_OF_RANGE).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("RGB", 4), ("CMYK", 3)])
def test_symbolize_images_cuda_equals_cpu(cuda, mode, k):
    """symbolize_images on the card (the two kernels, two launches a
    plane) gives the symbols, row counts and offsets of its plain route
    on the CPU: a photo in k segments, and a 4-component one."""
    data = chip_smoke.make_photo(64, 160, 96, mode=mode)
    _, info, dec = api._parse(data, allow_four_colors=True)
    desc = api._describe(info, dec, api._plan(dec, k)[0])
    before = symbolize.emit_symbols.launches
    got = batch_encode.symbolize_images([desc], cuda)
    assert symbolize.emit_symbols.launches - before == len(desc["planes"])
    want = batch_encode.symbolize_images([desc], "cpu")
    assert chip_smoke.symbols_equal(got.to("cpu"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,K,shared", [
    ("rmw", 1, False), ("rmw", 8, False), ("rmw", 4, True), ("alu", 1, False),
    ("mixed", 1, False), ("mixed", 1, True)])
def test_roofline_probe_matches_plain(cuda, kind, K, shared):
    got = decode_roofline.probe(kind, 3000, K, shared, cuda)
    assert int(got) == decode_roofline.probe_plain(kind, 3000, K, shared)


def _scan_kind(kind: str) -> bytes:
    """Small JPEGs outside mode Z or three components: progressive,
    baseline with one scan a component, CMYK baseline and progressive."""
    if kind == "multi_scan":
        return chip_smoke.multi_scan_jpeg(chip_smoke.make_photo(13, 64, 48))
    return chip_smoke.make_photo(
        12, 64, 48, progressive=kind.endswith("progressive"),
        mode="CMYK" if kind.startswith("cmyk") else "RGB")


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 3])
@pytest.mark.parametrize("kind", ["progressive", "multi_scan", "cmyk",
                                  "cmyk_progressive"])
def test_mode_x_and_four_colors_cuda_equals_cpu(cuda, kind, version):
    """Encode bytes, the decoder's planes and the decoded JPEG are the same
    on cuda as on the CPU; the planes are the parse's and the JPEG the
    original."""
    data = _scan_kind(kind)
    kw = dict(num_segments=4, version=version, allow_progressive=True,
              allow_four_colors=True)
    lep = api.compress_device(data, **kw)
    assert lep == api.compress_device(data, device="cpu", **kw)
    assert chr(lep[3]) == ("Z" if kind == "cmyk" else "X")
    plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]],
                                   "ans" if version == 3 else "vpx")
    coef, err = vpx_decoder.decode_lanes(**plan.to(cuda))
    coef_p, err_p = vpx_decoder.decode_lanes(**plan.to("cpu"))
    assert torch.equal(coef.cpu(), coef_p) and not err.any() \
        and not err_p.any()
    _, _, dec = api._parse(data, True, True)
    planes, _ = vpx_decoder.split_planes(plan, coef_p.numpy(), err_p)[0]
    assert all(np.array_equal(a, b) for a, b in zip(planes, dec.planes))
    assert api.decompress_device(lep) == data \
        == api.decompress_device(lep, device="cpu")


@pytest.mark.cuda
def test_serve_wave_cuda_equals_cpu(cuda):
    """A small mixed wave through serve._process_tpu_batch answers on cuda
    what it answers on cpu: two JPEGs (one coder launch of each kernel,
    one launch of each symbol kernel a plane),
    a v1 and a v3 .lep (one launch of each reader), every host-route
    count 0, every JPEG reply verified; the parse runs in jailed
    children, as the -tpu server runs it."""
    from lepton_tpu_torch import cli, serve
    jpegs = [chip_smoke.make_photo(7 + k, 64 + 32 * k, 48) for k in range(2)]
    leps = [api.compress(jpegs[0], max_threads=2),
            api.compress(jpegs[1], max_threads=2, version=3)]
    cli._prepare_for_jail({})
    replies, waves = {}, {}
    for dev in ("cpu", "cuda"):
        reqs = [[None, False, d, b""] for d in jpegs + leps]
        waves[dev] = serve.new_wave()
        serve._process_tpu_batch(reqs, dict(device=dev, max_threads=8),
                                 waves[dev])
        replies[dev] = [r[3] for r in reqs]
    assert replies["cuda"] == replies["cpu"]
    assert replies["cuda"][2:] == jpegs
    assert [api.decompress(r) for r in replies["cuda"][:2]] == jpegs
    assert not any(waves["cuda"]["host"].values())
    assert waves["cuda"]["verified"] == 2
    assert waves["cuda"]["launches"] == dict(
        symbol_counts=6, symbol_emit=6, run_heads=1, walk_runs=1,
        vpx_walk=1, ans_walk=0, vpx_reader=1, ans_reader=1)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 3])
def test_mesh_decode_equals_unsplit(cuda, version):
    """A 4-segment file decoded over cuda x 2 (one reader launch a share,
    each on a thread and stream of its own): the merged planes and flags
    equal the unsplit launch's, and the JPEG comes back."""
    from lepton_tpu_torch.parallel import mesh as pmesh
    jpeg, lep = chip_smoke.small_lep(61, 96, 64, 85, 4, version=version)
    coder = "ans" if version == 3 else "vpx"
    plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]], coder)
    whole = vpx_decoder.decode_lanes(**plan.to(cuda))
    seg = pmesh.Mesh([cuda, cuda], ("seg",))
    dl = vpx_decoder.decode_lanes
    before = dl.launches + dl.ans_launches
    coef, err, ms = pmesh.decode_shares(plan, seg, None, cuda)
    assert dl.launches + dl.ans_launches - before == 2 and len(ms) == 2
    assert torch.equal(coef, whole[0]) and torch.equal(err, whole[1])
    assert api.decompress_device(lep, mesh=seg) == jpeg
    for n in (2, 3):        # 4 lanes over 3 devices: uneven shares
        assert pmesh.batch_decompress([lep], mesh=pmesh.Mesh(
            np.array([cuda] * n, dtype=object).reshape(1, n),
            ("data", "seg"))) == [jpeg]


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 3])
def test_segment_range_cuda_equals_cpu(cuda, version):
    """Segments 1..2 of a 4-segment image on the card: the streams of its
    plain version, and of the whole call's segments 1 and 2."""
    from lepton_tpu_torch.kernels import batch_encode
    _, info, dec = api._parse(chip_smoke.make_photo(62, 64, 64))
    desc = api._describe(info, dec, dec.handoffs[:1])
    desc["splits_y"] = [0, 2, 4, 6]
    got = {dev: batch_encode.encode_images_device(
        [desc], version, device=dev, segment_range=[(1, 3)])
        for dev in (cuda, "cpu")}
    assert got[cuda] == got["cpu"]
    whole = batch_encode.encode_images_device([desc], version, device=cuda)
    assert got[cuda] == [whole[0][1:3]]


@pytest.mark.cuda
def test_two_process_encode_on_one_card(cuda, tmp_path):
    """distributed_compress in two processes that share the card (each
    rank's coder kernels launched once on its 2 lanes, its symbol kernels
    once a plane of the whole image) writes the bytes
    of the one-process call, and they decode back."""
    from lepton_tpu_torch.parallel import multihost
    jpeg = chip_smoke.make_photo(63, 96, 64)
    world1 = multihost.distributed_compress(jpeg, num_segments=4)
    assert world1 == multihost.distributed_compress(jpeg, num_segments=4,
                                                    engine="host")
    ranks = chip_smoke.run_ranks(jpeg, 4, "default", str(tmp_path),
                                 timeout=300)
    for lep, st in ranks:
        assert lep == world1
        assert st["lanes"] == 2
        assert st["launches"] == dict(symbol_counts=3, symbol_emit=3,
                                      run_heads=1, walk_runs=1, vpx_walk=1)
    assert api.decompress_device(world1) == jpeg


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 3])
def test_native_symbolizer_cuda_equals_cpu(cuda, version):
    """compress_device(symbolizer="native"): symbols from the C library,
    one launch of each coder kernel on the card, the bytes of its cpu run
    and of the card's own symbolizer."""
    from lepton_tpu_torch.kernels import ans_coder
    jpeg = chip_smoke.make_photo(64, 96, 64)
    walk = ans_coder.ans_walk if version == 3 else vpx_coder.vpx_walk
    before = _counts(walk)
    got = api.compress_device(jpeg, num_segments=4, device=cuda,
                              version=version, symbolizer="native")
    assert tuple(b - a for a, b in zip(before, _counts(walk))) == (1, 1, 1)
    assert got == api.compress_device(jpeg, num_segments=4, device="cpu",
                                      version=version, symbolizer="native")
    assert got == api.compress_device(jpeg, num_segments=4, device=cuda,
                                      version=version)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 3])
def test_python_segment_codec_equals_card_coder(cuda, version):
    """The port's scalar encode_segment (codec/driver.py) writes the
    streams that the card's coder writes for the same segments."""
    from lepton_tpu_torch import host
    from lepton_tpu_torch.codec.driver import encode_segment
    from lepton_tpu_torch.kernels import batch_encode
    _, info, dec = api._parse(chip_smoke.make_photo(65, 64, 64))
    desc = api._describe(info, dec, dec.handoffs[:1])
    desc["splits_y"] = [0, 2, 4, 6]
    card = batch_encode.encode_images_device([desc], version,
                                             device=cuda)[0]
    mh, cs = host._truncation_geometry(info, dec)
    image = host._python_image(info, dec.planes, mh, cs)
    bounds = desc["splits_y"] + [info.cmpnfo[0].bcv]
    assert card == [encode_segment(image, bounds[i], bounds[i + 1], i == 3,
                                   ans=version == 3) for i in range(4)]


# ---------------------------------------------------------------------------
# The bounds-checked builds (csrc/checked.cuh, sanitize.py card): each runs
# in a subprocess, since a process loads one build of each library
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE6 = ((1, 64, 48), (2, 96, 64), (4, 96, 64))   # chip_smoke phase 6


def _checked(script: str):
    """The JSON object that `script` prints last, run with the checked
    builds (LEPTON_TORCH_CHECKED_KERNELS=1)."""
    env = dict(os.environ, **{cuda_build.CHECKED_ENV: "1"})
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_checked_negative_checks_raise(cuda):
    """Every negative check of sanitize.negative_checks (decoder plans
    whose out_block, ntab, rows or stream leave their buffers; a rANS lane
    past its row; a run head past the keys; symbol offsets past the
    output) raises KernelBoundsError at its own site, and a good plan
    decodes after them."""
    got = _checked("import json, torch\n"
                   "from lepton_tpu_torch import sanitize\n"
                   "print(json.dumps(sanitize.negative_checks("
                   "torch.device('cuda'))))")
    assert len(got) == 7
    for what, msg in got.items():
        assert "outside [0, " in msg and "lepton_tpu_torch/csrc/" in msg, \
            (what, msg)


@pytest.mark.cuda
@pytest.mark.parametrize("nseg,w,h", PHASE6)
def test_checked_equals_default(cuda, nseg, w, h):
    """The checked build's .lep files, planes and err flags equal the
    default build's on phase 6's JPEGs (v1 and v3, both directions)."""
    seed = chip_smoke.SEED + 20 + nseg
    got = _checked(
        "import json, torch\n"
        "import chip_smoke\n"
        "from lepton_tpu_torch import sanitize\n"
        f"blobs = [chip_smoke.make_photo({seed}, {w}, {h}, 85)]\n"
        "print(json.dumps(sanitize.main_batch(torch.device('cuda'), blobs, "
        f"runs=1, segments={nseg})))")
    want = sanitize.main_batch(cuda, [chip_smoke.make_photo(seed, w, h, 85)],
                               runs=1, segments=nseg)
    for v in ("v1", "v3"):
        got[v].pop("ms")
        want[v].pop("ms")
    assert got == want
