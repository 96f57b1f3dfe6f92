"""The benchmark's frozen copies against their originals, at small sizes,
and the roofline counts on hand-worked cases."""
from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark import fixtures, roofline, trace
from benchmark.check import container_problem, lanes_of
from benchmark.reference import encode as ref


def test_make_photo_equals_original():
    from lepton_tpu_torch import bench
    for seed in (0, 20240601):
        assert fixtures.make_photo(seed, 96, 64) == bench.make_photo(
            seed, 96, 64)
    assert fixtures.make_photo(3, 64, 48, quality=80) == bench.make_photo(
        3, 64, 48, quality=80)


def test_images_follow_the_seed():
    config = {"images": {"generator": "phone_photo", "width": 48,
                         "height": 32, "quality": 90}}
    a = fixtures.images(config, 2**31 + 11, 3)
    assert a == fixtures.images(config, 2**31 + 11, 3)
    assert a != fixtures.images(config, 2**31 + 12, 3)
    assert len(set(a)) == 3


@pytest.mark.parametrize("make", [
    lambda: fixtures.make_photo(11, 256, 192),
    lambda: fixtures.make_photo(13, 128, 96, quality=92),
    lambda: fixtures.make_photo(12, 40, 24),
])
def test_reference_equals_host_codec(make):
    """The reference's .lep is the port's host.compress (C segment coder)
    and its Python route, byte for byte; the control's is not."""
    from lepton_tpu_torch import host
    jpeg = make()
    want = host.compress(jpeg, max_threads=16)
    assert ref.expected_lep(jpeg, 16) == want
    assert ref.expected_lep(jpeg, 16, ref.SEVEN_BITS) != want
    assert container_problem(want, jpeg, 16) == ""
    assert container_problem(want, jpeg + b"x", 16) != ""
    assert container_problem(want[:40], jpeg, 16) != ""


@pytest.mark.parametrize("make", [
    lambda: fixtures.make_photo(21, 256, 192),
    lambda: fixtures.make_photo(22, 128, 96, quality=92),
    lambda: fixtures.make_photo(23, 40, 24),
])
def test_reference_equals_jax_package(make):
    """The reference's .lep is the JAX package's (lepton_tpu.api.compress),
    byte for byte: the reference is held to the system the port was made
    from, not to the port alone."""
    from lepton_tpu import api as jax_package
    jpeg = make()
    assert ref.expected_lep(jpeg, 16) == jax_package.compress(
        jpeg, max_threads=16)


def _progressive(seed: int, cut: bool = False) -> bytes:
    """A small progressive photo (libjpeg's simple progression, 10 scans);
    cut: its last third left out, an early-EOF file."""
    jpeg = fixtures.make_photo(seed, 256, 192, progressive=True)
    return jpeg[:len(jpeg) * 2 // 3] if cut else jpeg


PROGRESSIVE = [(31, False), (32, False), (2**31 + 33, False), (34, True)]


@pytest.mark.parametrize("seed,cut", PROGRESSIVE)
def test_progressive_decode_equals_port(seed, cut):
    """The reference's scan decode of a progressive photo is the port's
    Python loops' (decode_scans(use_native=False)): the planes, every
    handoff crystallized in the DC scans, and the early-EOF fields."""
    from lepton_tpu_torch.jpeg import decoder as port_decoder
    from lepton_tpu_torch.jpeg import imageinfo as port_info
    from lepton_tpu_torch.jpeg import parser as port_parser
    from benchmark.reference.jpeg import decoder, imageinfo, parser
    jpeg = _progressive(seed, cut)
    parsed = parser.parse_jpeg(jpeg)
    ours = decoder.decode_scans(
        parsed, imageinfo.image_info_from_header(parsed.hdrdata),
        allow_progressive=True)
    parsed = port_parser.parse_jpeg(jpeg)
    theirs = port_decoder.decode_scans(
        parsed, port_info.image_info_from_header(parsed.hdrdata),
        allow_progressive=True, use_native=False)
    assert not ours.is_baseline and not theirs.is_baseline
    assert ours.early_eof == theirs.early_eof == cut
    assert len(ours.planes) == len(theirs.planes) == 3
    for a, b in zip(ours.planes, theirs.planes):
        assert np.array_equal(a, b)
    assert len(ours.handoffs) > 2
    assert [vars(h) for h in ours.handoffs] == [
        vars(h) for h in theirs.handoffs]
    for key in ("padbit", "max_cmp", "max_bpos", "max_sah", "max_dpos"):
        assert getattr(ours, key) == getattr(theirs, key), key


@pytest.mark.parametrize("seed,cut", PROGRESSIVE)
def test_progressive_reference_equals_host_codec_and_jax_package(seed, cut):
    """The reference's mode-X .lep of a progressive photo is the port's
    host.compress and the JAX package's compress with allow_progressive,
    byte for byte; without allow_progressive the reference refuses the
    file, as they do."""
    from lepton_tpu import api as jax_package
    from lepton_tpu_torch import host
    from benchmark.reference.jpeg.imageinfo import UnsupportedJpeg
    jpeg = _progressive(seed, cut)
    want = host.compress(jpeg, max_threads=16, allow_progressive=True)
    assert ref.expected_lep(jpeg, 16, allow_progressive=True) == want
    assert jax_package.compress(jpeg, max_threads=16,
                                allow_progressive=True) == want
    with pytest.raises(UnsupportedJpeg):
        ref.analyse(jpeg, 16)


@pytest.mark.parametrize("seed", [41, 42, 2**31 + 43])
def test_container_problem_follows_the_jpeg(seed):
    """A .lep must have the mode its JPEG calls for: a progressive photo's
    and a multi-scan baseline photo's pass as mode X and are refused once
    their header says mode Z; a baseline photo's passes as mode Z and is
    refused once it says mode X.  A mode-X .lep with its header segments
    altered, or held to another JPEG, is refused."""
    from chip_smoke import multi_scan_jpeg
    from lepton_tpu_torch import host
    from benchmark.check import header_segments, jpeg_mode
    from benchmark.reference.container.format import (read_container,
                                                      write_container)

    def with_mode(lep, mode):
        hdr, mux = read_container(lep)
        hdr.mode = ord(mode)
        return write_container(hdr, mux)

    prog = _progressive(seed)
    base = fixtures.make_photo(seed, 256, 192)
    multi = multi_scan_jpeg(base)
    for jpeg, mode, wrong in ((prog, "X", "Z"), (base, "Z", "X"),
                              (multi, "X", "Z")):
        assert jpeg_mode(jpeg) == mode
        lep = host.compress(jpeg, max_threads=16, allow_progressive=True)
        assert read_container(lep)[0].mode == ord(mode)
        assert container_problem(lep, jpeg, 16) == ""
        assert container_problem(with_mode(lep, mode), jpeg, 16) == ""
        assert container_problem(with_mode(lep, wrong), jpeg, 16) != ""
        assert container_problem(lep, jpeg, 16, 2) != ""
    # the stored header segments are the JPEG's with its 10 scans cut out
    prog_lep = host.compress(prog, max_threads=16, allow_progressive=True)
    hdr, mux = read_container(prog_lep)
    assert hdr.hdrdata == header_segments(prog)
    assert hdr.hdrdata.count(b"\xff\xda") == 10
    assert not prog[2:].startswith(hdr.hdrdata)
    assert base[2:].startswith(header_segments(base))
    hdr.hdrdata = hdr.hdrdata[:-1] + bytes([hdr.hdrdata[-1] ^ 1])
    assert container_problem(write_container(hdr, mux), prog,
                             16) == "header segments differ from the JPEG's"
    other = _progressive(seed + 1)
    assert container_problem(prog_lep, other, 16) != ""


def test_sampled_segments_judge_each_lane():
    """The .lep the check expects has the reference's header and sampled
    segments and the output's other segments: an output with one of the
    sampled segments altered differs from it; one with an unsampled
    segment altered is held only to its container.  (Stand-in streams:
    the comparison does not read them.)"""
    from benchmark.check import expected_lep, lanes_of, pick_lanes
    noise = np.random.default_rng(5).integers(0, 256, (512, 512, 3),
                                              dtype=np.uint8)
    a = ref.analyse(fixtures._jpeg(noise, "RGB", 95), 16)
    n = len(a["jobs"])
    assert n == 4          # over 250 KB of scan: 4 segments
    picked = pick_lanes(n, 2, 2**31 + 1, 0)
    assert picked == pick_lanes(n, 2, 2**31 + 1, 0) and len(picked) == 2
    assert len({tuple(pick_lanes(n, 2, s, 0)) for s in range(20)}) > 1
    streams = [bytes([k + 1]) * (300 + 50 * k) for k in range(n)]
    coded = {(k, ref.FULL_PRECISION): streams[k] for k in picked}
    whole = ref.assemble(a, streams)
    assert lanes_of(whole) == streams
    assert expected_lep(a, coded, whole) == whole
    for k in (picked[0], next(k for k in range(n) if k not in picked)):
        altered = list(streams)
        altered[k] = altered[k][:-1] + b"\0"
        out = ref.assemble(a, altered)
        assert (expected_lep(a, coded, out) != out) == (k in picked)
    assert expected_lep(a, coded, whole[:60]) is None


def test_roofline_counts_by_hand():
    assert roofline.coder_bytes(10, 7, 2) == 10 * 5 + 7 + 2 * 4
    assert roofline.reader_bytes(100, 3) == 100 + 3 * 128
    assert roofline.least_ms(3.35e9) == pytest.approx(1.0)
    # 48x32 4:2:0: 3 x 2 MCUs of 4 luma and 2 chroma blocks
    assert roofline.jpeg_blocks(fixtures.make_photo(1, 48, 32)) == 36
    # 4032x3024: 504 x 378 luma, twice 252 x 189 chroma (PERF.md: the
    # main batch's 4 photos hold 1,143,072 blocks)
    assert roofline.jpeg_blocks(_header_only(4032, 3024)) == 1143072 // 4
    # the copy's count of a coder's bytes is chip_smoke.py's (:2666) with
    # the stream bytes in place of the .lep bytes
    symbols, lanes = 1000, 16
    lep = ref.expected_lep(fixtures.make_photo(2, 64, 48), 16)
    streams = sum(map(len, lanes_of(lep)))
    assert streams < len(lep)
    assert roofline.coder_bytes(symbols, streams, lanes) == (
        symbols * 5 + streams + 4 * lanes)


def _header_only(w: int, h: int) -> bytes:
    """SOI and a baseline frame header of three components, 4:2:0."""
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes(
        [3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    return b"\xff\xd8\xff\xc0" + (len(sof) + 2).to_bytes(2, "big") + sof


def _event(start, end, name, cuda):
    from torch.autograd import DeviceType
    rng = types.SimpleNamespace(start=start, end=end,
                                elapsed_us=lambda: end - start)
    return types.SimpleNamespace(
        time_range=rng, name=name,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


EVENTS = [(0, 100, "bench:entry.encode", False),
          (5, 60, "bench:parse", False),
          (62, 95, "bench:coder", False),
          (10, 20, "k1", True), (15, 30, "k2", True), (70, 90, "k3", True),
          (92, 93, "k1", True)]


def test_busy_share_equals_trace_device(monkeypatch):
    """trace.reduce's busy seconds are chip_smoke.trace_device's on the
    same events (a fake profiler), and its idle gaps are named by the
    innermost host span."""
    import chip_smoke
    import torch.profiler
    events = [_event(*e) for e in EVENTS]

    class Fake:
        def __init__(self, *a, **k):
            pass

        def start(self):
            pass

        def stop(self):
            pass

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    line = chip_smoke.trace_device(lambda: None)
    out = trace.reduce([(a, b, n, cuda, False) for a, b, n, cuda in EVENTS],
                       1.0)
    # union of [10, 30], [70, 90], [92, 93] us
    assert out["busy_s"] == pytest.approx(41e-6)
    assert f"device busy {41 / 1e3:.2f} of {100 / 1e3:.2f} ms" in line
    gaps = dict(out["idle_gaps"])
    # [0, 10]: 5 us in the entry span, 5 in parse; [30, 70]: 30 in parse,
    # 2 in entry, 8 in coder; [90, 92]: coder; [93, 100]: 2 coder, 5 entry
    assert gaps["parse"] == pytest.approx(35e-6)
    assert gaps["coder"] == pytest.approx(12e-6)
    assert gaps["entry.encode"] == pytest.approx(12e-6)
    assert dict(out["device_ops"])["k1"] == pytest.approx(11e-6)


def test_flatten_tiles_the_window():
    pieces = trace._flatten([(0, 10, "a"), (2, 4, "b"), (5, 6, "c")], 0, 12)
    assert pieces == [(0, 2, "a"), (2, 4, "b"), (4, 5, "a"), (5, 6, "c"),
                      (6, 10, "a"), (10, 12, trace.OUTSIDE)]
    assert np.isclose(sum(b - a for a, b, _ in pieces), 12)
