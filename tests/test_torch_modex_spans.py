"""The spans and counters of the mode-X re-emit on the CPU: a batch decode
of small progressive photos (libjpeg's simple progression, 10 scans, as
PIL writes it) counts the regenerated scans' entropy-coded bytes exactly
against the JPEG's own scans and labels each scan's span with its number
and kind under -timing=; a baseline photo gets no scan counter.  The
readers of these keys in the benchmark, on hand-built runs.
device="cpu" runs the plain versions."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check, spec
from benchmark.calls import Request
from benchmark.fixtures import make_photo
from benchmark.reference.encode import expected_lep
from benchmark.run import Run
from lepton_tpu_torch import api
from lepton_tpu_torch.jpeg import recode_progressive
from lepton_tpu_torch.util import pool, timing

SIZES = ((48, 32), (40, 48), (56, 24))
PHOTOS = [make_photo([20, k], w, h, progressive=True)
          for k, (w, h) in enumerate(SIZES)]
SEGMENTS = 2


def _scans(jpeg: bytes):
    """(kind, entropy-coded bytes with the stuffing taken out) of each scan
    of a JPEG, its bytes cut out as check.header_segments cuts them, its
    kind read from its SOS header and the frame's marker."""
    frame, out, pos, sos = None, [], 2, None
    for marker, seg in check._segments(jpeg):
        start = jpeg.index(seg, pos)
        if sos is not None:
            out.append((sos, jpeg[pos:start]))
            sos = None
        pos = start + len(seg)
        if frame is None and 0xC0 <= marker <= 0xC2:
            frame = marker
        if marker == 0xDA:
            ns = seg[4]
            ss, ah = seg[5 + 2 * ns], seg[7 + 2 * ns] >> 4
            sos = ("sequential" if frame != 0xC2 else
                   ("dc" if ss == 0 else "ac")
                   + ("_refine" if ah else "_first"))
    out.append((sos, jpeg[pos:jpeg.rindex(b"\xff\xd9")]))
    return [(kind, data.replace(b"\xff\x00", b"\xff"))
            for kind, data in out]


class _Recorder:
    """record_function in the span's place: the real range, and its
    (name, args) in order of entry."""

    def __init__(self):
        self.real = torch.autograd.profiler.record_function
        self.entered = []

    def __call__(self, name, args=None):
        self.entered.append((name, args))
        return self.real(name, args)


def _labels(events, name):
    """The args of each -timing= span NAME that carries them, in order of
    its begin marks."""
    return [e[len(name) + 1:-len("_BEGIN")] for e in events
            if e.startswith(name + " ") and e.endswith("_BEGIN")]


def _want(photos):
    return [f"scan={n} kind={kind}" for j in photos
            for n, (kind, _) in enumerate(_scans(j))]


@pytest.fixture(scope="module")
def leps():
    """The photos' .lep, and the -timing= marks of their encode."""
    timing.reset()
    timing.enable(True)
    try:
        out = api.batch_compress_device(PHOTOS, SEGMENTS, "cpu",
                                        allow_progressive=True)
        events = [name for name, _ in timing._events]
    finally:
        timing.enable(False)
        timing.reset()
    return out, events


def test_photos_have_the_simple_progression():
    kinds = ["dc_first"] + ["ac_first"] * 4 + ["ac_refine", "dc_refine"] \
        + ["ac_refine"] * 3
    for jpeg in PHOTOS:
        assert [k for k, _ in _scans(jpeg)] == kinds


def test_encode_labels_the_progressive_parse(leps):
    """The .lep bytes are the reference's, and each native progressive
    scan decode's parse.huffman span carries its scan's number and kind
    (the images parse on pool threads, so in any order of images)."""
    out, events = leps
    assert out == [expected_lep(j, SEGMENTS, allow_progressive=True)
                   for j in PHOTOS]
    assert sorted(_labels(events, "parse.huffman")) == sorted(_want(PHOTOS))


@pytest.mark.parametrize("workers", [1, 3])
def test_modex_decode_counts_and_labels_scans(leps, monkeypatch, workers):
    """Every original back; recode_scan_bytes is the JPEGs' unstuffed scan
    bytes; each scan is a lepton:re-emit.native range and, under -timing=,
    a re-emit.native span that carries its number and kind; the native
    scan coding lies inside the re-emit's wall.  On one worker the
    requests re-emit in order on the calling thread; on three they
    re-emit at once on the host pool (api._reemit_modex), so their scans'
    labels come in any order of requests and the native seconds, summed
    over the threads, lie within the wall on each thread."""
    monkeypatch.setattr(pool, "_MAX_WORKERS", workers)
    rec = _Recorder()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rec)
    monkeypatch.setattr(timing, "_enabled", True)
    timing.reset()
    dec = {}
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = api.batch_decompress_device(leps[0], "cpu", dec)
        events = [name for name, _ in timing._events]
    finally:
        timing.reset()
    assert got == PHOTOS
    scans = [s for j in PHOTOS for s in _scans(j)]
    assert len(scans) == 30
    assert dec["recode_scan_bytes"] == sum(len(d) for _, d in scans)
    assert dec["reemit_workers"] == workers
    if workers == 1:
        assert _labels(events, "re-emit.native") == _want(PHOTOS)
    else:
        assert sorted(_labels(events, "re-emit.native")) == \
            sorted(_want(PHOTOS))
    ranges = [args for name, args in rec.entered
              if name == timing.PREFIX + "re-emit.native"]
    assert len(ranges) == len(scans)
    assert all("scan=" not in (args or "") for args in ranges)
    assert 0 < dec["recode_native_s"] <= dec["recode_s"] * workers


def test_python_scan_loop_counts_alike(leps, monkeypatch):
    """With no native library for the re-emit, the Python loop's scans
    are counted alike and labelled as re-emit.python spans."""
    rec = _Recorder()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rec)
    monkeypatch.setattr(recode_progressive, "_native_available",
                        lambda: False)
    monkeypatch.setattr(timing, "_enabled", True)
    timing.reset()
    dec = {}
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert api.batch_decompress_device(leps[0][:1], "cpu", dec) \
                == PHOTOS[:1]
        events = [name for name, _ in timing._events]
    finally:
        timing.reset()
    scans = _scans(PHOTOS[0])
    assert dec["recode_scan_bytes"] == sum(len(d) for _, d in scans)
    assert "recode_native_s" not in dec
    assert _labels(events, "re-emit.python") == _want(PHOTOS[:1])
    assert [name for name, _ in rec.entered
            if name == timing.PREFIX + "re-emit.python"] == \
        [timing.PREFIX + "re-emit.python"] * len(scans)


def test_baseline_photo_gets_no_scan_counters():
    jpeg = make_photo([21, 0], 48, 32)
    dec = {}
    lep = api.batch_compress_device([jpeg], SEGMENTS, "cpu")
    assert api.batch_decompress_device(lep, "cpu", dec) == [jpeg]
    assert "recode_scan_bytes" not in dec
    assert 0 < dec["recode_native_s"] <= dec["recode_s"]


def _run(stats_list, trace=None):
    """A hand-built benchmark Run: one image of 2 MB, a decode request a
    stats dict."""
    reqs = [Request("decode", "jpeg", [0], 0.0, 1.0, stats=st)
            for st in stats_list]
    return Run(reqs, 10.0, 1.0, trace, [b"x" * 2_000_000], [])


@pytest.mark.parametrize("name, stats, want", [
    ("reemit_scan_mbps.decode_x",
     {"recode_scan_bytes": 1.5e6, "recode_native_s": 0.25}, 6.0),
    # one thread: the native calls fill most of the re-emit's wall
    ("reemit_concurrency.decode_x",
     {"recode_native_s": 0.27, "recode_s": 0.3}, 0.9),
    # four at once: their native seconds sum past the wall
    ("reemit_concurrency.decode_x",
     {"recode_native_s": 1.08, "recode_s": 0.3}, 3.6),
])
def test_modex_metric_readers(name, stats, want):
    """Each reader on two requests; None where a key it needs is missing
    (the parent's program has no scan counter) or no decode ran."""
    read = spec.metric_reader(name)
    assert read(_run([stats, stats])) == pytest.approx(want)
    for key in stats:
        assert read(_run([{k: v for k, v in stats.items()
                           if k != key}])) is None
    assert read(_run([])) is None


def test_modex_idle_reader():
    """The idle share the progressive cell reports with the baseline
    decode cell: None without a trace."""
    read = spec.metric_reader("device_idle_pct.decode")
    assert read(_run([{}], {"busy_s": 7.5, "window_s": 50.0})) == \
        pytest.approx(85.0)
    assert read(_run([{}])) is None
