"""The port's spans (lepton_tpu_torch/util/timing.py) on the CPU: the
device entry points' stage spans under torch.profiler, their stats keys
without it, the torch-free import, the benchmark's readers of the new keys
and the trace reduction's handling of a span's device-timeline copy.
Inputs are tiny PIL-made JPEGs; device="cpu" runs the plain versions."""
import io
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from benchmark import spec, trace
from benchmark.calls import Request
from benchmark.run import Run
from lepton_tpu_torch import api
from lepton_tpu_torch.kernels import vpx_decoder
from lepton_tpu_torch.util import timing

# each span of the device paths and the span it lies in
PARENT = {
    "parse": "entry.encode", "parse.image": "parse",
    "parse.header": "parse.image", "parse.huffman": "parse.image",
    "parse.plan": "parse.image", "symbolize": "entry.encode",
    "symbolize.stage": "symbolize", "symbolize.count": "symbolize",
    "symbolize.read": "symbolize", "symbolize.emit": "symbolize",
    "coder.lanes": "entry.encode", "coder": "entry.encode",
    "coder.sort": "coder", "coder.probs": "coder", "coder.walk": "coder",
    "coder.finalize": "coder", "container": "entry.encode",
    "container.read": "entry.decode",
    "container.read.request": "container.read",
    "reader.plan": "entry.decode", "reader": "entry.decode",
    "reader.d2h": "entry.decode", "re-emit": "entry.decode",
    "re-emit.request": "re-emit", "re-emit.native": "re-emit.request",
}
ENCODE_KEYS = {"parse_s", "huffman_s", "parse_image_s", "parse_workers",
               "stage_s", "stage_bytes", "symbolize_s", "assemble_s",
               "coder_ms", "finalize_s", "mux_s"}
DECODE_KEYS = {"read_s", "plan_s", "decoder_ms", "d2h_s", "d2h_bytes",
               "recode_s", "recode_native_s"}


def _jpeg(w: int, h: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ch = np.clip((xx * 255 / w + yy * 255 / h) / 2
                 + rng.normal(0, 24, size=(h, w)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)],
                             axis=-1), "RGB").save(buf, "JPEG", quality=85)
    return buf.getvalue()


BLOBS = [_jpeg(32, 16, 1), _jpeg(16, 32, 2)]


def _round_trip():
    """A 2-image batch encode and a 2-request batch decode on the CPU:
    (encode stats, decode stats)."""
    enc, dec = {}, {}
    leps = api.batch_compress_device(BLOBS, 2, "cpu", enc)
    assert api.batch_decompress_device(leps, "cpu", dec) == BLOBS
    return enc, dec


class _Recorder:
    """record_function in the span's place: the real range, and its
    (name, args, thread) in order of entry."""

    def __init__(self):
        self.real = torch.autograd.profiler.record_function
        self.entered = []

    def __call__(self, name, args=None):
        self.entered.append((name, args, threading.get_ident()))
        return self.real(name, args)


def _args(text):
    return dict(kv.split("=") for kv in (text or "").split())


def _by_thread(rows):
    """The names of (thread, name) rows, a list a thread, sorted."""
    out = {}
    for thread, name in rows:
        out.setdefault(thread, []).append(name)
    return sorted(out.values())


def test_spans_under_the_profiler(monkeypatch):
    """Every span of the tentpole is recorded on the profiler's timeline
    as lepton:<name>, on the thread that opened it, inside its parent
    among that thread's spans; a parse.image that a pool thread opened
    (the parse's pool route) lies inside the calling thread's parse.  All
    spans of a call carry its call id, and each image has its own
    parse.image and re-emit.request with its image= argument."""
    rec = _Recorder()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rec)
    # the profiler records a thread it was not started on only when asked
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        enc, _ = _round_trip()
    events = sorted(
        [(e.start_ns(), -e.end_ns(), e.name()[len(timing.PREFIX):],
          e.start_thread_id())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith(timing.PREFIX)])
    names = [n for _, _, n, _ in events]
    # each thread's spans in the order that thread entered them
    assert _by_thread([(t, n) for _, _, n, t in events]) == _by_thread(
        [(t, n[len(timing.PREFIX):]) for n, _, t in rec.entered])
    assert set(names) == set(PARENT) | {"entry.encode", "entry.decode"}
    caller = {t for _, _, n, t in events if n == "entry.encode"}
    parse = [(s, -e) for s, e, n, t in events if n == "parse"]
    assert len(caller) == 1 and len(parse) == 1
    for k, (s, neg_e, name, thread) in enumerate(events):
        if name.startswith("entry."):
            continue
        # the innermost span of its thread open at this one's start is its
        # parent
        up = [n2 for s2, e2, n2, t2 in events[:k]
              if t2 == thread and s2 <= s and -e2 >= -neg_e]
        if name == "parse.image":
            assert parse[0][0] <= s and -neg_e <= parse[0][1]
            # on a pool thread it has no parent of its own thread
            on_pool = enc["parse_workers"] > 1
            assert (thread in caller) != on_pool
            assert up[-1:] == ([] if on_pool else ["parse"])
        else:
            assert up and up[-1] == PARENT[name], name
    entered = [(n[len(timing.PREFIX):], _args(a)) for n, a, _ in rec.entered]
    calls = {}
    for name, a in entered:
        calls.setdefault(a["call"], set()).add(name)
    assert len(calls) == 2
    enc_id, dec_id = sorted(calls, key=int)
    assert "entry.encode" in calls[enc_id] and "re-emit" not in \
        calls[enc_id]
    assert "entry.decode" in calls[dec_id] and "parse" not in calls[dec_id]
    assert sorted(a.get("image") for n, a in entered
                  if n == "parse.image") == ["0", "1"]
    for span in ("re-emit.request", "container.read.request"):
        assert [a.get("image") for n, a in entered if n == span] == \
            ["0", "1"]


def test_spans_without_the_profiler(monkeypatch):
    """With no profiler no record_function is entered; the stats hold
    every key, the native shares lie within their stage and d2h_bytes is
    the bytes of the planes and flags the reader gave."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got = []
    decode_lanes = vpx_decoder.decode_lanes

    def spy(**kw):
        coef, err = decode_lanes(**kw)
        got.append(coef.numel() * coef.element_size()
                   + err.numel() * err.element_size())
        return coef, err

    monkeypatch.setattr(vpx_decoder, "decode_lanes", spy)
    enc, dec = _round_trip()
    assert ENCODE_KEYS <= set(enc) and DECODE_KEYS <= set(dec)
    # the native decodes lie in their images' spans, and those in the
    # parse's wall on each of its threads
    assert 0 < enc["huffman_s"] <= enc["parse_image_s"] \
        <= enc["parse_s"] * enc["parse_workers"]
    assert 0 < dec["recode_native_s"] <= dec["recode_s"]
    assert enc["stage_bytes"] == sum(
        sum(p.size * 2 + p.shape[0] for p in api._parse(b)[2].planes)
        for b in BLOBS)
    assert dec["d2h_bytes"] == sum(got) > 0


def test_host_codec_spans_write_no_stats():
    """The host codec runs the same parse and re-emit with no call open:
    its spans and counters write nothing; inside a call they write to its
    stats, and each call has its own id."""
    lep = api.compress(BLOBS[0])
    assert api.decompress(lep) == BLOBS[0]
    with timing.span("x", "x_s"):
        timing.add("x_bytes", 3)
    st = {}
    with timing.call(st, "encode") as c:
        with timing.span("x", "x_s"):
            timing.add("x_bytes", 3)
    assert set(st) == {"x_s", "x_bytes"} and st["x_bytes"] == 3
    with timing.call({}, "decode") as d:
        pass
    assert d.id > c.id > 0


def test_timing_loads_no_torch():
    """util/timing.py imports no torch: the host path loads none."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, lepton_tpu_torch.util.timing, lepton_tpu_torch.host\n"
         "print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=120, check=True,
        cwd=spec.ROOT)
    assert out.stdout.strip() == "False"


def _run(stats_by_label):
    """A hand-built benchmark Run: images of 1 and 0.5 MB, one request a
    (label, stats)."""
    images = [b"x" * 1_000_000, b"y" * 500_000]
    reqs = [Request(label, "jpeg", [0, 1], 0.0, 1.0, stats=st)
            for label, st in stats_by_label]
    return Run(reqs, 10.0, 1.0, None, images, [])


@pytest.mark.parametrize("name, label, stats, want", [
    ("parse_python_ms_per_mb.encode", "encode",
     {"parse_s": 0.9, "huffman_s": 0.3}, 400.0),
    ("stage_ms_per_mb.encode", "encode", {"stage_s": 0.03}, 20.0),
    ("assemble_ms_per_mb.encode", "encode", {"assemble_s": 0.15}, 100.0),
    ("reemit_python_ms_per_mb.decode", "decode",
     {"recode_s": 0.3, "recode_native_s": 0.15}, 100.0),
    ("d2h_gbps.decode", "decode", {"d2h_bytes": 6e8, "d2h_s": 0.2}, 3.0),
])
def test_metric_readers(name, label, stats, want):
    """The five readers of the program's spans on a hand-built Run; None
    when a key they need is missing."""
    read = spec.metric_reader(name)
    assert read(_run([(label, stats), (label, stats)])) == \
        pytest.approx(want)
    for key in stats:
        part = {k: v for k, v in stats.items() if k != key}
        assert read(_run([(label, part)])) is None
    other = "decode" if label == "encode" else "encode"
    assert read(_run([(other, stats)])) is None


def test_reduce_skips_span_copies_on_the_device():
    """trace.reduce counts a device-timeline copy of a lepton: span (a
    user annotation) as no device time, and no device operation."""
    events = [(0.0, 100.0, "bench:parse", False, True),
              (0.0, 100.0, "lepton:parse", False, True),
              (10.0, 90.0, "lepton:parse", True, True),
              (40.0, 50.0, "kernel", True, False)]
    out = trace.reduce(events, 1e-4)
    assert out["busy_s"] == pytest.approx(10e-6)
    assert out["device_ops"] == [["kernel", pytest.approx(10e-6)]]
    assert dict(out["idle_gaps"]) == {"parse": pytest.approx(90e-6)}
