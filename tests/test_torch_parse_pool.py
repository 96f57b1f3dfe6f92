"""The batch encode's parse on the host pool (api._parse_images): the
concurrent route against the pool's one-worker case (pool._MAX_WORKERS =
1), which is that of a one-image batch, a one-CPU host and a jailed
parse; the error of the first failing image; the stats of a call carried
onto pool threads (timing.in_call).  Inputs are PIL-made JPEGs;
device="cpu" runs the plain versions."""
import io
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from lepton_tpu_torch import api, host
from lepton_tpu_torch.util import pool, timing


def _jpeg(w: int, h: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ch = np.clip((xx * 255 / w + yy * 255 / h) / 2
                 + rng.normal(0, 24, size=(h, w)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)],
                             axis=-1), "RGB").save(buf, "JPEG", quality=85)
    return buf.getvalue()


BLOBS = [_jpeg(32, 16, 1), _jpeg(16, 32, 2), _jpeg(24, 24, 3),
         _jpeg(40, 16, 4)]


def _encode(monkeypatch, workers, blobs, **kw):
    """(.lep bytes, stats) of one batch encode with the pool's size set."""
    monkeypatch.setattr(pool, "_MAX_WORKERS", workers)
    stats = {}
    return api.batch_compress_device(blobs, 2, "cpu", stats, **kw), stats


def test_pool_writes_the_serial_routes_bytes(monkeypatch):
    """A batch of 4 parsed on 4 threads gives the .lep bytes of the serial
    route, image by image; parse_workers names the route, and the native
    decodes and the per-image spans are summed over images."""
    serial, st1 = _encode(monkeypatch, 1, BLOBS)
    pooled, st4 = _encode(monkeypatch, 4, BLOBS)
    assert pooled == serial
    assert st1["parse_workers"] == 1 and st4["parse_workers"] == 4
    for st in (st1, st4):
        assert 0 < st["huffman_s"] <= st["parse_image_s"]
        assert st["parse_image_s"] <= st["parse_s"] * st["parse_workers"]


@pytest.mark.parametrize("batch, kw", [
    (BLOBS[:1], {}),
    (BLOBS[:2], {"jailed_parse": True}),
], ids=["one_image", "jailed"])
def test_serial_routes(monkeypatch, batch, kw):
    """A one-image batch and a jailed parse run on the calling thread
    alone, with a pool of 4 at hand; the bytes are the serial route's."""
    got, st = _encode(monkeypatch, 4, batch, **kw)
    assert st["parse_workers"] == 1
    assert got == _encode(monkeypatch, 1, batch)[0]


def _bad_bytes(blobs):
    """Image 1 cut inside its header, image 3 no JPEG: two messages."""
    return blobs[:1] + [blobs[1][:60], blobs[2], b"not a jpeg"], None


def _bad_parse(blobs):
    """A parse that raises an error no request names for images 1 and 3."""
    real = api._parse

    def parse(data, *a):
        i = blobs.index(data)
        if i in (1, 3):
            raise RuntimeError(f"image {i} broke")
        return real(data, *a)
    return blobs, parse


@pytest.mark.parametrize("make", [_bad_bytes, _bad_parse],
                         ids=["bytes", "non_request_error"])
@pytest.mark.parametrize("workers", [1, 4])
def test_first_failing_image_raises(monkeypatch, make, workers):
    """With images 1 and 3 bad, both routes raise request 1's error: one of
    REQUEST_ERRORS, of the type and message the serial loop gives."""
    blobs, parse = make(list(BLOBS))
    if parse is not None:
        monkeypatch.setattr(api, "_parse", parse)
    try:
        api._parse(blobs[1])
    except Exception as e:
        want = host.request_error(1, e)
    with pytest.raises(host.REQUEST_ERRORS) as got:
        _encode(monkeypatch, workers, blobs)
    assert type(got.value) is type(want)
    assert str(got.value) == str(want)


def test_pool_parse_overlaps_its_images(monkeypatch):
    """Four 512x384 photos on four threads: each image's spans land in the
    call's stats once (parse_image_s holds its huffman_s), and the summed
    image seconds are at least the parse's wall over the threads."""
    blobs = [_jpeg(512, 384, s) for s in range(4)]
    monkeypatch.setattr(pool, "_MAX_WORKERS", 4)
    st = {}
    with timing.call(st, "encode"):
        with timing.span("parse", "parse_s"):
            metas, descs = api._parse_images(blobs, [16] * 4, False, False,
                                             False)
    assert [m[0].jpgfilesize for m in metas] == [len(b) for b in blobs]
    assert len(descs) == 4 and st["parse_workers"] == 4
    assert 0 < st["huffman_s"] <= st["parse_image_s"]
    assert st["parse_s"] / st["parse_workers"] <= st["parse_image_s"] \
        <= st["parse_s"] * st["parse_workers"]


def test_in_call_loses_no_update():
    """64 jobs on 32 threads, each adding to its call's stats through 200
    counters and spans, with the interpreter switching threads every
    microsecond: every update reaches the call's stats, under the call's
    id, and a pool thread leaves no call open behind a job."""
    jobs, adds = 64, 200
    st = {}

    def job(k):
        for _ in range(adds):
            timing.add("n", 1)
            with timing.span("s", "s_n"):
                pass
        return k, timing._call.get()[1]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as ex:
            with timing.call(st, "encode") as c:
                done = list(ex.map(timing.in_call(job), range(jobs)))
                for got, err, part in done:
                    assert err is None
                    for key, value in part.items():
                        timing.add(key, value)
            left = list(ex.map(lambda _: timing._call.get(), range(jobs)))
    finally:
        sys.setswitchinterval(interval)
    assert [got for got, _, _ in done] == [(k, c.id) for k in range(jobs)]
    assert st["n"] == jobs * adds and st["s_n"] > 0
    assert left == [None] * jobs


def test_in_call_returns_the_error():
    """A job that raises gives its exception and what it added before."""
    def job():
        timing.add("n", 2)
        raise ValueError("x")

    with timing.call({}, "encode"):
        got, err, part = timing.in_call(job)()
    assert got is None and isinstance(err, ValueError) and part == {"n": 2}


def test_print_timing_sums_overlapping_spans():
    """-timing='s summary sums spans of one name that overlap (two pool
    threads): 1 s and 4 s of the same span give 5000 ms."""
    snap = timing.snapshot()
    try:
        timing.reset()
        timing.restore(([[0.0] * len(timing.STAGES)] * timing.MAX_THREADS,
                        [("x_BEGIN", 10.0), ("x_BEGIN", 11.0),
                         ("x_END", 12.0), ("x_END", 14.0)]))
        out = io.StringIO()
        timing.print_timing(out)
    finally:
        timing.restore(snap)
    assert "[x] 5000.00 ms" in out.getvalue()
