"""The batch decode's mode-X re-emit on the host pool (api._reemit_modex):
the concurrent route against the pool's one-worker case
(pool._MAX_WORKERS = 1), which is that of a one-request batch and a
one-CPU host; mode-Z requests on the calling thread in a mixed batch; the
error of the first failing request, or each its own with per_request;
the stats that the pool's jobs add to the call.  Inputs are PIL-made
progressive JPEGs; device="cpu" runs the plain versions."""
import io
import threading

import numpy as np
import pytest
from PIL import Image

from lepton_tpu_torch import api, host
from lepton_tpu_torch.kernels import vpx_decoder
from lepton_tpu_torch.util import pool, timing


def _jpeg(w: int, h: int, seed: int, progressive: bool = True) -> bytes:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ch = np.clip((xx * 255 / w + yy * 255 / h) / 2
                 + rng.normal(0, 24, size=(h, w)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)],
                             axis=-1), "RGB").save(
        buf, "JPEG", quality=85, progressive=progressive)
    return buf.getvalue()


BLOBS = [_jpeg(32, 16, 1), _jpeg(16, 32, 2), _jpeg(24, 24, 3),
         _jpeg(40, 16, 4)]
BASELINE = [_jpeg(32, 24, 5, False), _jpeg(24, 32, 6, False)]


@pytest.fixture(scope="module")
def leps():
    """The progressive photos' mode-X .lep and the baseline photos' mode-Z
    .lep, two segments each."""
    x = api.batch_compress_device(BLOBS, 2, "cpu", allow_progressive=True)
    z = api.batch_compress_device(BASELINE, 2, "cpu")
    assert {lep[3] for lep in x} == {ord("X")}
    assert {lep[3] for lep in z} == {ord("Z")}
    return x, z


def _decode(monkeypatch, workers, batch, **kw):
    """(JPEGs, stats) of one batch decode with the pool's size set."""
    monkeypatch.setattr(pool, "_MAX_WORKERS", workers)
    stats = {}
    return api.batch_decompress_device(batch, "cpu", stats, **kw), stats


def test_pool_gives_the_serial_routes_bytes(monkeypatch, leps):
    """A batch of 4 mode-X requests re-emitted on 4 threads gives the
    originals, as the serial route does; reemit_workers names the route,
    the scans' bytes are counted alike, and the native seconds, summed
    over the threads, lie within the re-emit's wall on each thread."""
    serial, st1 = _decode(monkeypatch, 1, leps[0])
    pooled, st4 = _decode(monkeypatch, 4, leps[0])
    assert serial == BLOBS and pooled == BLOBS
    assert st1["reemit_workers"] == 1 and st4["reemit_workers"] == 4
    assert st1["recode_scan_bytes"] == st4["recode_scan_bytes"] > 0
    for st in (st1, st4):
        assert 0 < st["recode_native_s"] \
            <= st["recode_s"] * st["reemit_workers"]


def test_one_request_runs_serial(monkeypatch, leps):
    """A one-request batch re-emits on the calling thread alone, with a
    pool of 4 at hand."""
    got, st = _decode(monkeypatch, 4, leps[0][:1])
    assert got == BLOBS[:1] and st["reemit_workers"] == 1


def test_mixed_batch_keeps_mode_z_on_the_caller(monkeypatch, leps):
    """Mode-X and mode-Z requests interleaved: every original back; the
    mode-X requests run on the pool's threads, the mode-Z ones (whose
    segments take the pool themselves) on the calling thread.  A
    baseline-only batch carries no reemit_workers."""
    x, z = leps
    batch = [x[0], z[0], x[1], z[1], x[2]]
    want = [BLOBS[0], BASELINE[0], BLOBS[1], BASELINE[1], BLOBS[2]]
    seen = []
    real = api._reemit

    def spy(hdr, handoffs, planes):
        seen.append((chr(hdr.mode), threading.get_ident()))
        return real(hdr, handoffs, planes)

    monkeypatch.setattr(api, "_reemit", spy)
    got, st = _decode(monkeypatch, 4, batch)
    assert got == want and st["reemit_workers"] == 3
    caller = threading.get_ident()
    assert sorted(m for m, _ in seen) == ["X"] * 3 + ["Z"] * 2
    assert all((t == caller) == (m == "Z") for m, t in seen)
    got, st = _decode(monkeypatch, 4, z)
    assert got == BASELINE and "reemit_workers" not in st


def _flag_planes(monkeypatch):
    """The reader flags requests 1 and 3's streams inconsistent."""
    split = vpx_decoder.split_planes

    def flagged(plan, coef, bad):
        return [(p, b | (i in (1, 3)))
                for i, (p, b) in enumerate(split(plan, coef, bad))]

    monkeypatch.setattr(vpx_decoder, "split_planes", flagged)
    return api.LeptonError("request 1: lepton stream inconsistent "
                           "(device decode)")


def _raising_reemit(monkeypatch):
    """A re-emit that raises an error no request names for requests 1
    and 3."""
    real = api._reemit
    sizes = {len(BLOBS[i]): i for i in range(4)}

    def reemit(hdr, handoffs, planes):
        i = sizes[hdr.original_size]
        if i in (1, 3):
            raise RuntimeError(f"request {i} broke")
        return real(hdr, handoffs, planes)

    monkeypatch.setattr(api, "_reemit", reemit)
    return host.request_error(1, RuntimeError("request 1 broke"))


@pytest.mark.parametrize("breaks", [_flag_planes, _raising_reemit],
                         ids=["flagged_planes", "reemit_raises"])
@pytest.mark.parametrize("workers", [1, 4])
def test_failing_requests(monkeypatch, leps, breaks, workers):
    """With requests 1 and 3 broken, both routes raise request 1's error,
    of the type and message the serial loop gives; with per_request,
    each of the two gets its own LeptonError and the others their
    bytes."""
    assert len(set(map(len, BLOBS))) == 4
    want = breaks(monkeypatch)
    with pytest.raises(host.REQUEST_ERRORS) as got:
        _decode(monkeypatch, workers, leps[0])
    assert type(got.value) is type(want)
    assert str(got.value) == str(want)
    out, _ = _decode(monkeypatch, workers, leps[0], per_request=True)
    assert out[0] == BLOBS[0] and out[2] == BLOBS[2]
    for i in (1, 3):
        assert isinstance(out[i], api.LeptonError)
        assert str(out[i]).startswith(f"request {i}: ")


def test_pooled_requests_overlap(monkeypatch):
    """Four 512x384 progressive photos, their planes from the parse, on
    four threads: the originals back, the requests' spans open at once
    under -timing=, and the native seconds summed over the threads are at
    least the re-emit's wall over the threads."""
    blobs = [_jpeg(512, 384, s) for s in range(4)]
    reqs = [api._decode_request(host.compress(b, allow_progressive=True), i)
            for i, b in enumerate(blobs)]
    planes = [(api._parse(b, True, False)[2].planes, np.zeros(1, bool))
              for b in blobs]
    monkeypatch.setattr(pool, "_MAX_WORKERS", 4)
    monkeypatch.setattr(timing, "_enabled", True)
    timing.reset()
    st = {}
    try:
        with timing.call(st, "decode"):
            with timing.span("re-emit", "recode_s"):
                done = api._reemit_modex(reqs, planes)
        marks = [name for name, _ in timing._events
                 if name.startswith("re-emit.request_")]
    finally:
        timing.reset()
    assert [done[i] for i in range(4)] == [(b, None) for b in blobs]
    assert st["reemit_workers"] == 4
    open_at_once = max(np.cumsum([1 if m.endswith("_BEGIN") else -1
                                  for m in marks]))
    assert len(marks) == 8 and open_at_once > 1
    assert st["recode_s"] / st["reemit_workers"] <= st["recode_native_s"] \
        <= st["recode_s"] * st["reemit_workers"]
