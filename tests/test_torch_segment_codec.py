"""The port's pure-Python segment codec and the modules under it, against
the JAX package's, on the CPU.

model/branch (the transition LUTs, the divider), the scalar context
functions of model/context, coder/vpx and coder/ans, codec/blocks and
codec/driver (encode_segment and decode_segment, VPX and ANS, also
against the port's C codec), the host codec's Python route (taken where
the C library cannot be built, counted in host.SEGMENT_CODEC_ROUTES, and
starting from LEPTON_COMPRESSION_MODEL as the C route does), the same
route in distributed_compress, compress_device(symbolizer="native"), and
util/billing.bill_symbol_stream.  Inputs come from numpy seeds (JPEGs
through PIL); every comparison is exact: equal bytes, equal arrays.
"""
import io

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")

import lepton_tpu._native as jnative  # noqa: E402
import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.codec import driver as jdriver  # noqa: E402
from lepton_tpu.coder import ans as jans  # noqa: E402
from lepton_tpu.coder import vpx as jvpx  # noqa: E402
from lepton_tpu.model import branch as jbranch  # noqa: E402
from lepton_tpu.model import context as jctx  # noqa: E402
from lepton_tpu.util import billing as jbilling  # noqa: E402

from lepton_tpu_torch import _native, api, host  # noqa: E402
from lepton_tpu_torch.codec import driver  # noqa: E402
from lepton_tpu_torch.coder import ans, vpx  # noqa: E402
from lepton_tpu_torch.container.handoff import (  # noqa: E402
    choose_num_threads, select_splits)
from lepton_tpu_torch.model import branch, context  # noqa: E402
from lepton_tpu_torch.parallel import multihost as MH  # noqa: E402
from lepton_tpu_torch.util import billing, timing  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


@pytest.fixture
def identity_model(monkeypatch):
    """No LEPTON_COMPRESSION_MODEL and both packages' C templates at the
    identity before the test; after it, every patch undone and the C
    templates set from the environment again."""
    monkeypatch.delenv("LEPTON_COMPRESSION_MODEL", raising=False)
    host._apply_model_env()
    yield
    monkeypatch.undo()
    host._apply_model_env()
    japi._apply_model_env()


# ---------------------------------------------------------------------------
# model/branch, model/context
# ---------------------------------------------------------------------------


def test_next_state_luts_match_jax():
    assert np.array_equal(branch.next_state_lut(), jbranch.next_state_lut())
    assert np.array_equal(branch.next_state_lut_adv(),
                          jbranch.next_state_lut_adv())


def test_fast_divide_matches_jax():
    """Over the model's domain (num <= 65280, denom < 1024): a seeded
    sample and the edges, equal to JAX's and to exact division."""
    rng = np.random.default_rng(3)
    nums = [0, 1, 255, 65279, 65280] + rng.integers(0, 65281, 400).tolist()
    dens = [1, 2, 3, 255, 256, 511, 512, 1023] + \
        rng.integers(1, 1024, 60).tolist()
    for d in dens:
        for n in nums:
            got = branch.fast_divide18bit_by_10bit(n, d)
            assert got == jbranch.fast_divide18bit_by_10bit(n, d) == n // d


def _qtable(rng):
    return rng.integers(1, 100, 64)


def test_scalar_context_functions_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(40):
        q = _qtable(rng)
        port_ct, jax_ct = context.ColorTables(q), jctx.ColorTables(q)
        here, left, above, al = (rng.integers(-300, 300, 64).astype(np.int16)
                                 for _ in range(4))
        for ignore_dc in (False, True):
            assert np.array_equal(
                context.idct_block(here, port_ct.quant, ignore_dc),
                jctx.idct_block(here, jax_ct.quant, ignore_dc))
        pix = context.idct_block(here, port_ct.quant, True)
        dc = int(rng.integers(-500, 500))
        for fn in ("set_horizontal", "set_vertical"):
            assert np.array_equal(getattr(context, fn)(pix, 7, dc),
                                  getattr(jctx, fn)(pix, 7, dc))
        coords = np.arange(64)
        for lf, ab in ((left, above), (left, None), (None, above),
                       (None, None)):
            for c in range(64):
                assert context.compute_aavrg(c, lf, ab, al) == \
                    jctx.compute_aavrg(c, lf, ab, al)
            assert np.array_equal(
                context.compute_aavrg_vec(coords, lf, ab, al),
                jctx.compute_aavrg_vec(coords, lf, ab, al))
            for c in list(range(1, 8)) + list(range(8, 64, 8)):
                assert context.compute_lak(c, here, ab, lf, port_ct) == \
                    jctx.compute_lak(c, here, ab, lf, jax_ct)
        sums = [rng.integers(-2000, 2000, 16).astype(np.int16), None]
        for ls in sums:
            for as_ in sums:
                got = context.adv_predict_dc_pix(here, port_ct, ls, as_)
                want = jctx.adv_predict_dc_pix(here, jax_ct, ls, as_)
                assert got[:3] == want[:3]
                assert np.array_equal(got[3], want[3])
        for rec in (False, True):
            v, p = int(rng.integers(-3000, 3000)), int(rng.integers(-3000,
                                                                    3000))
            assert context.adv_predict_or_unpredict_dc(v, rec, p) == \
                jctx.adv_predict_or_unpredict_dc(v, rec, p)
        a, b = int(rng.integers(-999, 999)), int(rng.integers(1, 50))
        assert context.trunc_div(a, b) == jctx.trunc_div(a, b)
        assert context.trunc_div(a, -b) == jctx.trunc_div(a, -b)


# ---------------------------------------------------------------------------
# coder/vpx, coder/ans
# ---------------------------------------------------------------------------


def _bit_stream(seed: int, n: int = 6000):
    """Seeded (bit, prob) pairs, probabilities 1 and 255 among them, and a
    run of 500 1 bits at probability 1."""
    rng = np.random.default_rng(seed)
    probs = rng.integers(1, 256, n)
    probs[rng.random(n) < 0.1] = 1
    probs[rng.random(n) < 0.1] = 255
    bits = (rng.random(n) * 256 >= probs).astype(int)
    bits[n // 2:n // 2 + 500] = 1
    probs[n // 2:n // 2 + 500] = 1
    return bits.tolist(), probs.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_writers_match_jax_and_readers_round_trip(coder, seed):
    bits, probs = _bit_stream(seed)
    pw, jw = ((vpx.BoolWriter(), jvpx.BoolWriter()) if coder == "vpx"
              else (ans.ANSWriter(), jans.ANSWriter()))
    for b, p in zip(bits, probs):
        pw.put_bit(b, p)
        jw.put_bit(b, p)
    data = pw.finish()
    assert data == jw.finish()
    reader = vpx.BoolReader(data) if coder == "vpx" else ans.ANSReader(data)
    assert [reader.get_bit(p) for p in probs] == bits


def test_ans_has_one_branch_rule_and_tail():
    assert ans.adv_update_branch is branch.adv_update_branch
    from lepton_tpu_torch.kernels import ans_coder
    assert ans_coder.ANS_PARITY_TAIL is ans.ANS_PARITY_TAIL
    assert ans.ANS_PARITY_TAIL == jans.ANS_PARITY_TAIL


# ---------------------------------------------------------------------------
# codec/driver: encode_segment and decode_segment
# ---------------------------------------------------------------------------


def _cmyk() -> bytes:
    rng = np.random.default_rng(8)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (24, 32, 4), dtype=np.uint8),
                    "CMYK").save(buf, "JPEG", quality=80)
    return buf.getvalue()


def _cut() -> bytes:
    """Cut in its scan; in 4 segments of one 4:4:4 MCU row, luma row 3 of
    the last segment decodes 1 of its 4 blocks, rows 4 and 5 none (the
    cut that round-trips in tests/test_torch_parallel.py)."""
    short = _jpeg(32, 48, seed=5, quality=80, subsampling=0)
    return short[:int(len(short) * 0.7)]


# name -> (JPEG maker, segments)
FILES = {
    "420_64x48": (lambda: _jpeg(64, 48, seed=1, quality=85,
                                subsampling=2), 1),
    "gray_48x32": (lambda: _jpeg(48, 32, seed=2, mode="L", quality=80), 1),
    "444_40x32": (lambda: _jpeg(40, 32, seed=3, quality=90,
                                subsampling=0), 2),
    "four_segments": (lambda: _jpeg(64, 64, seed=4, quality=85,
                                    subsampling=2), 4),
    "early_cut": (_cut, 4),
    "cmyk": (_cmyk, 1),
}


def _segments(data: bytes, k: int):
    """(info, dec, max heights, component sizes, jobs) of a JPEG in k
    segments, as host.compress(min_threads=k, max_threads=k) splits it."""
    parsed, info, dec = host._parse(data, allow_four_colors=True)
    h = dec.handoffs
    nt = choose_num_threads(len(h), h[-1].segment_size - h[0].segment_size,
                            k, k)
    splits = select_splits(h, nt)
    assert len(splits) == k
    bounds = [th.luma_y_start for th in splits] + [info.cmpnfo[0].bcv]
    jobs = [(bounds[i], bounds[i + 1], i == k - 1) for i in range(k)]
    mh, cs = host._truncation_geometry(info, dec)
    return info, dec, mh, cs, jobs


@pytest.mark.parametrize("coder", ["vpx", "ans"])
@pytest.mark.parametrize("name", list(FILES))
def test_encode_decode_segment_match_jax_and_c(name, coder, identity_model):
    make, k = FILES[name]
    info, dec, mh, cs, jobs = _segments(make(), k)
    is_ans = coder == "ans"
    image = host._python_image(info, dec.planes, mh, cs)
    jimage = jdriver.ImageData(
        list(dec.planes), [jctx.ColorTables(info.qtables[
            info.cmpnfo[c].qtable_index]) for c in range(info.cmpc)],
        info.mcuv, mh, cs)
    native = host._native_image(info, dec.planes, mh, cs)
    c_enc = native.encode_segment_ans if is_ans else native.encode_segment
    streams = []
    for job in jobs:
        got = driver.encode_segment(image, *job, ans=is_ans)
        assert got == jdriver.encode_segment(jimage, *job, ans=is_ans)
        assert got == c_enc(*job)
        streams.append(got)
    planes = [np.zeros_like(p) for p in dec.planes]
    back = host._python_image(info, planes, mh, cs)
    for data, job in zip(streams, jobs):
        driver.decode_segment(back, data, *job, ans=is_ans)
    for p, want in zip(planes, dec.planes):
        assert np.array_equal(p, want)


# ---------------------------------------------------------------------------
# host.py's Python route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 3])
def test_host_python_route_matches_c_route(version, identity_model,
                                           monkeypatch, capsys):
    data = _jpeg(64, 48, seed=1, quality=85)
    kw = dict(version=version, max_threads=4, min_threads=4)
    c_lep = host.compress(data, **kw)
    assert c_lep == japi.compress(data, **kw)
    monkeypatch.setattr(_native, "available", lambda: False)
    monkeypatch.setitem(host.SEGMENT_CODEC_ROUTES, "python", 0)
    native_before = host.SEGMENT_CODEC_ROUTES["native"]
    assert host.compress(data, **kw) == c_lep
    assert host.decompress(c_lep) == data
    assert host.SEGMENT_CODEC_ROUTES == {"native": native_before,
                                         "python": 2}
    assert capsys.readouterr().err.count("coding segments in Python") == 1


@pytest.fixture
def model_env(synth_model, monkeypatch, identity_model):
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    return synth_model


@pytest.mark.parametrize("version", [1, 3])
def test_python_route_honours_model_template(version, model_env,
                                             monkeypatch):
    data = _jpeg(48, 32, seed=6, quality=85)
    kw = dict(version=version, max_threads=2, min_threads=2)
    c_lep = host.compress(data, **kw)
    assert c_lep == japi.compress(data, **kw)
    monkeypatch.setattr(_native, "available", lambda: False)
    assert host.compress(data, **kw) == c_lep
    assert host.decompress(c_lep) == data


def test_jax_python_route_ignores_model_template(model_env, monkeypatch):
    """A fault of the JAX package, pinned: without its C library, its
    Python codec starts from the identity whatever
    LEPTON_COMPRESSION_MODEL says (lepton_tpu/api.py:56-60,
    codec/driver.py:87), so its .lep differs from its C codec's; the
    port's Python route equals its C route."""
    data = _jpeg(48, 32, seed=6, quality=85)
    port_c = host.compress(data)
    monkeypatch.setattr(_native, "available", lambda: False)
    assert host.compress(data) == port_c
    monkeypatch.setattr(jnative, "available", lambda: False)
    jax_python = japi.compress(data)
    monkeypatch.delenv("LEPTON_COMPRESSION_MODEL")
    assert jax_python == japi.compress(data)     # the identity model's
    assert jax_python != port_c


def test_distributed_compress_python_route(identity_model, monkeypatch):
    data = _jpeg(64, 64, seed=11, quality=85, subsampling=2)
    c_lep = MH.distributed_compress(data, num_segments=4, engine="host")
    monkeypatch.setattr(_native, "available", lambda: False)
    python = host.SEGMENT_CODEC_ROUTES["python"]
    assert MH.distributed_compress(data, num_segments=4,
                                   engine="host") == c_lep
    assert host.SEGMENT_CODEC_ROUTES["python"] == python + 1


# ---------------------------------------------------------------------------
# compress_device(symbolizer=), bill_symbol_stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 3])
def test_native_symbolizer_matches_device_symbolizer(version,
                                                     identity_model):
    data = _jpeg(48, 32, seed=1, quality=85)
    stats = {}
    got = api.compress_device(data, device="cpu", version=version,
                              symbolizer="native", stats=stats)
    assert got == api.compress_device(data, device="cpu", version=version)
    assert stats["symbolize_s"] >= 0 and stats["lanes"] == 1
    assert ("ans_coder_ms" if version == 3 else "coder_ms") in stats
    if version == 1:
        # the one JAX compile of this file
        assert got == japi.compress_tpu(data, symbolizer="native")


def test_symbol_lanes_frame_as_jax():
    """Host symbol streams (an empty one among them) become VPX lanes
    framed as vpx_scan.build_symbol_streams frames them, and rANS lanes
    of the symbols alone, PAD after."""
    from lepton_tpu.kernels import vpx_scan
    from lepton_tpu_torch.kernels import batch_encode
    rng = np.random.default_rng(12)
    segs = [(rng.integers(0, 700000, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.uint8)) for n in (0, 1, 90, 33)]
    idx, bit = batch_encode.symbol_lanes(segs, True, "cpu")
    want_idx, want_bit = vpx_scan.build_symbol_streams(segs)
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(bit.numpy(), want_bit)
    stats = {}
    with timing.part(stats):
        idx, bit = batch_encode.symbol_lanes(segs, False, "cpu")
    assert idx.shape == (4, 90) and stats["symbols"] == 124
    for (i, b), li, lb in zip(segs, idx.numpy(), bit.numpy()):
        assert np.array_equal(li[:len(i)], i) and (li[len(i):] == -1).all()
        assert np.array_equal(lb[:len(b)], b) and not lb[len(b):].any()


def test_symbolizer_refused(monkeypatch):
    data = _jpeg(48, 32, seed=1, quality=85)
    with pytest.raises(ValueError):
        api.compress_device(data, device="cpu", symbolizer="xla")
    monkeypatch.setattr(_native, "available", lambda: False)
    with pytest.raises(host.LeptonError, match="native symbolizer "
                       "unavailable"):
        api.compress_device(data, device="cpu", symbolizer="native")


def test_bill_symbol_stream_matches_jax():
    info, dec, mh, cs, jobs = _segments(_jpeg(64, 48, seed=1, quality=85), 1)
    img = host._native_image(info, dec.planes, mh, cs)
    idx, _ = _native.native_symbolize_segment(img, *jobs[0])
    got = billing.bill_symbol_stream(idx)
    assert got == jbilling.bill_symbol_stream(idx) and sum(got.values()) \
        == len(idx)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, int(idx.max()) + 1, 5000)
    assert billing.bill_symbol_stream(idx) == jbilling.bill_symbol_stream(idx)
