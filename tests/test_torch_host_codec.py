"""The port's host codec (lepton_tpu_torch/host.py, re-exported by api)
against the JAX package's host codec, on the CPU.

compress must give the JAX package's .lep bytes, and decompress the
original JPEG and the JAX package's bytes, in every case below; each
package decodes the other's output.  Also decompress_streaming (the
O(width) decode), UJG, generic_compress, compress_any (verify,
permissive), decompress_all on a concatenation, the model
template of LEPTON_COMPRESSION_MODEL (host coders and device kernels start
from it alike), and the jailed parse with its allowlisted unpickler.
Every comparison is exact.  Inputs are PIL-made JPEGs from numpy seeds.
"""
import io
import os
import pickle

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402

from lepton_tpu_torch import api, host  # noqa: E402
from lepton_tpu_torch.jpeg.parser import JpegParseError  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


def _cmyk() -> bytes:
    rng = np.random.default_rng(8)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (24, 32, 4), dtype=np.uint8),
                    "CMYK").save(buf, "JPEG", quality=80)
    return buf.getvalue()


def _embedded() -> bytes:
    return b"prefix bytes before the JPEG" + _jpeg(48, 32, seed=4,
                                                   quality=85)


# (name, JPEG maker, compress keywords): one case a host-codec option
CASES = [
    ("baseline_v1", lambda: _jpeg(64, 48, seed=1, quality=85), {}),
    ("baseline_v2", lambda: _jpeg(64, 48, seed=1, quality=85),
     dict(version=2)),
    ("baseline_v3", lambda: _jpeg(64, 48, seed=1, quality=85),
     dict(version=3, max_threads=4, min_threads=4)),
    ("progressive_v1", lambda: _jpeg(64, 48, seed=2, quality=85,
                                     progressive=True),
     dict(allow_progressive=True)),
    ("progressive_v3", lambda: _jpeg(64, 48, seed=2, quality=85,
                                     progressive=True),
     dict(allow_progressive=True, version=3)),
    ("cmyk", _cmyk, dict(allow_four_colors=True)),
    ("even_split", lambda: _jpeg(80, 64, seed=3, quality=90,
                                 subsampling=0),
     dict(even_split=True, max_threads=3, min_threads=3)),
    ("start_byte_mode_y", lambda: _jpeg(64, 48, seed=5, quality=85),
     dict(start_byte=700)),
    ("embedding", _embedded, dict(embedding=28)),
    ("grey_restart", lambda: _jpeg(48, 40, seed=6, mode="L", quality=75,
                                   restart_marker_blocks=2),
     dict(max_threads=2, min_threads=2)),
]


@pytest.mark.parametrize("name,make,kw", CASES, ids=[c[0] for c in CASES])
def test_compress_decompress_match_jax(name, make, kw):
    data = make()
    lep = api.compress(data, **kw)
    jlep = japi.compress(data, **kw)
    assert lep == jlep
    assert lep[3:4] == (b"Y" if kw.get("start_byte") else
                        b"X" if kw.get("allow_progressive") else b"Z")
    want = data[kw.get("start_byte", 0):]
    if name == "embedding":
        want = data
    assert api.decompress(lep) == want
    assert api.decompress(lep) == japi.decompress(lep)
    # each package decodes the other's output
    assert japi.decompress(lep) == want
    assert host.decompress(jlep) == want


STREAMING = ("baseline_v1", "baseline_v3", "progressive_v1", "even_split",
             "start_byte_mode_y", "grey_restart")


@pytest.mark.parametrize("name,make,kw", [c for c in CASES
                                          if c[0] in STREAMING],
                         ids=list(STREAMING))
def test_decompress_streaming_matches_jax(name, make, kw):
    """The O(width) decode (ring planes, row by row; the full decode for
    v3, mode X and mode Y) gives the original, as the JAX package's
    decompress_streaming does."""
    data = make()
    lep = host.compress(data, **kw)
    out = host.decompress_streaming(lep)
    assert out == data[kw.get("start_byte", 0):]
    assert out == japi.decompress_streaming(lep)


def test_ujg_matches_jax():
    data = _jpeg(48, 40, seed=18, quality=85, restart_marker_blocks=2)
    ujg = host.ujg_compress(data)
    assert ujg == japi.ujg_compress(data) and ujg[:2] == b"UJ"
    assert host.ujg_decompress(ujg) == data
    prog = _jpeg(48, 40, seed=18, quality=85, progressive=True)
    ujg = host.ujg_compress(prog, allow_progressive=True)
    assert ujg == japi.ujg_compress(prog, allow_progressive=True)
    assert host.ujg_decompress(ujg) == prog


def test_four_colors_refused_by_default():
    from lepton_tpu_torch.jpeg.imageinfo import UnsupportedJpeg
    with pytest.raises(UnsupportedJpeg):
        host.compress(_cmyk())


def test_generic_compress_matches_jax():
    payload = np.random.default_rng(9).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    lep = host.generic_compress(payload)
    assert lep == japi.generic_compress(payload)
    assert lep[3:4] == b"Y"
    assert host.decompress(lep) == payload == japi.decompress(lep)
    with pytest.raises(host.LeptonError):
        host.generic_compress(b"")


def test_compress_any_verify_and_permissive():
    data = _jpeg(48, 32, seed=10, quality=80)
    assert host.compress_any(data) == japi.compress(data)
    junk = b"not a JPEG at all"
    with pytest.raises(JpegParseError):
        host.compress_any(junk)
    assert host.compress_any(junk, permissive=True) == \
        japi.compress_any(junk, permissive=True) == \
        host.generic_compress(junk)


def test_compress_any_device_engine_verifies_on_the_host():
    """engine="device" encodes through compress_device (plain versions on
    the CPU here) and verifies with the host decoder: the bytes equal the
    host encode at the same segment count."""
    data = _jpeg(48, 32, seed=11, quality=80)
    lep = host.compress_any(data, engine="device", device="cpu",
                            max_threads=8)
    assert lep == japi.compress(data, max_threads=8)


def test_decompress_all_concatenation():
    a = _jpeg(48, 32, seed=12, quality=80)
    b = _jpeg(32, 24, seed=13, quality=70, subsampling=0)
    cat = host.compress(a) + host.compress(b, version=3)
    assert host.decompress_all(cat) == a + b == japi.decompress_all(cat)
    with pytest.raises(host.LeptonError):
        host.decompress_all(b"\x00\x01")


def test_model_template(synth_model, monkeypatch):
    """LEPTON_COMPRESSION_MODEL: the host coders start from the trained
    model as the JAX package's do, and a device encode from the same file
    verifies on the host decoder."""
    data = _jpeg(48, 40, seed=14, quality=85)
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    lep = host.compress(data, max_threads=2, min_threads=2)
    assert lep == japi.compress(data, max_threads=2, min_threads=2)
    assert host.decompress(lep) == data
    assert np.array_equal(host._model_template_packed(),
                          japi._model_template_packed())
    dlep = api.compress_device(data, num_segments=1, device="cpu")
    assert host.decompress(dlep) == data
    monkeypatch.delenv("LEPTON_COMPRESSION_MODEL")
    assert host.compress(data) == japi.compress(data)


def test_jailed_parse_matches_inline():
    """The parse in a jailed forked child returns what the in-process
    parse returns, and compress_device(jailed_parse=True) the same bytes."""
    from lepton_tpu_torch import cli
    cli._prepare_for_jail({})
    data = _jpeg(64, 48, seed=15, quality=85, restart_marker_blocks=3)
    parsed, info, dec = host._parse_jpeg_jailed(data, False)
    rparsed, rinfo, rdec = host._parse(data)
    assert parsed.hdrdata == rparsed.hdrdata
    assert parsed.garbage == rparsed.garbage
    assert parsed.rst_cnt == rparsed.rst_cnt
    assert info.cmpc == rinfo.cmpc
    for a, b in zip(dec.planes, rdec.planes):
        assert np.array_equal(a, b)
    assert dec.padbit == rdec.padbit
    assert [h.segment_size for h in dec.handoffs] == \
        [h.segment_size for h in rdec.handoffs]
    assert api.compress_device(data, 8, "cpu", jailed_parse=True) == \
        api.compress_device(data, 8, "cpu")


def test_jailed_parse_hostile_input():
    """A corrupt JPEG fails cleanly through the jailed channel: its typed
    exception in the parent."""
    from lepton_tpu_torch import cli
    cli._prepare_for_jail({})
    data = bytearray(_jpeg(48, 32, seed=16, quality=80))
    data[2:6] = b"\xff\xc4\x00\x01"     # DHT with an impossible length
    with pytest.raises(JpegParseError):
        host._parse_jpeg_jailed(bytes(data), False)


def test_jailed_parse_channel_refuses_foreign_pickles():
    """The return channel's unpickler refuses any class off its list
    (os.system et al.), and takes the port's own classes."""
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(pickle.UnpicklingError):
        host._restricted_loads(pickle.dumps((True, Evil())))
    # the JAX package's classes are foreign to the port's channel
    jdata = japi._parse_jpeg_jailed.__globals__["parse_jpeg"](
        _jpeg(16, 16, seed=17))
    with pytest.raises(pickle.UnpicklingError):
        host._restricted_loads(pickle.dumps((True, jdata)))
    ok, parsed = host._restricted_loads(pickle.dumps(
        (True, host._parse(_jpeg(16, 16, seed=17))[0])))
    assert ok and parsed.hdrdata

