"""Progressive and multi-scan JPEGs (mode X) and 4-component JPEGs through
the port, on the CPU, against the JAX package.

The host layers (scan decode, jpeg/progressive.py; re-emit,
jpeg/recode_progressive.py) must give the JAX package's planes, handoffs
and bytes, in the native library and in the Python loops.  The entry points
(compress_device / batch_compress_device with allow_progressive or
allow_four_colors, decompress_device / batch_decompress_device) run the
plain PyTorch versions of the kernels with device="cpu"; their .lep bytes
must equal the host compress (and compress_tpu once each), and their
decodes the original JPEG and the host decompress.  Every comparison is
exact.  Inputs are PIL-made JPEGs from numpy seeds, 64x64 or smaller,
except two q100 grayscale files that hit the reference encoder's quirk:
467x694, which only the host layers see, and 160x96, which the port
decodes.
"""
import io

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.jpeg import recode_progressive as jrecode  # noqa: E402
from lepton_tpu.jpeg.decoder import decode_scans as jdecode  # noqa: E402
from lepton_tpu.jpeg.imageinfo import image_info_from_header as jinfo  # noqa: E402,E501
from lepton_tpu.jpeg.parser import JpegParseError as JParseError  # noqa: E402
from lepton_tpu.jpeg.parser import parse_jpeg as jparse  # noqa: E402

import chip_smoke  # noqa: E402
from lepton_tpu_torch import api  # noqa: E402
from lepton_tpu_torch.container.format import read_container  # noqa: E402
from lepton_tpu_torch.jpeg import recode_progressive  # noqa: E402
from lepton_tpu_torch.jpeg.decoder import decode_scans  # noqa: E402
from lepton_tpu_torch.jpeg.imageinfo import image_info_from_header  # noqa: E402
from lepton_tpu_torch.jpeg.parser import JpegParseError, parse_jpeg  # noqa: E402
from test_torch_encode import _jpeg, _port_with_segments  # noqa: E402


def multi_scan(data: bytes) -> bytes:
    """A baseline JPEG with one scan a component, made from a PIL baseline
    file (PIL cannot write one): its single SOS is replaced by one SOS a
    component (Ns 1, Ss 0, Se 63, AhAl 0), and the JAX package's
    progressive re-emit, which writes sequential scans too, regenerates
    the scans from the file's planes."""
    parsed = jparse(data)
    hdr = parsed.hdrdata
    dec = jdecode(parsed, jinfo(hdr))
    at = hdr.rfind(b"\xff\xda")
    comps = [hdr[at + 5 + 2 * k:at + 7 + 2 * k] for k in range(hdr[at + 4])]
    new = hdr[:at] + b"".join(b"\xff\xda\x00\x08\x01" + c + b"\x00\x3f\x00"
                              for c in comps)
    return jrecode.recode_progressive_jpeg(
        new, dec.planes, jinfo(new), dec.padbit, [], False, [],
        b"\xff\xd9", 1 << 30)


def _prog(**kw) -> bytes:
    return _jpeg(64, 48, seed=5, quality=85, progressive=True, **kw)


def _quirk() -> bytes:
    """tests/test_synthetic_corpus.py's q100 grayscale progressive file, on
    which the reference encoder (and so the JAX package) gives back other
    bytes than the original."""
    arr = np.random.default_rng(331).integers(0, 256, size=(467, 694))
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8), "L").save(
        buf, "JPEG", quality=100, subsampling=2, progressive=True)
    return buf.getvalue()


MAKERS = {
    "progressive": lambda: _prog(subsampling=2),
    "progressive_optimized": lambda: _jpeg(48, 40, seed=6, quality=85,
                                           progressive=True, optimize=True,
                                           subsampling=0),
    "progressive_restart": lambda: _jpeg(64, 48, seed=11, quality=85,
                                         progressive=True,
                                         restart_marker_blocks=3,
                                         subsampling=2),
    "multi_scan": lambda: multi_scan(_jpeg(64, 48, seed=5, quality=85,
                                           subsampling=2)),
    "cut_50": lambda: (lambda d: d[:len(d) // 2])(_prog(subsampling=2)),
    "cut_90": lambda: (lambda d: d[:len(d) * 9 // 10])(_prog(subsampling=2)),
    "gray_progressive": lambda: _jpeg(40, 32, seed=7, mode="L", quality=90,
                                      progressive=True),
    "quirk_q100_gray": _quirk,
}
SMALL = [k for k in MAKERS if k != "quirk_q100_gray"]
_made = {}


def _data(name: str) -> bytes:
    if name not in _made:
        _made[name] = MAKERS[name]()
    return _made[name]


def test_multi_scan_fixture():
    """The fixture is a multi-scan baseline file that PIL opens, whose
    planes are the source file's; chip_smoke.multi_scan_jpeg (the port's
    own re-emit, no JAX) makes the same bytes."""
    src = _jpeg(64, 48, seed=5, quality=85, subsampling=2)
    data = _data("multi_scan")
    Image.open(io.BytesIO(data)).load()
    assert data.count(b"\xff\xda") == 3
    parsed = jparse(data)
    dec = jdecode(parsed, jinfo(parsed.hdrdata), allow_progressive=True)
    ref = jparse(src)
    assert not dec.is_baseline
    for a, b in zip(dec.planes, jdecode(ref, jinfo(ref.hdrdata)).planes):
        assert np.array_equal(a, b)
    assert chip_smoke.multi_scan_jpeg(src) == data


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("name", list(MAKERS))
def test_scan_decode_matches_jax(name, use_native):
    """Planes, handoffs, padbit, the early-EOF fields and is_baseline equal
    the JAX decode_scans(allow_progressive=True), field for field."""
    data = _data(name)
    parsed = parse_jpeg(data)
    dec = decode_scans(parsed, image_info_from_header(parsed.hdrdata),
                       allow_progressive=True, use_native=use_native)
    jparsed = jparse(data)
    ref = jdecode(jparsed, jinfo(jparsed.hdrdata), allow_progressive=True,
                  use_native=use_native)
    assert len(dec.planes) == len(ref.planes)
    for a, b in zip(dec.planes, ref.planes):
        assert np.array_equal(a, b)
    assert [vars(h) for h in dec.handoffs] == [vars(h) for h in ref.handoffs]
    fields = ("padbit", "early_eof", "max_cmp", "max_bpos", "max_sah",
              "max_dpos", "is_baseline")
    assert [getattr(dec, f) for f in fields] \
        == [getattr(ref, f) for f in fields]
    assert not dec.is_baseline
    assert dec.early_eof == name.startswith("cut_")


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("name", list(MAKERS))
def test_reemit_matches_jax(name, use_native):
    """The port's progressive re-emit gives the JAX one's bytes from the
    same planes: the original JPEG, or for the q100 quirk file the JAX
    package's own (other) bytes."""
    data = _data(name)
    parsed = jparse(data)
    dec = jdecode(parsed, jinfo(parsed.hdrdata), allow_progressive=True)
    hdr = parsed.hdrdata
    garbage = parsed.garbage or b"\xff\xd9"
    outs = []
    for mod, info_of in ((recode_progressive, image_info_from_header),
                         (jrecode, jinfo)):
        huff, scnp, rstp, scnc = mod.regenerate_scans(
            hdr, dec.planes, info_of(hdr), dec.padbit, use_native=use_native,
            truncated=dec.early_eof)
        outs.append(mod.merge_jpeg(hdr, huff, scnp, rstp, scnc,
                                   parsed.rst_cnt, False, parsed.rst_err,
                                   garbage, parsed.jpgfilesize, None, False))
    assert outs[0] == outs[1]
    assert (outs[0] == data) == (name != "quirk_q100_gray")
    assert recode_progressive.recode_progressive_jpeg(
        hdr, dec.planes, image_info_from_header(hdr), dec.padbit,
        parsed.rst_cnt, False, parsed.rst_err, garbage, parsed.jpgfilesize,
        truncated=dec.early_eof) == outs[0]


def test_quirk_decode_matches_jax():
    """A smaller file that hits the q100 quirk: the port decodes the host
    compress's mode-X .lep to the JAX package's own output, which is not
    the original."""
    data = chip_smoke.gray_q100(chip_smoke.QUIRK_SEED, 160, 96)
    lep = japi.compress(data, allow_progressive=True)
    assert api.decompress_device(lep, device="cpu") == japi.decompress(lep) \
        != data


@pytest.mark.parametrize("name", SMALL)
def test_round_trip_matches_host(name):
    """compress_device(allow_progressive=True) writes the host compress's
    mode-X .lep; decompress_device gives back the original JPEG, as the
    host decompress does."""
    data = _data(name)
    lep = api.compress_device(data, device="cpu", allow_progressive=True)
    assert lep == japi.compress(data, allow_progressive=True)
    hdr, _ = read_container(lep)
    assert chr(hdr.mode) == "X" and hdr.early_eof == name.startswith("cut_")
    assert api.decompress_device(lep, device="cpu") == data \
        == japi.decompress(lep)


@pytest.mark.parametrize("version", [1, 3])
@pytest.mark.parametrize("name", ["progressive", "multi_scan"])
def test_segments_match_host(name, version):
    """Two segments, split at handoffs crystallized in the DC scans
    (progressive) or in component 0's scan (multi-scan): the port's bytes
    equal the host compress's with two threads, v1 and v3; the JAX-made
    container decodes on the port to the original."""
    data = _data(name)
    ref = japi.compress(data, allow_progressive=True, version=version,
                        max_threads=2, min_threads=2)
    assert ref[4] == 2
    assert _port_with_segments(data, 2, version, allow_progressive=True) \
        == ref
    assert api.decompress_device(ref, device="cpu") == data \
        == japi.decompress(ref)


def test_v3_matches_host():
    data = _data("progressive_optimized")
    lep = api.compress_device(data, device="cpu", version=3,
                              allow_progressive=True)
    assert lep == japi.compress(data, allow_progressive=True, version=3)
    assert api.decompress_device(lep, device="cpu") == data


def test_compress_tpu_twin():
    """The JAX device pipeline on a progressive file in two segments."""
    data = _prog(subsampling=2)
    assert api.compress_device(data, num_segments=2, device="cpu",
                               allow_progressive=True) \
        == japi.compress_tpu(data, num_segments=2, allow_progressive=True)


def test_batch_mixes_modes():
    """One encode batch and one decode call holding mode-Z and mode-X
    requests of both coders' containers: batch equals single, every
    original comes back through one launch per coder."""
    blobs = [_data("progressive"), _jpeg(40, 32, seed=1, quality=90,
                                         subsampling=2),
             _data("multi_scan")]
    leps = api.batch_compress_device(blobs, device="cpu",
                                     allow_progressive=True)
    assert leps == [api.compress_device(b, device="cpu",
                                        allow_progressive=True)
                    for b in blobs]
    assert [lep[3] for lep in leps] == [ord("X"), ord("Z"), ord("X")]
    leps.append(japi.compress(_data("gray_progressive"),
                              allow_progressive=True, version=3))
    stats = {}
    assert api.batch_decompress_device(leps, device="cpu", stats=stats) \
        == blobs + [_data("gray_progressive")]
    assert stats["lanes"] == 4


def test_multi_scan_refused_without_allow_progressive():
    """As a progressive file is (test_torch_encode.py)."""
    with pytest.raises(api.UnsupportedJpeg):
        api.compress_device(_data("multi_scan"), device="cpu")


def test_cut_in_header_raises_as_jax():
    """A progressive file cut inside the header of its third scan: the
    JAX package and the port both refuse it at the parse."""
    data = _prog(subsampling=2)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    short = data[:sos[2] + 4]
    with pytest.raises(JParseError, match="end of data in header"):
        japi.compress(short, allow_progressive=True)
    with pytest.raises(JpegParseError, match="end of data in header"):
        api.compress_device(short, device="cpu", allow_progressive=True)


def _cmyk(w=32, h=24, seed=8, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8),
                    "CMYK").save(buf, "JPEG", quality=80, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cmyk_tpu():
    """(CMYK JPEG, batch_compress_tpu's .lep of it): one JAX compile."""
    data = _cmyk()
    return data, japi.batch_compress_tpu([data])[0]


def test_four_colors_matches_jax(cmyk_tpu):
    data, ref = cmyk_tpu
    port = api.batch_compress_device([data], device="cpu",
                                     allow_four_colors=True)
    assert port == [ref]
    assert ref == japi.compress_tpu(data, allow_four_colors=True) \
        == japi.compress(data, allow_four_colors=True)
    assert api.decompress_device(ref, device="cpu") == data


def test_four_colors_refused_by_default(cmyk_tpu):
    """Known difference, kept on purpose: batch_compress_tpu encodes a CMYK
    JPEG without being asked (it has no 4-colour check), while the port
    refuses it by default, as compress_tpu and the host compress do."""
    data, ref = cmyk_tpu
    assert ref[:2] == b"\xcf\x84"
    with pytest.raises(api.UnsupportedJpeg, match="4 colors"):
        api.batch_compress_device([data], device="cpu")
    with pytest.raises(api.UnsupportedJpeg, match="4 colors"):
        api.compress_device(data, device="cpu")


@pytest.mark.parametrize("kind", ["segments", "progressive"])
def test_four_colors_decode(kind):
    """JAX-made 4-colour containers decode on the port to the original:
    one in two segments, one progressive (mode X)."""
    if kind == "segments":
        data = _cmyk(48, 64, seed=9)
        lep = japi.compress(data, allow_four_colors=True, max_threads=2,
                            min_threads=2)
        assert lep[4] == 2
    else:
        data = _cmyk(24, 16, seed=10, progressive=True)
        lep = japi.compress(data, allow_four_colors=True,
                            allow_progressive=True)
        assert lep[3] == ord("X")
        assert api.compress_device(data, device="cpu", allow_four_colors=True,
                                   allow_progressive=True) == lep
    assert api.decompress_device(lep, device="cpu") == data \
        == japi.decompress(lep)
