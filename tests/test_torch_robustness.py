"""Hostile input through the port, on the CPU, against the JAX package.

The port of tests/test_robustness.py's ten tests: each runs on the port's
host codec (lepton_tpu_torch.host) and on its device entry points with
device="cpu" (compress_device, batch_compress_device, decompress_device,
batch_decompress_device(per_request=True): the kernels' plain versions),
and every outcome, a typed failure or bytes, equals the JAX package's on
the same bytes (failures compared by their exit code,
util.exitcodes.classify).  Synthetic PIL JPEGs made from numpy seeds
stand in for the reference corpus's nofsync.jpg.

Then the soak (lepton_tpu_torch/soak.py) at a small size, every case held
to lepton_tpu.api.compress / decompress, and its hostile kernel batches:
the tiny reader batches of a container's own streams against JAX's
decode_segments_tpu, random streams against the host's C segment decoder,
and the hostile coder lanes against the JAX package's coders.  The
tolerance is zero everywhere.
"""
import hashlib
import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.kernels import vpx_scan  # noqa: E402
from lepton_tpu.kernels.vpx_decode import decode_segments_tpu  # noqa: E402
from lepton_tpu.util.exitcodes import ExitCode  # noqa: E402
from lepton_tpu.util.exitcodes import classify as jclassify  # noqa: E402

import chip_smoke  # noqa: E402
from lepton_tpu_torch import api, host, soak  # noqa: E402
from lepton_tpu_torch.jpeg.huffman import HuffCodes  # noqa: E402
from lepton_tpu_torch.jpeg.parser import parse_jpeg  # noqa: E402
from lepton_tpu_torch.kernels import ans_coder, vpx_coder  # noqa: E402
from lepton_tpu_torch.kernels import vpx_decoder  # noqa: E402
from lepton_tpu_torch.util.exitcodes import classify  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg():
    """The stand-in for nofsync.jpg: a small 4:2:0 q90 photo."""
    return chip_smoke.make_photo(chip_smoke.SEED + 70, 96, 64)


def _lep():
    data = _jpeg()
    lep = japi.compress(data)
    assert host.compress(data) == lep
    return data, lep


def _outcome(fn, *args, **kw):
    """("bytes", the bytes) or ("error", the exit code it maps to)."""
    try:
        return "bytes", bytes(fn(*args, **kw))
    except Exception as e:
        return "error", int(classify(e))


def _joutcome(fn, *args, **kw):
    try:
        return "bytes", bytes(fn(*args, **kw))
    except Exception as e:
        return "error", int(jclassify(e))


def _device_decodes(blobs) -> list:
    """Each blob's outcome through one batch_decompress_device(per_request=
    True) call on the CPU."""
    outs = api.batch_decompress_device(blobs, device="cpu", per_request=True)
    return [("bytes", bytes(o)) if isinstance(o, (bytes, bytearray))
            else ("error", int(classify(o))) for o in outs]


def _same_class(port, jax_):
    """Outcomes agree: equal bytes, or failures on both sides (the device
    path reports a container it cannot read as LeptonError, the host
    codecs by the reader's own error: both are failures)."""
    return port[0] == jax_[0] and (port[0] == "error" or port == jax_)


def test_truncated_container_everywhere():
    data, lep = _lep()
    rng = random.Random(1)
    cuts = sorted(rng.sample(range(1, len(lep)), 40)) + [22, 28, 29, 40]
    blobs = [lep[:cut] for cut in cuts]
    device = _device_decodes(blobs)
    for cut, blob, dev_out in zip(cuts, blobs, device):
        want = _joutcome(japi.decompress, blob)
        got = _outcome(host.decompress, blob)
        assert got == want, cut
        assert _same_class(dev_out, want), cut
        # a truncated container must not fabricate a full-length original
        assert got != ("bytes", data) or cut == len(lep)


def test_bitflip_corruption():
    data, lep = _lep()
    rng = random.Random(2)
    blobs = []
    for _ in range(60):
        pos = rng.randrange(30, len(lep))  # past the fixed header
        mutated = bytearray(lep)
        mutated[pos] ^= 1 << rng.randrange(8)
        blobs.append(bytes(mutated))
    device = _device_decodes(blobs)
    for blob, dev_out in zip(blobs, device):
        want = _joutcome(japi.decompress, blob)
        got = _outcome(host.decompress, blob)
        assert got == want
        assert _same_class(dev_out, want)
        # a surviving decode may differ, but must terminate and stay
        # bounded
        if got[0] == "bytes":
            assert len(got[1]) <= len(data) + 65536


def test_random_garbage_rejected():
    rng = random.Random(3)
    blobs = []
    for n in (0, 1, 5, 100, 4096):
        blob = b"\xcf\x84" + bytes(rng.randrange(256) for _ in range(n))
        blobs.append(blob)
        for fn in (japi.decompress, host.decompress):
            with pytest.raises(Exception):
                fn(blob)
        with pytest.raises(host.REQUEST_ERRORS):
            api.decompress_device(blob, device="cpu")
    assert all(o[0] == "error" for o in _device_decodes(blobs))


@pytest.mark.parametrize("blob", [b"", b"\xff", b"\xff\xd8",
                                  b"\xff\xd8\xff\xd9"],
                         ids=["empty", "ff", "soi", "soi_eoi"])
def test_zero_length_and_tiny_jpegs(blob):
    want = _joutcome(japi.compress, blob)
    assert want[0] == "error"
    assert _outcome(host.compress, blob) == want
    with pytest.raises(host.REQUEST_ERRORS) as e:
        api.compress_device(blob, device="cpu")
    assert int(classify(e.value)) == want[1]


def test_four_component_rejected():
    """A SOF0 patched to claim 4 components is refused as the JAX package
    refuses it, on the host and on the device path."""
    base = _jpeg()
    i = base.find(b"\xff\xc0")
    assert i > 0
    ncomp_off = i + 9
    patched = bytearray(base)
    old_len = (base[i + 2] << 8) | base[i + 3]
    patched[ncomp_off] = 4
    patched[i + 2:i + 4] = (old_len + 3).to_bytes(2, "big")
    patched[ncomp_off + 1:ncomp_off + 1] = bytes([4, 0x11, 0])
    patched = bytes(patched)
    want = _joutcome(japi.compress, patched)
    assert want[0] == "error" and want[1] in (
        ExitCode.UNSUPPORTED_4_COLORS, ExitCode.UNSUPPORTED_JPEG)
    assert _outcome(host.compress, patched) == want
    assert _outcome(api.compress_device, patched, device="cpu") == want


def _malicious_dc_category_jpeg() -> bytes:
    """tests/test_robustness.py's JPEG whose DC Huffman table maps a 1-bit
    code to symbol 0xFF (DC category 255)."""
    soi = b"\xff\xd8"
    dqt = b"\xff\xdb" + (67).to_bytes(2, "big") + b"\x00" + b"\x01" * 64
    sof = b"\xff\xc0" + (11).to_bytes(2, "big") + \
        b"\x08" + (8).to_bytes(2, "big") + (8).to_bytes(2, "big") + \
        b"\x01" + b"\x01\x11\x00"
    dht_dc = b"\xff\xc4" + (19 + 1).to_bytes(2, "big") + b"\x00" + \
        b"\x01" + b"\x00" * 15 + b"\xff"
    dht_ac = b"\xff\xc4" + (19 + 1).to_bytes(2, "big") + b"\x10" + \
        b"\x01" + b"\x00" * 15 + b"\x00"
    sos = b"\xff\xda" + (8).to_bytes(2, "big") + b"\x01\x01\x00\x00\x3f\x00"
    scan = b"\x55" * 40
    return soi + dqt + sof + dht_dc + dht_ac + sos + scan + b"\xff\xd9"


def _child(body: str, data: bytes, timeout: int) -> str:
    """Run `body` in a fresh interpreter (a native crash or a hang fails
    the test, not the process), `data` on its stdin; returns its stdout."""
    r = subprocess.run([sys.executable, "-c", body % REPO], input=data,
                       capture_output=True, timeout=timeout)
    assert r.returncode == 0, (r.returncode, r.stderr.decode()[-800:])
    return r.stdout.decode()


def test_oversized_dc_category_no_crash():
    """The 255-bit DC category crashes neither codec: the port's host
    codec and device path end as the JAX package's does (a clean failure,
    or a round trip)."""
    data = _malicious_dc_category_jpeg()
    body = """
import sys
sys.path.insert(0, %r)
from lepton_tpu_torch import api, host
data = sys.stdin.buffer.read()
for name, enc, dec in (
        ("host", host.compress, host.decompress),
        ("device", lambda d: api.compress_device(d, device="cpu"),
         lambda b: api.decompress_device(b, device="cpu"))):
    try:
        lep = enc(data)
        print(name, "roundtrip" if dec(lep) == data else "mismatch")
    except Exception as e:
        print(name, "rejected", type(e).__name__)
"""
    out = _child(body, data, 120).split("\n")
    try:
        lep = japi.compress(data)
        want = "roundtrip" if japi.decompress(lep) == data else "mismatch"
    except Exception:
        want = "rejected"
    for line in filter(None, out):
        assert line.split()[1] == want, (line, want)


def test_truncated_progressive_eobrun_no_hang():
    """Cuts across a progressive container's coefficient region end, on the
    port's host codec and device path, as they end in the JAX package:
    a re-emit that cannot encode an EOB run errors out, never spins
    (tools/soak.py seed 7 case 6)."""
    from PIL import Image
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:31, 0:2]
    ch = np.clip(xx * 127 + yy * 8 + rng.normal(0, 24, (31, 2)),
                 0, 255).astype(np.uint8)
    arr = np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)], axis=-1)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=95,
                                     subsampling=0, progressive=True)
    data = buf.getvalue()
    lep = japi.compress(data, allow_progressive=True, max_threads=4)
    assert host.compress(data, allow_progressive=True, max_threads=4) == lep
    body = """
import hashlib, sys
sys.path.insert(0, %r)
from lepton_tpu_torch import api, host
lep = sys.stdin.buffer.read()
cuts = list(range(60, len(lep) - 8, 7))
blobs = [lep[:c] for c in cuts]
outs = api.batch_decompress_device(blobs, device="cpu", per_request=True)
for c, b, o in zip(cuts, blobs, outs):
    try:
        h = "bytes " + hashlib.sha1(host.decompress(b)).hexdigest()
    except Exception:
        h = "error"
    d = ("bytes " + hashlib.sha1(o).hexdigest() if isinstance(o, bytes)
         else "error")
    print(c, h, d)
print("terminated")
"""
    out = _child(body, lep, 240).split("\n")
    assert "terminated" in out
    for line in out:
        if not line or line == "terminated":
            continue
        cut, rest = line.split(" ", 1)
        try:
            want = "bytes " + hashlib.sha1(
                japi.decompress(lep[:int(cut)])).hexdigest()
        except Exception:
            want = "error"
        assert rest == f"{want} {want}", (cut, rest, want)


def test_oversubscribed_dht_no_crash():
    """A DHT that oversubscribes the code space leaves dead paths in the
    port's Huffman table and its C LUT fill, as in the JAX package's
    (tools/soak.py seed 11 case 132)."""
    from lepton_tpu.jpeg.huffman import HuffCodes as JHuffCodes
    counts = bytes([5] + [0] * 15)
    values = bytes([0, 1, 2, 3, 4])
    hc, jhc = HuffCodes(counts, values), JHuffCodes(counts, values)
    assert hc.valid and jhc.valid
    for k in HuffCodes.__slots__:
        assert np.array_equal(np.asarray(getattr(hc, k)),
                              np.asarray(getattr(jhc, k))), k
    body = """
import sys, ctypes
sys.path.insert(0, %r)
from lepton_tpu_torch._native import get_lib
lib = get_lib()
buf = ctypes.create_string_buffer(lib.lepton_huff_table_size())
lib.lepton_build_huff(buf, bytes([5] + [0] * 15), bytes(range(255)), 5)
lib.lepton_build_huff(buf, bytes([0] * 15 + [255]), bytes(range(255)), 255)
print("ok")
"""
    assert "ok" in _child(body, b"", 300)


def test_header_truncation_rejected_scan_truncation_accepted():
    """An EOF inside a header segment is refused (UNSUPPORTED_JPEG) by the
    port's host codec and device path as by the JAX package; a mid-scan
    cut keeps the early-EOF contract on both, with the JAX package's
    bytes (tools/soak.py seed 23)."""
    data = _jpeg()
    scan_start = parse_jpeg(data).huff_input_offsets[0][1]
    for cut in (scan_start - 40, scan_start - 5, scan_start - 1):
        want = _joutcome(japi.compress, data[:cut])
        assert want == ("error", ExitCode.UNSUPPORTED_JPEG), cut
        assert _outcome(host.compress, data[:cut]) == want
        assert _outcome(api.compress_device, data[:cut], device="cpu") \
            == want
    cuts = (scan_start + 100, len(data) - 50)
    truncs = [data[:cut] for cut in cuts]
    leps = api.batch_compress_device(truncs, num_segments=8, device="cpu")
    for trunc, lep in zip(truncs, leps):
        assert lep == japi.compress(trunc) == host.compress(trunc)
        assert host.decompress(lep) == trunc
    assert api.batch_decompress_device(leps, device="cpu") == truncs


def test_truncated_progressive_rst_every_cut():
    """Every cut of a progressive+RST JPEG with optimized tables (half the
    file on) encodes or is refused as in the JAX package, with its bytes,
    and each .lep gives the exact truncated bytes back on the host and
    the device path (tools/soak.py seed 202 case 290)."""
    from PIL import Image
    nrng = np.random.default_rng(12345)
    h, w = 16, 15
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 255 / w + yy * 255 / h) / 2
    ch = np.clip(base + nrng.normal(0, 30, size=(h, w)), 0,
                 255).astype(np.uint8)
    arr = np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)], axis=-1)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(
        buf, "JPEG", quality=95, subsampling=1, progressive=True,
        restart_marker_blocks=7)
    data = buf.getvalue()
    kw = dict(max_threads=2, allow_progressive=True)
    good, leps = [], []
    for cut in range(len(data) // 2, len(data), 7):
        trunc = data[:cut]
        want = _joutcome(japi.compress, trunc, **kw)
        assert _outcome(host.compress, trunc, **kw) == want, cut
        if want[0] == "error":
            assert _outcome(api.compress_device, trunc, num_segments=2,
                            allow_progressive=True, device="cpu") == want
            continue
        good.append(trunc)
        leps.append(want[1])
    assert good
    assert api.batch_compress_device(good, num_segments=2, device="cpu",
                                     allow_progressive=True) == leps
    for trunc, lep in zip(good, leps):
        assert japi.decompress(lep) == host.decompress(lep) == trunc
    assert api.batch_decompress_device(leps, device="cpu") == good


def test_soak_matches_jax():
    """soak.run at 48 px a side on the CPU: no failed check, and every
    case's .lep is the JAX package's compress on the same settings, which
    decodes it back; each hostile variant decodes on the JAX package's
    host codec as on the port's (the soak held the device path to the
    port's)."""
    report = soak.run(6, 0, "cpu", out=None, max_side=48)
    assert report.failed == 0, report.failures
    assert report.cases == 6 and set(report.leps) == set(range(6))
    assert report.counts["ok"] > 0
    for i, lep in sorted(report.leps.items()):
        case = soak.Case(0, i, 48)
        assert japi.compress(case.jpeg, **case.host_kw()) == lep
        assert japi.decompress(lep) == case.jpeg
        for check, blob, _ in soak._hostile_variants(case, lep):
            assert _outcome(host.decompress, blob) == _joutcome(
                japi.decompress, blob), (i, check)


def _ci(c):
    return 0 if c == 0 else 1


@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_hostile_reader_batch_matches_jax(coder):
    """The tiny hostile batch of a container's own streams (lane 1 empty,
    lane 3 cut mid-block): the plain reader's planes and flags equal
    decode_segments_tpu's; both tiny batches equal the host's C segment
    decoder lane by lane (soak.host_diffs)."""
    pairs = soak.hostile_requests(coder)
    plan = vpx_decoder.plan_decode([r for _, r in pairs], coder)
    coef, err = (t.numpy() for t in vpx_decoder.decode_lanes(
        **plan.to("cpu")))
    assert soak.host_diffs(plan, pairs, coef, err) == []
    _, own = pairs[1]
    planes, bad = vpx_decoder.split_planes(plan, coef, err != 0)[1]
    want, werr = decode_segments_tpu(*[own[k] for k in (
        "streams", "plane_shapes", "color_tables", "mcuv",
        "max_coded_heights", "component_sizes", "splits_y")],
        color_index=_ci, coder=coder)
    assert np.array_equal(bad, np.asarray(werr))
    for p, w in zip(planes, want):
        assert np.array_equal(p, np.asarray(w))


def test_hostile_readers_on_cpu():
    """soak.hostile_readers with device="cpu" runs its whole course: the
    plain reader against itself and the host's C segment decoder, tiny
    and wide batches (two soak containers), and a good file after."""
    leps = [host.compress(soak.Case(0, i, 32).jpeg,
                          **soak.Case(0, i, 32).host_kw()) for i in (0, 2)]
    out = soak.hostile_readers("cpu", leps)
    for coder in ("vpx", "ans"):
        assert out[coder]["tiny_lanes"] == 8
        assert 1 <= out[coder]["tiny_flagged"] < 8


@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_hostile_coder_lanes_match_jax(coder):
    """The hostile coder lanes (a long lane of heavy reuse, an empty lane,
    one symbol, one branch throughout), 64 of them: the port's coder
    streams equal the JAX package's (vpx_scan's two-pass VPX coder and
    its rANS pass)."""
    segments = soak.hostile_segments(64, 200)
    idx, bit, nsyms = (torch.as_tensor(a) for a in soak.coder_lanes(
        segments, coder == "vpx"))
    jidx, jbit = jnp.asarray(idx.numpy()), jnp.asarray(bit.numpy())
    if coder == "vpx":
        got = vpx_coder.finalize(*vpx_coder.encode_streams(idx, bit))
        want = vpx_scan.finalize_streams(*vpx_scan.encode_streams_twopass(
            jidx, jbit, 4))
    else:
        got = ans_coder.finalize_ans(*ans_coder.encode_streams_ans(
            idx, bit, nsyms))
        probs = vpx_scan.model_probs_sorted(jidx, jbit, 4, update="adv")
        want = vpx_scan.finalize_ans_streams(*vpx_scan.ans_pass(
            probs.astype(jnp.int32), jbit, jnp.asarray(nsyms.numpy()), 4))
    assert got == want


@pytest.mark.parametrize("version", [1, 3])
def test_coefficient_range_as_the_host_codec(version):
    """Coefficient planes past legal baseline: an 11-bit AC coefficient
    (the host's C segment coder codes all 10 of its residual bits; the
    JAX package's device slab keeps 9) encodes on the device path to the
    host codec's stream and decodes back; a 12-bit one is refused on both,
    as COEFFICIENT_OUT_OF_RANGE."""
    from lepton_tpu_torch.kernels import batch_encode
    data = chip_smoke.make_photo(chip_smoke.SEED + 71, 32, 16)
    _, info, dec = api._parse(data)
    desc = api._describe(info, dec, dec.handoffs[:1])
    bcv = info.cmpnfo[0].bcv
    heights, sizes = host._truncation_geometry(info, dec)
    for value, ok in ((1500, True), (-2047, True), (2048, False)):
        planes = [p.copy() for p in dec.planes]
        planes[0][1, 2, 9] = value          # an interior coefficient
        planes[0][0, 1, 3] = -value         # a horizontal edge
        img = host._native_image(info, planes, heights, sizes)
        enc = img.encode_segment_ans if version == 3 else img.encode_segment
        if not ok:
            with pytest.raises(ValueError, match="coefficient out of range"):
                enc(0, bcv, True)
            with pytest.raises(host.LeptonError, match="out of range") as e:
                batch_encode.encode_images_device([dict(desc, planes=planes)],
                                                  version, device="cpu")
            assert classify(e.value) == ExitCode.COEFFICIENT_OUT_OF_RANGE
            continue
        want = enc(0, bcv, True)
        got = batch_encode.encode_images_device([dict(desc, planes=planes)],
                                                version, device="cpu")[0]
        assert got == [want], value
        req = dict(api._decode_request(api.compress_device(
            data, num_segments=1, version=version, device="cpu"))[0],
                   streams=got)
        plan = vpx_decoder.plan_decode([req], "ans" if version == 3
                                       else "vpx")
        coef, err = vpx_decoder.decode_lanes(**plan.to("cpu"))
        back, bad = vpx_decoder.split_planes(plan, coef.numpy(),
                                             err.numpy() != 0)[0]
        assert not bad.any()
        for p, w in zip(back, planes):
            assert np.array_equal(p, w)
