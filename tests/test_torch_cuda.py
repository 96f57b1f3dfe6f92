"""The port on a CUDA card: the VPX and ANS coder kernels and the decoder
kernel (both readers) against their plain versions, the roofline probe
against its plain loop, and the whole encode and decode, containers v1 to
v3, on cuda against the same on the CPU.

This file imports no JAX, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips.  Streams, planes and JPEGs are compared
byte for byte: the tolerance is zero.
"""
import io

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from lepton_tpu_torch import api
from lepton_tpu_torch.kernels import ans_coder, vpx_coder, vpx_decoder
from lepton_tpu_torch.model.tables import ARENA_SIZE, arena_from_template
from lepton_tpu_torch.probes import decode_roofline


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
    before = vpx_coder.encode_streams.launches
    assert (_streams(idxs, bits, template, cuda)
            == _streams(idxs, bits, template, "cpu"))
    assert vpx_coder.encode_streams.launches > before


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
    before = ans_coder.encode_streams_ans.launches
    assert (_ans_streams(lanes, template, cuda)
            == _ans_streams(lanes, template, "cpu"))
    assert ans_coder.encode_streams_ans.launches > before


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
    version made to raise: the CUDA path launches the kernels only."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")
    for mod, name in ((vpx_coder, "encode_streams_plain"),
                      (ans_coder, "encode_streams_ans_plain"),
                      (vpx_decoder, "decode_lanes_plain")):
        monkeypatch.setattr(mod, name, boom)
    data = chip_smoke.make_photo(6, 96, 64)
    leps = [api.compress_device(data, num_segments=2, version=v)
            for v in (1, 2, 3)]
    assert api.batch_decompress_device(leps) == [data] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind,K,shared", [
    ("rmw", 1, False), ("rmw", 8, False), ("rmw", 4, True), ("alu", 1, False),
    ("mixed", 1, False), ("mixed", 1, True)])
def test_roofline_probe_matches_plain(cuda, kind, K, shared):
    got = decode_roofline.probe(kind, 3000, K, shared, cuda)
    assert int(got) == decode_roofline.probe_plain(kind, 3000, K, shared)
