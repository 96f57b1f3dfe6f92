"""The port's decode entry points on the CPU: legacy containers, batches,
early-EOF truncation, v2 and v3 containers, and the containers the device
path refuses.

decompress_device / batch_decompress_device with device="cpu" run the
plain PyTorch version of the decode kernel; they must give back the
original JPEG bytes, as the JAX package's host decompress does.  The
cases of tests/test_torch_encode.py are decoded in
tests/test_torch_decode_cases.py, mode-X and 4-colour containers in
tests/test_torch_progressive.py.  Inputs are PIL-made JPEGs from numpy
seeds.
"""
import zlib

import pytest
import torch

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.container.format import read_container as jread  # noqa: E402
from lepton_tpu_torch import api  # noqa: E402
from lepton_tpu_torch.container import brotli_ffi  # noqa: E402
from lepton_tpu_torch.container.format import (  # noqa: E402
    ContainerError, build_header_block, read_container, write_container)
from lepton_tpu_torch.container.mux import MuxReader, mux_streams  # noqa: E402
from lepton_tpu_torch.kernels import vpx_decoder  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


def _legacy(lep: bytes) -> bytes:
    """The same container as a legacy file: no 'H' record in the header;
    instead a mark byte (the segment count) and the LE16 luma splits of
    segments 1.. precede the mux streams (api._decode_request)."""
    hdr, mux = read_container(lep)
    splits = [th.luma_y_start for th in hdr.handoffs]
    n = len(splits)
    block = build_header_block(hdr)
    rec = b"HH" + bytes([n])
    at = block.index(rec, 7 + len(hdr.hdrdata))
    block = block[:at] + block[at + len(rec) + 16 * n:]
    region = bytes([n]) + b"".join(y.to_bytes(2, "little")
                                   for y in splits[1:]) + mux
    head = bytearray(lep[:24])
    comp = zlib.compress(block, 9)
    head += len(comp).to_bytes(4, "little") + comp + b"CMP" + region
    return bytes(head + (len(head) + 4).to_bytes(4, "little"))


def test_legacy_container():
    data = _jpeg(48, 32, seed=21, quality=80, subsampling=2)
    leg = _legacy(japi.compress(data, max_threads=2, min_threads=2))
    assert read_container(leg)[0].handoffs == []
    assert japi.decompress(leg) == data
    assert api.decompress_device(leg, device="cpu") == data


def test_batch_equals_single():
    blobs = [_jpeg(40, 32, seed=s, quality=q, subsampling=sub)
             for s, q, sub in ((1, 90, 2), (2, 60, 0))]
    blobs.append(_jpeg(24, 16, seed=3, mode="L", quality=75))
    leps = [japi.compress(b, max_threads=k, min_threads=k)
            for b, k in zip(blobs, (2, 1, 1))]
    stats = {}
    outs = api.batch_decompress_device(leps, device="cpu", stats=stats)
    assert outs == blobs
    assert outs == [api.decompress_device(lep, device="cpu") for lep in leps]
    assert stats["lanes"] == 4 and stats["max_lane_blocks"] > 0


@pytest.mark.parametrize("cut", [0.6, 0.8])
def test_early_eof_truncation(cut):
    """A JPEG cut short: the port encodes it to the host compress bytes and
    decodes it back to the cut bytes."""
    data = _jpeg(64, 64, seed=3, quality=80, subsampling=2)
    short = data[:int(len(data) * cut)]
    lep = api.compress_device(short, device="cpu")
    assert lep == japi.compress(short)
    assert read_container(lep)[0].early_eof
    assert api.decompress_device(lep, device="cpu") == short


def _corrupt(lep: bytes) -> bytes:
    """Every stream byte set to 0xFF: the first 7x7 count reads 63."""
    hdr, mux = read_container(lep)
    streams = [bytes(b) for b in MuxReader(mux).buffers if b]
    return write_container(hdr, mux_streams([b"\xff" * len(s)
                                             for s in streams]))


@pytest.mark.parametrize("kind", ["mode_y", "v2", "v3", "corrupt"])
def test_unsupported_raises(kind, monkeypatch):
    """Each request the device path does not cover raises LeptonError
    naming it; v2 and v3 containers raise so only where the brotli
    libraries cannot be loaded (nothing falls back to zlib)."""
    data = _jpeg(32, 32, seed=4, quality=80, subsampling=2)
    if kind == "mode_y":
        lep, reason = japi.generic_compress(b"not a jpeg"), "mode-Y"
    elif kind in ("v2", "v3"):
        lep = japi.compress(data, version=int(kind[1]))
        reason = f"{kind} needs brotli"
        monkeypatch.setattr(brotli_ffi, "available", lambda: False)
    else:
        lep, reason = _corrupt(japi.compress(data)), "inconsistent"
        plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]])
        assert vpx_decoder.decode_lanes(**plan.to("cpu"))[1].all()
    good = japi.compress(data)
    with pytest.raises(api.LeptonError, match=f"request 1: .*{reason}"):
        api.batch_decompress_device([good, lep], device="cpu")


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("source", ["host", "port"])
def test_versions_round_trip(version, source):
    """v2 (VPX lanes, brotli header) and v3 (rANS lanes, brotli header)
    files from the host compress and from compress_device decode back to
    the original JPEG; the header fields read as the JAX package reads
    them."""
    data = _jpeg(48, 32, seed=12, quality=85, subsampling=2)
    if source == "host":
        lep = japi.compress(data, max_threads=2, min_threads=2,
                            version=version)
    else:
        lep = api.compress_device(data, device="cpu", version=version)
    hdr, mux = read_container(lep)
    jhdr, jmux = jread(lep)
    assert hdr.version == version and mux == jmux
    assert hdr.hdrdata == jhdr.hdrdata and hdr.padbit == jhdr.padbit
    assert api.decompress_device(lep, device="cpu") == data


def test_brotli_missing_refuses_to_write(monkeypatch):
    """Without the brotli libraries a v2+ header raises ContainerError; v1
    (zlib) is unaffected."""
    data = _jpeg(16, 16, seed=7, quality=80)
    monkeypatch.setattr(brotli_ffi, "available", lambda: False)
    with pytest.raises(ContainerError, match="brotli"):
        api.compress_device(data, device="cpu", version=3)
    assert api.compress_device(data, device="cpu") == japi.compress(data)


def test_runs_on_cuda_or_raises(monkeypatch):
    """device=None means the card: without CUDA it raises, never falls back
    to the CPU."""
    lep = japi.compress(_jpeg(16, 16, seed=6, quality=80))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.decompress_device(lep)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.batch_decompress_device([lep], device="cuda")
