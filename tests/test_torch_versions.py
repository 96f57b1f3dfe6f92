"""Containers v2 and v3 written by the port on the CPU against the JAX
package, on the geometries of tests/test_torch_encode.py that the rANS
lanes and the brotli header could treat differently: 4:2:0 at odd sizes,
4:4:4, grey, restart markers, an early-EOF cut, and a trained template.

compress_device(version=v, device="cpu") runs the plain versions of the
kernels (the ANS coder for v3); its bytes must equal
lepton_tpu.api.compress_tpu, and the port's encode at the host's segment
count must equal the host compress(version=v), byte for byte; every file
decodes back to its JPEG.  Each compress_tpu compiles once per geometry
(tens of seconds here), so these cases have a file of their own.
"""
import pytest

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu_torch import api, host  # noqa: E402
from lepton_tpu_torch.container.handoff import (choose_num_threads,  # noqa: E402,E501
                                                select_splits)
from lepton_tpu_torch.kernels import batch_encode  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


def _port_in_segments(data: bytes, k: int, version: int) -> bytes:
    """The port's container with compress(min_threads=k)'s segmentation."""
    parsed, info, dec = api._parse(data)
    h = dec.handoffs
    nt = choose_num_threads(len(h), h[-1].segment_size - h[0].segment_size,
                            k, k)
    splits = select_splits(h, nt)
    streams = batch_encode.encode_images_device(
        [api._describe(info, dec, splits)], version,
        template=host._model_template_packed(), device="cpu")[0]
    return api._container(parsed, dec, splits, nt, streams, version)


VERSION_CASES = [
    ("odd_dims", 37, 21, "RGB", dict(quality=80, subsampling=2), 1, 1.0),
    ("444_q95", 40, 24, "RGB", dict(quality=95, subsampling=0), 1, 1.0),
    ("gray", 33, 17, "L", dict(quality=85), 1, 1.0),
    ("restart_markers", 48, 48, "RGB",
     dict(quality=80, restart_marker_blocks=4, subsampling=2), 3, 1.0),
    ("early_eof", 64, 64, "RGB", dict(quality=80, subsampling=2), 1, 0.6),
]


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("name,w,h,mode,kw,k,cut", VERSION_CASES,
                         ids=[c[0] for c in VERSION_CASES])
def test_compress_versions_match_jax(name, w, h, mode, kw, k, cut, version):
    """v2 and v3 bytes: compress_device == compress_tpu, and the port at
    the host's segment count == the host compress; both decode back."""
    data = _jpeg(w, h, seed=len(name), mode=mode, **kw)
    data = data[:int(len(data) * cut)]
    lep = api.compress_device(data, device="cpu", version=version)
    assert lep[2] == version
    assert lep == japi.compress_tpu(data, version=version)
    host = japi.compress(data, max_threads=k, min_threads=k, version=version)
    port = _port_in_segments(data, k, version)
    assert port == host
    assert api.decompress_device(lep, device="cpu") == data
    if port != lep:
        assert api.decompress_device(port, device="cpu") == data


@pytest.mark.parametrize("version", [2, 3])
def test_template_versions_match_host(version, synth_model, monkeypatch):
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    monkeypatch.delenv("LEPTON_COMPRESSION_MODEL_OUT", raising=False)
    data = _jpeg(48, 32, seed=5, quality=85, subsampling=2)
    ref = japi.compress(data, max_threads=2, min_threads=2, version=version)
    assert _port_in_segments(data, 2, version) == ref
    assert api.decompress_device(ref, device="cpu") == data
