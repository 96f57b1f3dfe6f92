"""The port's whole encode slice on the CPU against the JAX package.

compress_device / batch_compress_device with device="cpu" run the plain
PyTorch versions of the kernels; their .lep bytes must equal
lepton_tpu.api.compress_tpu and the host encoder lepton_tpu.api.compress
byte for byte.  Inputs are PIL-made JPEGs from numpy seeds.
"""
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.jpeg.decoder import decode_scans as jdecode  # noqa: E402
from lepton_tpu.jpeg.imageinfo import image_info_from_header as jinfo  # noqa: E402,E501
from lepton_tpu.jpeg.parser import parse_jpeg as jparse  # noqa: E402
from lepton_tpu.kernels import batch_encode as jbatch  # noqa: E402
from lepton_tpu.model.context import ColorTables as JColorTables  # noqa: E402
from lepton_tpu_torch import api, host  # noqa: E402
from lepton_tpu_torch.container.handoff import (choose_num_threads,  # noqa: E402,E501
                                                select_splits)
from lepton_tpu_torch.jpeg.decoder import decode_scans  # noqa: E402
from lepton_tpu_torch.kernels import batch_encode  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(w, h, seed=0, mode="RGB", **kw) -> bytes:
    """A smooth gradient plus noise, saved by PIL (as
    tests/test_synthetic_corpus.py makes its corpus)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 255 / max(w, 1) + yy * 255 / max(h, 1)) / 2
    ch = np.clip(base + rng.normal(0, 24, size=(h, w)), 0, 255)
    ch = ch.astype(np.uint8)
    if mode == "L":
        img = Image.fromarray(ch, "L")
    else:
        img = Image.fromarray(np.stack(
            [ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)], axis=-1), "RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _port_with_segments(data: bytes, k: int, version: int = 1,
                        allow_progressive: bool = False) -> bytes:
    """The port's container with compress(min_threads=k)'s segmentation."""
    parsed, info, dec = api._parse(data, allow_progressive)
    h = dec.handoffs
    nt = choose_num_threads(len(h), h[-1].segment_size - h[0].segment_size,
                            k, k)
    splits = select_splits(h, nt)
    streams = batch_encode.encode_images_device(
        [api._describe(info, dec, splits)], version,
        template=host._model_template_packed(), device="cpu")[0]
    return api._container(parsed, dec, splits, nt, streams, version)


def test_compress_device_matches_compress_tpu():
    """Against the JAX device pipeline: compress_tpu on a small 4:2:0
    image (one segment: choose_num_threads keeps a small scan whole), and
    its batch encoder with four segments."""
    data = _jpeg(64, 64, seed=1, quality=80, subsampling=2)
    assert api.compress_device(data, num_segments=4, device="cpu") \
        == japi.compress_tpu(data, num_segments=4)

    parsed = jparse(data)
    info = jinfo(parsed.hdrdata)
    dec = jdecode(parsed, info)
    mh, cs = japi._truncation_geometry(info, dec)
    desc = dict(planes=list(dec.planes),
                color_tables=[JColorTables(info.qtables[
                    info.cmpnfo[c].qtable_index]) for c in range(info.cmpc)],
                mcuv=info.mcuv, max_coded_heights=mh, component_sizes=cs,
                splits_y=[0, 2, 4, 6],
                color_index=(lambda c: 0 if c == 0 else 1))
    ref = jbatch.encode_images_device([desc])[0]
    port = batch_encode.encode_images_device([desc], device="cpu")[0]
    assert len(port) == 4 and port == ref


CASES = [
    ("444_q95", 40, 24, "RGB", dict(quality=95, subsampling=0), 1),
    ("420_q75", 64, 48, "RGB", dict(quality=75, subsampling=2), 1),
    ("422_q50", 48, 32, "RGB", dict(quality=50, subsampling=1), 2),
    ("gray", 33, 17, "L", dict(quality=85), 1),
    ("odd_dims", 37, 21, "RGB", dict(quality=80, subsampling=2), 1),
    ("restart_markers", 48, 48, "RGB",
     dict(quality=80, restart_marker_blocks=4, subsampling=2), 3),
    ("optimized_huffman", 64, 32, "RGB",
     dict(quality=90, optimize=True, subsampling=2), 2),
    ("four_segments", 64, 64, "RGB", dict(quality=70, subsampling=2), 4),
    ("gray_segments", 24, 40, "L", dict(quality=90), 4),
]


@pytest.mark.parametrize("name,w,h,mode,kw,k", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_host_compress(name, w, h, mode, kw, k):
    data = _jpeg(w, h, seed=len(name), mode=mode, **kw)
    ref = japi.compress(data, max_threads=k, min_threads=k)
    assert _port_with_segments(data, k) == ref
    if k == 1:
        assert api.compress_device(data, device="cpu") == ref


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_scan_decode_matches_jax(use_native):
    """The port's Huffman scan decode, in the native library and in the
    Python loop, gives the JAX package's planes and thread handoffs."""
    data = _jpeg(48, 40, seed=8, quality=80, restart_marker_blocks=3,
                 subsampling=2)
    parsed, info, dec = api._parse(data)
    if not use_native:
        dec = decode_scans(parsed, info, use_native=False)
    jparsed = jparse(data)
    ref = jdecode(jparsed, jinfo(jparsed.hdrdata))
    assert len(dec.planes) == len(ref.planes) == 3
    for a, b in zip(dec.planes, ref.planes):
        assert np.array_equal(a, b)
    assert [vars(h) for h in dec.handoffs] == [vars(h) for h in ref.handoffs]
    assert (dec.padbit, dec.max_dpos) == (ref.padbit, ref.max_dpos)


def test_trained_model_template(synth_model, monkeypatch):
    """LEPTON_COMPRESSION_MODEL: every segment starts from the trained
    model, as the host encoder's do."""
    data = _jpeg(48, 32, seed=5, quality=85, subsampling=2)
    plain = api.compress_device(data, device="cpu")
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    ref = japi.compress(data)
    assert api.compress_device(data, device="cpu") == ref
    assert ref != plain
    assert _port_with_segments(data, 2) \
        == japi.compress(data, max_threads=2, min_threads=2)


def test_batch_equals_single():
    blobs = [_jpeg(40, 32, seed=s, quality=q, subsampling=sub)
             for s, q, sub in ((1, 90, 2), (2, 60, 0))]
    blobs.append(_jpeg(24, 16, seed=3, mode="L", quality=75))
    stats = {}
    leps = api.batch_compress_device(blobs, device="cpu", stats=stats)
    assert leps == [api.compress_device(b, device="cpu") for b in blobs]
    assert stats["lanes"] == len(blobs)


def test_progressive_is_refused():
    data = _jpeg(32, 32, seed=4, quality=80, progressive=True)
    with pytest.raises(api.UnsupportedJpeg):
        api.compress_device(data, device="cpu")


def test_runs_on_cuda_or_raises(monkeypatch):
    """device=None means the card: without CUDA it raises, never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _jpeg(16, 16, seed=6, quality=80)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compress_device(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.batch_compress_device([data], device="cuda")


def _port_sources():
    root = os.path.join(REPO, "lepton_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_no_lepton_tpu():
    bad = re.compile(r"^\s*(import|from)\s+(jax|lepton_tpu)(\.|\s|$)", re.M)
    for path in _port_sources():
        src = open(path).read()
        assert not bad.search(src), path
    code = ("import sys, lepton_tpu_torch.api, lepton_tpu_torch.kernels."
            "vpx_coder, lepton_tpu_torch.jpeg.progressive, "
            "lepton_tpu_torch.jpeg.recode_progressive, lepton_tpu_torch.cli, "
            "lepton_tpu_torch.serve; mods = [m for m in "
            "sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == 'lepton_tpu']; "
            "print(mods); assert not mods")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
