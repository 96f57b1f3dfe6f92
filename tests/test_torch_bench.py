"""The port's bench runner (lepton_tpu_torch/bench.py) on the CPU.

`python -m lepton_tpu_torch.bench --device cpu` at a small size (two
32x24 photos, a knee of 4 images of 32 px asking for 2 segments, one warm
run) runs every section through the kernels' plain versions.  Its last
line parses, has every section and says ok; every .lep a section makes is
held by the runner to the port's host.compress, which is held here to the
JAX package's compress on the same inputs.  A host.compress that returns
other bytes makes run raise GateError and main print no line; device=None
without a card raises; importing the runner loads neither JAX nor the JAX
package.  About 40 s on a CPU.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu_torch import bench, host  # noqa: E402

ARGS = ["--device", "cpu", "--runs", "1", "--photos", "2", "--photo-size",
        "32", "24", "--knee-images", "4", "--knee-side", "32",
        "--knee-segments", "2"]
SECTIONS = ("host", "host_v3", "symbolize", "encode_latency",
            "decode_latency", "batch_encode", "coder", "batch_decode",
            "knee", "mesh", "serving")


@pytest.fixture(scope="module")
def line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(ARGS) == 0
    return out.getvalue().splitlines()[-1]


def test_line_has_every_section(line):
    res = json.loads(line)
    assert res["ok"] is True and res["device"] == "cpu" and res["runs"] == 1
    assert res["card"] == {"name": "cpu", "power_limit": None, "count": 0}
    for name in SECTIONS:
        assert name in res, name
    for v in ("v1", "v3"):
        for name, metric in (("encode_latency", "encode_latency_s"),
                             ("decode_latency", "decode_latency_s"),
                             ("batch_encode", "encode_mbps"),
                             ("batch_decode", "decode_mbps")):
            s = res[name][v][metric]
            assert 0 < s["min"] <= s["median"] <= s["max"], (name, v)
        assert res["batch_encode"][v]["ratio"] > 0
        assert res["coder"][v]["lanes"] == 2
    knee = res["knee"]["sweep"]["4"]
    assert knee["lanes"] == 4 and knee["decode"]["longest_lane"]["blocks"] > 0
    assert res["serving"]["wave_fill"] and res["serving"]["requests"] == 4
    assert res["mesh"]["mesh_devices"] == 1


def test_host_bytes_equal_jax(line):
    """The runner holds every section's .lep to host.compress (v1 and v3,
    16 segments; the server's 8; the knee's 2): those equal the JAX
    package's compress on the same inputs."""
    photos = bench.photos(2, (32, 24))
    for b in photos:
        for version in (1, 3):
            assert host.compress(b, max_threads=16, version=version) == \
                japi.compress(b, max_threads=16, version=version)
        assert host.compress(b, max_threads=8) == \
            japi.compress(b, max_threads=8)
        assert japi.decompress(japi.compress(b, max_threads=16)) == b
    for b in bench.knee_corpus(4, 32):
        assert host.compress(b, max_threads=2) == \
            japi.compress(b, max_threads=2)


def test_knee_corpus_equals_bench_py(monkeypatch):
    """knee_corpus is bench.py's _gen_knee_corpus, image for image (its
    disk cache kept out: no cache is found and none is written)."""
    spec = importlib.util.spec_from_file_location(
        "jax_era_bench", os.path.join(bench.ROOT, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)

    def no_dirs(*args, **kw):
        raise OSError("no cache")

    monkeypatch.setattr(os.path, "isdir", lambda path: False)
    monkeypatch.setattr(os, "makedirs", no_dirs)
    assert jbench._gen_knee_corpus(3, 64) == bench.knee_corpus(3, 64)


def test_gate_raises_without_a_line(monkeypatch, capsys):
    """host.compress giving other bytes: the host section's round trip
    fails its gate, run raises and main prints no line."""
    real = host.compress
    other = bench.make_photo(1, 16, 16)
    monkeypatch.setattr(host, "compress",
                        lambda data, **kw: real(other, **kw))
    with pytest.raises(bench.GateError, match="host"):
        bench.run("cpu", 1, n_photos=2, photo_size=(32, 24))
    with pytest.raises(bench.GateError):
        bench.main(ARGS)
    assert "{" not in capsys.readouterr().out


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, lepton_tpu_torch.bench; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lepton_tpu.')) or m == 'lepton_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=bench.ROOT, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
