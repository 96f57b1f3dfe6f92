"""The port's sanitizer twin and its two small twins, on the CPU.

- _native's LEPTONC_TORCH_SO override (loaded as it is, never rebuilt);
- sanitize.py's host half: its ASan+UBSan runner fails on a real heap
  overflow and is clean on one host-codec round trip;
- kernels/cuda_build.py's checked variant (names, paths, flags, check
  sites, the error), without nvcc;
- print_model.py against tools/print_model.py, and bulk_recompress.py
  against examples/bulk_recompress.py.
The checked kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py phase 19).
"""
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from lepton_tpu_torch import _native, bulk_recompress, host, print_model
from lepton_tpu_torch import sanitize
from lepton_tpu_torch.kernels import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(w, h, seed, quality=90):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    ((xx + yy) * 127 // max(w + h - 2, 1))], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _run(cmd, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw.pop("env", {}))
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


# ---------------------------------------------------------------------------
# (a) the library override
# ---------------------------------------------------------------------------


def test_override_is_loaded_and_never_rebuilt(tmp_path):
    """LEPTONC_TORCH_SO: the named file is loaded as it is, even when it
    is older than leptonc.c, and the default library is not built; the
    check runs in a subprocess, so this process's library stays its own."""
    _native.get_lib()
    so = tmp_path / "libleptonc_copy.so"
    shutil.copy(_native._SO, so)
    os.utime(so, (0, 0))
    before = os.path.getmtime(_native._SO)
    r = _run([sys.executable, "-c",
              "from lepton_tpu_torch import _native\n"
              "lib = _native.get_lib()\n"
              "print(lib._name, lib.lepton_arena_size())"],
             env={_native.SO_ENV: str(so)})
    assert r.returncode == 0, r.stderr
    name, size = r.stdout.split()
    from lepton_tpu_torch.model.tables import ARENA_SIZE
    assert (name, int(size)) == (str(so), ARENA_SIZE)
    assert os.path.getmtime(so) == 0
    assert os.path.getmtime(_native._SO) == before


# ---------------------------------------------------------------------------
# (b), (c) the host half
# ---------------------------------------------------------------------------

OVERFLOW_C = """#include <stdlib.h>

int overflow(int n) {
    char *p = malloc(n);
    for (int i = 0; i <= n; ++i) p[i] = (char)i;  /* one past the end */
    int first = p[0];
    free(p);
    return first;
}
"""


def test_host_runner_catches_a_heap_overflow(tmp_path):
    """The runner is no no-op: a heap overflow built by build_sanitized
    with the same flags and called under the same LD_PRELOAD ends its
    process non-zero with ASan's report."""
    src = tmp_path / "overflow.c"
    src.write_text(OVERFLOW_C)
    so = sanitize.build_sanitized(str(src), str(tmp_path / "overflow.so"))
    r = sanitize.run_sanitized(
        [sys.executable, "-c",
         f"import ctypes; ctypes.CDLL({so!r}).overflow(16)"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "heap-buffer-overflow" in r.stderr


def test_sanitize_host_is_clean_on_one_round_trip(capsys):
    """python -m lepton_tpu_torch.sanitize host, restricted to one host
    codec round trip held to the JAX package, builds the ASan+UBSan
    library and reports clean."""
    rc = sanitize.main(["host", "--tests",
                        "tests/test_torch_host_codec.py::"
                        "test_compress_decompress_match_jax[baseline_v1]",
                        "--soak", "0"])
    assert rc == 0
    assert sanitize.CLEAN in capsys.readouterr().out
    assert os.path.exists(sanitize.ASAN_SO)


# ---------------------------------------------------------------------------
# (d) the checked variant of the CUDA builds
# ---------------------------------------------------------------------------


def test_checked_variant_names_paths_and_flags(monkeypatch):
    """The checked build's library stem, .so path and nvcc flags; the
    default build's flags are exactly what they were."""
    assert cuda_build.NVCC_FLAGS == [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    monkeypatch.delenv(cuda_build.CHECKED_ENV, raising=False)
    assert not cuda_build.checked()
    assert cuda_build.variant("vpx_decoder") == "vpx_decoder"
    assert cuda_build.so_path("vpx_decoder").endswith(
        "build/libvpx_decoder.so")
    assert cuda_build.nvcc_flags() == cuda_build.NVCC_FLAGS
    monkeypatch.setenv(cuda_build.CHECKED_ENV, "1")
    assert cuda_build.checked()
    assert cuda_build.variant("vpx_decoder") == "vpx_decoder_checked"
    assert cuda_build.so_path("vpx_decoder").endswith(
        "build/libvpx_decoder_checked.so")
    assert cuda_build.so_path("vpx_decoder", False).endswith(
        "build/libvpx_decoder.so")
    flags = cuda_build.nvcc_flags()
    assert flags[:len(cuda_build.NVCC_FLAGS)] == cuda_build.NVCC_FLAGS
    assert "-DLEPTON_CHECKED" in flags and "-lineinfo" in flags
    assert cuda_build.nvcc_flags(False) == cuda_build.NVCC_FLAGS


@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_every_source_has_one_line_check_sites(name):
    """Each source includes csrc/checked.cuh and has check sites, each
    LEP_CHECK / LEP_OK call on one line (the device records __LINE__)."""
    text = open(cuda_build.source(name)).read()
    assert '#include "checked.cuh"' in text
    sites = cuda_build.check_sites(name)
    assert sites
    lines = text.splitlines()
    for line in sites:
        call = lines[line - 1][lines[line - 1].index("LEP_"):]
        depth = 0
        for ch in call:
            depth += (ch == "(") - (ch == ")")
            if depth == 0 and ch == ")":
                break
        assert depth == 0, f"{name}.cu:{line} spans lines"


def test_bounds_error_names_kernel_site_lane_index_and_limit():
    """KernelBoundsError names the kernel, its site with file and line,
    the lane, the index and the limit."""
    line, site = next((ln, s) for ln, s in
                      cuda_build.check_sites("vpx_decoder").items()
                      if s == "coef")
    e = cuda_build.KernelBoundsError("vpx_decoder", line, 3, 0, 1234, 1000)
    assert (e.site, e.lane, e.index, e.limit) == (site, 3, 1234, 1000)
    msg = str(e)
    for part in ("vpx_decoder", "coef",
                 f"lepton_tpu_torch/csrc/vpx_decoder.cu:{line}", "lane 3",
                 "1234", "[0, 1000)"):
        assert part in msg
    heads = cuda_build.KernelBoundsError("branch_probs", 1, 7, 5, -1, 9,
                                         per_lane=False)
    assert heads.lane is None and "CTA 7" in str(heads)


def test_default_build_takes_no_bounds_lock():
    """bounds() around a default build's launch does nothing."""
    class Lib:
        checked_name = None
    with cuda_build.bounds(Lib(), 0):
        pass


# ---------------------------------------------------------------------------
# (e) print_model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two model arenas, written by LEPTON_COMPRESSION_MODEL_OUT from the
    port's host codec on two photos."""
    d = tmp_path_factory.mktemp("models")
    out = []
    for seed in (1, 2):
        path = d / f"model{seed}"
        jpg = d / f"photo{seed}.jpg"
        jpg.write_bytes(_jpeg(256, 192, seed))
        r = _run([sys.executable, "-c",
                  "import sys; from lepton_tpu_torch import host\n"
                  "host.compress(open(sys.argv[1], 'rb').read())",
                  str(jpg)],
                 env={"LEPTON_COMPRESSION_MODEL_OUT": str(path)})
        assert r.returncode == 0, r.stderr
        out.append(str(path))
    return out


@pytest.mark.parametrize("flags,two", [([], False), (["-ok"], False),
                                       (["-t0.1", "-s5"], True)])
def test_print_model_matches_the_jax_tool(models, flags, two):
    """python -m lepton_tpu_torch.print_model prints tools/print_model.py's
    lines, but for the ')' that closes a two-model line, where the JAX
    tool prints '}' (tools/print_model.py:106, kept as it is)."""
    args = [*flags, models[0]] + ([models[1]] if two else [])
    jax = _run([sys.executable, "tools/print_model.py", *args])
    port = _run([sys.executable, "-m", "lepton_tpu_torch.print_model",
                 *args])
    assert jax.returncode == port.returncode == 0, jax.stderr + port.stderr
    want, got = jax.stdout.splitlines(), port.stdout.splitlines()
    assert got
    if two:
        assert all(line.endswith("}") for line in want)
        assert all(line.endswith(")") for line in got)
        want = [line[:-1] + ")" for line in want]
    assert got == want


# ---------------------------------------------------------------------------
# (f), (g), (h) bulk_recompress
# ---------------------------------------------------------------------------


def _corpus(d):
    d.mkdir()
    for k, (w, h) in enumerate(((64, 48), (96, 64), (40, 40))):
        (d / f"img{k}.jpg").write_bytes(_jpeg(w, h, 30 + k))
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(range(200)))
    (d / "notes.txt").write_text("not a JPEG")


def _summary(out: str) -> list:
    """The summary line without its MB/s, and the SKIP lines' files."""
    lines = out.splitlines()
    summary = [ln for ln in lines if " files, " in ln]
    assert len(summary) == 1, out
    head, _, tail = summary[0].rpartition(", ")
    skips = sorted(os.path.basename(ln.split()[1].rstrip(":"))
                   for ln in lines if ln.startswith("SKIP "))
    return [head.rsplit(", ", 1)[0], tail, skips]


def test_bulk_recompress_host_matches_the_jax_example(tmp_path, capsys):
    """--host over three JPEGs and a corrupt one: the JAX example's .lep
    bytes, counts and skipped file."""
    _corpus(tmp_path / "jax")
    _corpus(tmp_path / "port")
    r = _run([sys.executable, "examples/bulk_recompress.py",
              str(tmp_path / "jax")])
    assert r.returncode == 0, r.stderr
    assert bulk_recompress.main([str(tmp_path / "port"), "--host"]) == 0
    assert _summary(capsys.readouterr().out) == _summary(r.stdout)
    for k in range(3):
        name = f"img{k}.jpg.lep"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    assert not (tmp_path / "port" / "corrupt.jpg.lep").exists()


def test_bulk_recompress_on_the_cpu_device_gives_the_host_bytes(tmp_path):
    """--device cpu runs compress_device's plain versions: the host
    codec's bytes, and --decode takes the .lep back."""
    jpeg = _jpeg(32, 32, 7)
    (tmp_path / "a.jpg").write_bytes(jpeg)
    assert bulk_recompress.main([str(tmp_path), "--device", "cpu"]) == 0
    lep = (tmp_path / "a.jpg.lep").read_bytes()
    assert lep == host.compress(jpeg)
    (tmp_path / "a.jpg").unlink()
    (tmp_path / "b.lep").write_bytes(lep)
    (tmp_path / "a.jpg.lep").unlink()
    assert bulk_recompress.main([str(tmp_path), "--device", "cpu",
                                 "--decode"]) == 0
    assert (tmp_path / "b.jpg").read_bytes() == jpeg


def test_bulk_recompress_card_fault_ends_the_run(tmp_path, monkeypatch,
                                                 capsys):
    """A fault of the card (compress_device raising RuntimeError) is no
    skipped file: it ends the run, and no .lep is written."""
    from lepton_tpu_torch import api

    def fault(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(api, "compress_device", fault)
    (tmp_path / "a.jpg").write_bytes(_jpeg(32, 32, 8))
    with pytest.raises(RuntimeError):
        bulk_recompress.main([str(tmp_path), "--device", "cpu"])
    assert "SKIP" not in capsys.readouterr().out
    assert not (tmp_path / "a.jpg.lep").exists()
