"""The port's CLI (python -m lepton_tpu_torch, lepton_tpu_torch/cli.py) on
the CPU, against the JAX package's CLI (the `lepton` launcher).

The port's CLI runs on the card unless asked otherwise.  -tpu
-device=cpu routes the transcode through the device entry points' plain
versions: its .lep bytes must equal the JAX host compress at 8 segments
(the CLI's default -maxencodethreads) and its decode the original.  The
jailed host path (-device=host, the JAX CLI's default) must give the JAX
CLI's bytes, exit codes and zero-byte output on bad inputs; those cases
run as subprocesses, because the jail installed in the calling process
would kill a pytest worker.  Without a card the CLI fails loudly, a card
fault ends it with exit 1 and no output, and the host path loads no
torch.  Inputs are PIL-made JPEGs from numpy seeds.
"""
import os
import signal
import subprocess
import sys
import time
import zlib

import pytest

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402

from lepton_tpu_torch import cli  # noqa: E402
from lepton_tpu_torch.constants import ZLEPTON_HEADER  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLI = os.path.join(ROOT, "lepton")
ENV = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")


def _port(args, **kw):
    return subprocess.run([sys.executable, "-m", "lepton_tpu_torch", *args],
                          cwd=ROOT, env=ENV, capture_output=True,
                          timeout=300, **kw)


def _host(args, **kw):
    """The port's CLI on its host codec, as the JAX CLI runs by default."""
    return _port(["-device=host", *args], **kw)


def _jax(args):
    return subprocess.run([sys.executable, JAX_CLI, *args], cwd=ROOT,
                          env=ENV, capture_output=True, timeout=300)


def _corrupt() -> bytes:
    data = bytearray(_jpeg(48, 32, seed=30, quality=80))
    data[2:6] = b"\xff\xc4\x00\x01"     # DHT with an impossible length
    return bytes(data)


def test_tpu_cpu_round_trip(tmp_path):
    """-tpu -device=cpu: encode bytes equal the JAX host compress at 8
    segments, and the decode gives the original back; both in-process
    (-tpu leaves this process unjailed, the parse runs in a jailed
    child)."""
    data = _jpeg(48, 32, seed=31, quality=85)
    src, lep, back = (tmp_path / n for n in ("a.jpg", "a.lep", "b.jpg"))
    src.write_bytes(data)
    assert cli.main(["-tpu", "-device=cpu", str(src), str(lep)]) == 0
    assert lep.read_bytes() == japi.compress(data, max_threads=8)
    assert cli.main(["-tpu", "-device=cpu", str(lep), str(back)]) == 0
    assert back.read_bytes() == data


@pytest.mark.parametrize("flags", [[], ["-ans"], ["-allowprogressive"]],
                         ids=["v1", "v3", "progressive"])
def test_jailed_host_cli_matches_jax(tmp_path, flags):
    """The default (jailed, both seccomp stages) host CLI: the same .lep
    bytes as the JAX CLI, and the original back."""
    data = _jpeg(64, 48, seed=32, quality=85,
                 progressive="-allowprogressive" in flags)
    src = tmp_path / "a.jpg"
    src.write_bytes(data)
    r = _host([*flags, str(src), str(tmp_path / "p.lep")])
    assert r.returncode == 0, r.stderr
    j = _jax([*flags, str(src), str(tmp_path / "j.lep")])
    assert j.returncode == 0, j.stderr
    lep = (tmp_path / "p.lep").read_bytes()
    assert lep == (tmp_path / "j.lep").read_bytes()
    r = _host([str(tmp_path / "p.lep"), str(tmp_path / "back.jpg")])
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "back.jpg").read_bytes() == data


# the port's flags, the JAX CLI's flags, the input
BAD = {
    "unknown_type": (["-device=host"], [],
                     lambda: b"neither a JPEG nor a lepton file"),
    "corrupt_jpeg": (["-device=host"], [], _corrupt),
    "maxencodethreads_9": (["-device=host", "-maxencodethreads=9"],
                           ["-maxencodethreads=9"],
                           lambda: _jpeg(32, 24, seed=33)),
    "corrupt_jpeg_tpu": (["-tpu", "-device=cpu"], ["-tpu"], _corrupt),
}


@pytest.mark.parametrize("name", list(BAD))
def test_failure_contract_matches_jax(tmp_path, name):
    """Exit code and zero-byte output equal the JAX CLI's on the same bad
    input (the JAX CLI's own -tpu runs on JAX's CPU here)."""
    pflags, jflags, make = BAD[name]
    src = tmp_path / "in.bin"
    src.write_bytes(make())
    rp = _port([*pflags, str(src), str(tmp_path / "p.out")])
    rj = _jax([*jflags, str(src), str(tmp_path / "j.out")])
    assert rp.returncode == rj.returncode != 0, (rp.stderr, rj.stderr)
    for out in ("p.out", "j.out"):
        path = tmp_path / out
        assert not path.exists() or path.stat().st_size == 0


@pytest.mark.parametrize("flags", [["-tpu"], []], ids=["tpu", "default"])
def test_tpu_without_a_card_fails_loudly(tmp_path, flags):
    """The card path (-tpu, or no device flag at all) with no card:
    non-zero exit, no output, a message naming CUDA.  Nothing falls back
    to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = tmp_path / "a.jpg"
    src.write_bytes(_jpeg(32, 24, seed=34))
    r = _port([*flags, str(src), str(tmp_path / "a.lep")], text=True)
    assert r.returncode != 0
    assert not (tmp_path / "a.lep").exists()
    assert "CUDA" in r.stderr
    sock = tmp_path / "s.sock"
    r = _port([*flags, f"-socket={sock}"], text=True)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not sock.exists()


# a device encode that fails as a card does: raises, or never ends
DEAD = {
    "launch_failed": "raise RuntimeError('vpx_coder launch failed')",
    "hung": "time.sleep(120)",
}


@pytest.mark.parametrize("how", list(DEAD))
def test_card_fault_ends_the_cli(tmp_path, how):
    """A card fault in the one-shot device path (a kernel that does not
    launch, a call still running after LEPTON_TPU_TIMEOUT_S) exits 1 with
    a message naming CUDA and writes nothing; no host fallback runs."""
    src, out = tmp_path / "a.jpg", tmp_path / "a.lep"
    src.write_bytes(_jpeg(32, 24, seed=50))
    code = (
        "import sys, time\n"
        "from lepton_tpu_torch import api, cli\n"
        "def dead(*a, **k):\n"
        f"    {DEAD[how]}\n"
        "def host(*a):\n"
        "    raise SystemExit('served from the host')\n"
        "api.compress_device = dead\n"
        "cli._host_fallback_jailed = host\n"
        f"sys.exit(cli.main(['-device=cpu', {str(src)!r}, {str(out)!r}]))\n")
    t = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(ENV, LEPTON_TPU_TIMEOUT_S="2"),
                       capture_output=True, text=True, timeout=100)
    assert time.monotonic() - t < 60
    assert r.returncode == 1, r.stderr
    assert "CUDA card failure" in r.stderr
    assert not out.exists() or out.stat().st_size == 0


def test_forking_modes_need_the_host(tmp_path):
    """-fork and -benchmark fork a codec a request, which a CUDA context
    does not survive: on the card path they refuse with a message."""
    for flag in ("-fork", "-benchmark"):
        r = _port([flag], text=True, stdin=subprocess.DEVNULL)
        assert r.returncode == 1 and "-device=host" in r.stderr


def test_host_path_imports_no_torch(tmp_path):
    """An -unjailed host (-device=host) encode and decode through
    cli.main, with the serving module imported too, leave torch
    unloaded."""
    data = _jpeg(48, 32, seed=35, quality=80)
    src = tmp_path / "a.jpg"
    src.write_bytes(data)
    code = (
        "import sys; from lepton_tpu_torch import cli, serve; "
        "h = ['-device=host', '-unjailed']; "
        f"a = cli.main(h + [{str(src)!r}, {str(tmp_path / 'a.lep')!r}]); "
        f"b = cli.main(h + [{str(tmp_path / 'a.lep')!r}, "
        f"{str(tmp_path / 'b.jpg')!r}]); "
        "print(a, b, 'torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.split() == ["0", "0", "False"], r.stderr
    assert (tmp_path / "b.jpg").read_bytes() == data


@pytest.mark.parametrize("point", [1, 2, 5])
def test_injected_syscall_is_killed(tmp_path, point):
    """Under the jail a banned syscall from the main thread (1), from a
    segment coder (2) or a direct mmap under the stage-2 filter (5) kills
    the process with SIGSYS, and nothing is written."""
    src = tmp_path / "a.jpg"
    src.write_bytes(_jpeg(32, 24, seed=36))
    r = _host([f"-injectsyscall={point}", str(src), str(tmp_path / "a.lep")])
    assert r.returncode == -signal.SIGSYS, r.stderr
    out = tmp_path / "a.lep"
    assert not out.exists() or out.stat().st_size == 0


def test_stdin_zlib0_and_zlepton(tmp_path):
    """stdin to stdout, jailed; -zlib0 and a zlepton input wrap the decode
    in a stored zlib stream, as the JAX CLI does."""
    data = _jpeg(40, 32, seed=37, quality=80)
    r = _host([], input=data)
    assert r.returncode == 0
    lep = r.stdout
    assert lep == japi.compress(data)
    r = _host(["-zlib0"], input=lep)
    assert r.returncode == 0 and zlib.decompress(r.stdout) == data
    assert r.stdout == _jax_zlib0(tmp_path, lep)
    r = _host([], input=ZLEPTON_HEADER + lep[2:])
    assert r.returncode == 0 and zlib.decompress(r.stdout) == data


def _jax_zlib0(tmp_path, lep: bytes) -> bytes:
    (tmp_path / "j.lep").write_bytes(lep)
    r = _jax(["-zlib0", str(tmp_path / "j.lep"), str(tmp_path / "j.out")])
    assert r.returncode == 0
    return (tmp_path / "j.out").read_bytes()


def _pair(tmp_path, flags, data: bytes, name: str = "in.jpg"):
    """The port's (on its host codec) and the JAX CLI's (returncode,
    stdout, stderr, output file bytes) on the same input file."""
    src = tmp_path / name
    src.write_bytes(data)
    out = []
    for run, tag in ((_host, "p"), (_jax, "j")):
        dst = tmp_path / f"{tag}.out"
        r = run([*flags, str(src), str(dst)])
        out.append((r.returncode, r.stdout, r.stderr,
                    dst.read_bytes() if dst.exists() else None))
    return out


def test_ujg_matches_jax(tmp_path):
    """-ujg writes the JAX CLI's raw-coefficient file, and it decodes back.
    The JAX CLI runs -unjailed here: jailed, its -ujg dies with SIGSYS (its
    _prepare_for_jail does not pre-import container/ujg.py, so the import
    opens a file inside the jail); the port's pre-imports it."""
    data = _jpeg(48, 40, seed=38, quality=85, restart_marker_blocks=2)
    src = tmp_path / "in.jpg"
    src.write_bytes(data)
    rp = _host(["-ujg", str(src), str(tmp_path / "p.ujg")])
    rj = _jax(["-ujg", "-unjailed", str(src), str(tmp_path / "j.ujg")])
    assert rp.returncode == rj.returncode == 0
    p = (tmp_path / "p.ujg").read_bytes()
    assert p == (tmp_path / "j.ujg").read_bytes() and p[:2] == b"UJ"
    (rp, _, _, back), _ = _pair(tmp_path, [], p, name="in.ujg")
    assert rp == 0 and back == data


def test_billing_matches_jax(tmp_path):
    """-v2 prints the JAX CLI's bit billing table."""
    data = _jpeg(48, 40, seed=39, quality=85)
    (rp, _, ep, p), (rj, _, ej, j) = _pair(tmp_path, ["-v2"], data)
    assert rp == rj == 0 and p == j

    def bill(err: bytes):
        lines = err.decode().splitlines()
        return lines[next(i for i, ln in enumerate(lines)
                          if ln.startswith("category")):]
    assert bill(ep) == bill(ej) and any(ln.startswith("TOTAL")
                                        for ln in bill(ep))


def test_info_lepcat_benchmark_match_jax(tmp_path):
    """-info prints the JAX CLI's structure report; -lepcat merges v2
    files into the JAX CLI's bytes, which decode to the originals;
    -benchmark round-trips its tiny JPEG."""
    a = _jpeg(48, 40, seed=40, quality=85)
    b = _jpeg(40, 32, seed=41, quality=75)
    # the JAX CLI ends the report at the single-scan block counts with
    # exit 2 (CODING ERROR): its write_info reads ComponentInfo.nc, which
    # imageinfo lacks.  The port's prints that line as ncv * nch and goes
    # on to the quantiser tables, on the card path as on the host.
    (rp, op, _, _), (rj, oj, _, _) = _pair(tmp_path, ["-info"], a)
    assert rj == 2 and rp == 0
    assert op.startswith(oj) and b"coding process" in oj
    assert b"block count (sng): 30/5/6" in op
    assert op.count(b"quantiser table") == 3
    r = _port(["-info", str(tmp_path / "in.jpg")])
    assert r.returncode == 0 and r.stdout == op
    files = []
    for k, d in enumerate((a, b)):
        files.append(str(tmp_path / f"{k}.lep"))
        (tmp_path / f"{k}.lep").write_bytes(japi.compress(d, version=2))
    rp, rj = _port(["-lepcat", *files]), _jax(["-lepcat", *files])
    assert rp.returncode == rj.returncode == 0
    assert rp.stdout == rj.stdout
    r = _host([], input=rp.stdout)
    assert r.returncode == 0 and r.stdout == a + b
    r = _host(["-benchmark", "-benchreps=2"], text=True)
    assert r.returncode == 0 and "throughput" in r.stderr


def test_recodememory_and_timing(tmp_path):
    """-recodememory= decodes in the O(width) streaming decode within the
    bound, and exits 38 with no output below it, as the JAX CLI does;
    -timing= appends the stage matrix to its log."""
    data = _jpeg(96, 80, seed=42, quality=85)
    lep = japi.compress(data, max_threads=2, min_threads=2)
    (rp, _, _, p), (rj, _, _, j) = _pair(tmp_path, ["-recodememory=64m"],
                                         lep, name="in.lep")
    assert rp == rj == 0 and p == j == data
    (rp, _, _, p), (rj, _, _, j) = _pair(tmp_path, ["-recodememory=1k"],
                                         lep, name="in.lep")
    assert rp == rj == 38 and not p and not j
    log = tmp_path / "timing.log"
    src = tmp_path / "t.jpg"
    src.write_bytes(data)
    r = _host([f"-timing={log}", str(src), str(tmp_path / "t.lep")])
    assert r.returncode == 0
    assert "TS_ARITH_FINISHED" in log.read_text()


def test_device_decode_timing(tmp_path):
    """-timing= on the device route (-device=cpu): a .lep's decode writes
    the reference's re-emit stage rows and the spans' lines."""
    data = _jpeg(48, 32, seed=44, quality=85)
    src, back, log = (tmp_path / n for n in ("in.lep", "b.jpg", "t.log"))
    src.write_bytes(japi.compress(data, max_threads=2, min_threads=2))
    r = _port(["-device=cpu", f"-timing={log}", str(src), str(back)])
    assert r.returncode == 0 and back.read_bytes() == data
    text = log.read_text()
    assert "TS_JPEG_RECODE_FINISHED" in text and "[re-emit]" in text


def test_fork_server(tmp_path):
    """-fork names a FIFO pair on stdout for each request and transcodes
    what is written to the first into the second; it exits when its stdin
    closes."""
    data = _jpeg(48, 40, seed=43, quality=85)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lepton_tpu_torch", "-device=host", "-fork"],
        cwd=ROOT,
        env=ENV, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    try:
        fin = proc.stdout.readline().decode().strip()
        fout = proc.stdout.readline().decode().strip()
        with open(fin, "wb") as f_in, open(fout, "rb") as f_out:
            f_in.write(data)
            f_in.close()
            reply = f_out.read()
        assert reply == japi.compress(data)
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)
