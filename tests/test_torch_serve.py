"""The port's serving layer (lepton_tpu_torch/serve.py) on the CPU.

A mixed wave through _process_tpu_batch with device="cpu" (the kernels'
plain versions) must answer each request as the JAX package's host codec
does and count every host route exactly; batch_decompress_device's
per_request form returns each failing request's error in its own slot; a
hung wave, a kernel that does not launch and any other error that no
request causes are a card fault (cli.CardFault), never served from the
host, and the server stops on one with exit 1 and zero-byte replies.  Then
the servers as a user starts them, in subprocesses: the batch server on a
unix socket and the zlib port, and the jailed host fork server.  Inputs are PIL-made JPEGs
from numpy seeds, small because the plain coder is a Python loop.
"""
import json
import os
import socket
import subprocess
import sys
import time
import zlib

import pytest
import torch

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402

from lepton_tpu_torch import api, cli, serve  # noqa: E402
from lepton_tpu_torch.constants import ZLEPTON_HEADER  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cli.main's defaults, on the CPU
OPTS = dict(singlethread=False, allow_progressive=False, verify=True,
            permissive=False, even_split=False, max_threads=8, min_threads=1,
            version=1, verbosity=0, overwrite=False, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _preloaded():
    """The -tpu server pre-imports the host codec before it forks jailed
    children (cli._prepare_for_jail); the tests do as it does."""
    cli._prepare_for_jail({})


def _corrupt(seed: int) -> bytes:
    data = bytearray(_jpeg(40, 32, seed=seed, quality=80))
    data[2:6] = b"\xff\xc4\x00\x01"     # DHT with an impossible length
    return bytes(data)


def _wave(payloads, **opts):
    reqs = [[None, False, p, b""] for p in payloads]
    wave = serve.new_wave()
    cli.on_card(lambda: serve._process_tpu_batch(reqs, dict(OPTS, **opts),
                                                 wave))
    return [r[3] for r in reqs], wave


def _host(**counts) -> dict:
    out = dict.fromkeys(serve.ROUTES, 0)
    out.update(counts)
    return out


def test_mixed_wave_routes():
    """One wave of every kind of request: two JPEGs on the device path
    (verified on the host), a v1 and a v3 .lep on the device path, a
    mode-Y .lep and a zlepton on the host, an unknown payload and a .lep
    that does not read (zero bytes)."""
    a = _jpeg(40, 32, seed=40, quality=85)
    b = _jpeg(32, 24, seed=41, quality=75, subsampling=0)
    lep1 = japi.compress(b, max_threads=2, min_threads=2)
    lep3 = japi.compress(a, version=3)
    payload = b"bytes that ride in a mode-Y container"
    mode_y = japi.generic_compress(payload)
    zlep = ZLEPTON_HEADER + lep1[2:]
    broken = lep1[:40]
    before = dict(serve.HOST_ROUTES)
    replies, wave = _wave([a, lep1, b, lep3, mode_y, zlep, b"hello", broken])
    assert replies[0] == japi.compress(a, max_threads=8)
    assert replies[2] == japi.compress(b, max_threads=8)
    assert replies[1] == b and replies[3] == a
    assert replies[4] == payload
    assert zlib.decompress(replies[5]) == b
    assert replies[6] == b"" and replies[7] == b""
    assert wave["host"] == _host(mode_y=1, decode_failed=1, host_kind=2)
    assert {k: serve.HOST_ROUTES[k] - before[k] for k in before} == \
        wave["host"]
    assert (wave["jpeg"], wave["lep"], wave["other"]) == (2, 4, 2)
    assert wave["verified"] == 2
    # two segments of lep1, one of lep3
    assert wave["encode"]["lanes"] == 2 and wave["decode"]["lanes"] == 3


def test_bad_jpeg_sends_its_wave_to_the_host(monkeypatch):
    """A JPEG that fails the batch encode sends every JPEG of its wave to
    the host (encode_batch_failed counts both); the good one still gets
    its bytes, the bad one zero bytes.  A reply that does not verify goes
    to the host too (verify_failed)."""
    a = _jpeg(40, 32, seed=42, quality=85)
    replies, wave = _wave([a, _corrupt(43)])
    assert replies == [japi.compress(a, max_threads=8), b""]
    assert wave["host"] == _host(encode_batch_failed=2)
    assert "encode_error" in wave
    from lepton_tpu_torch import host
    real = host.decompress
    monkeypatch.setattr(host, "decompress", lambda d: real(d) + b"x")
    replies, wave = _wave([a])
    assert wave["host"] == _host(verify_failed=1) and wave["verified"] == 1


def test_batch_decompress_per_request():
    """per_request=True: a mode-Y request and one that does not read come
    back as their LeptonError in their own slots, the others as bytes;
    the default still raises for the whole call."""
    a = _jpeg(32, 24, seed=44, quality=80)
    leps = [japi.compress(a), japi.generic_compress(b"payload"),
            b"\xcf\x84\x01Z" + b"\x00" * 40]
    out = api.batch_decompress_device(leps, device="cpu", per_request=True)
    assert out[0] == a
    assert isinstance(out[1], api.LeptonError) and "mode-Y" in str(out[1])
    assert isinstance(out[2], api.LeptonError) and "request 2" in str(out[2])
    with pytest.raises(api.LeptonError):
        api.batch_decompress_device(leps, device="cpu")


def test_hung_wave_is_a_card_fault(monkeypatch):
    """A hung device never raises: a wave still running after
    LEPTON_TPU_TIMEOUT_S is a card fault, and none of its requests is
    served from the host."""
    def hung(reqs, opts, wave):
        time.sleep(60)

    monkeypatch.setattr(serve, "_process_tpu_batch", hung)
    monkeypatch.setenv("LEPTON_TPU_TIMEOUT_S", "1")
    before = dict(serve.HOST_ROUTES)
    t = time.monotonic()
    with pytest.raises(cli.CardFault, match="did not end within 1 s"):
        _wave([_jpeg(40, 32, seed=45, quality=85)])
    assert time.monotonic() - t < 30
    assert serve.HOST_ROUTES == before


FAULTS = {
    "launch_failed": lambda: RuntimeError(
        "vpx_coder launch failed: an illegal memory access was encountered"),
    "out_of_memory": lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB"),
    "wrapper_check": lambda: ValueError("idx must lie in [0, 721564)"),
    "nvcc_missing": lambda: FileNotFoundError(2, "No such file", "nvcc"),
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_card_fault_is_raised(monkeypatch, name):
    """An error that no request causes, raised in the wave's device
    calls, ends the wave as a CardFault; no request of it is served from
    the host, and no host route is counted."""
    def dead(*a, **k):
        raise FAULTS[name]()

    monkeypatch.setattr(api, "batch_compress_device", dead)
    before = dict(serve.HOST_ROUTES)
    with pytest.raises(cli.CardFault):
        _wave([_jpeg(32, 24, seed=46)])
    assert serve.HOST_ROUTES == before


def test_card_fault_stops_the_server(monkeypatch, tmp_path):
    """On a card fault the wave loop closes every connection it holds, so
    each client reads zero bytes, and returns 1."""
    def dead(reqs, opts, wave):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(serve, "_process_tpu_batch", dead)
    path = str(tmp_path / "s.sock")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.listen(8)
    clients = []
    for payload in (_jpeg(32, 24, seed=47), b"\xcf\x84\x01Z"):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(path)
        c.sendall(payload)
        c.shutdown(socket.SHUT_WR)
        clients.append(c)
    try:
        assert serve._wave_loop([(s, False)], dict(OPTS)) == 1
        for c in clients:
            c.settimeout(10)
            assert c.recv(65536) == b""
    finally:
        s.close()
        for c in clients:
            c.close()


def _ask(addr, payload: bytes, zlib_port: bool = False) -> bytes:
    if zlib_port:
        c = socket.create_connection(addr)
        payload = zlib.compress(payload)
    else:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(addr)
    c.settimeout(120)
    c.sendall(payload)
    c.shutdown(socket.SHUT_WR)
    chunks = []
    while True:
        b = c.recv(65536)
        if not b:
            break
        chunks.append(b)
    c.close()
    out = b"".join(chunks)
    return zlib.decompress(out) if zlib_port and out else out


def _start(args, sock, tmp_path):
    err = open(tmp_path / "server.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lepton_tpu_torch", *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stderr=err,
        stdout=subprocess.DEVNULL)
    deadline = time.monotonic() + 120
    while not os.path.exists(sock):
        assert proc.poll() is None and time.monotonic() < deadline
        time.sleep(0.1)
    return proc, err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_tpu_server_subprocess(tmp_path):
    """python -m lepton_tpu_torch -tpu -device=cpu on a unix socket and
    the zlib port: a JPEG and a .lep in one wave, then a JPEG over the
    zlib port; the wave lines carry the counts; SIGTERM exits 0."""
    sock = str(tmp_path / "tpu.sock")
    port = _free_port()
    proc, err = _start(["-tpu", "-device=cpu", f"-socket={sock}",
                        f"-zliblisten={port}"], sock, tmp_path)
    try:
        deadline = time.monotonic() + 120
        while "serving enabled" not in open(tmp_path / "server.err").read():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        a = _jpeg(40, 32, seed=47, quality=85)
        b = _jpeg(32, 24, seed=48, quality=80)
        assert _ask(sock, a) == japi.compress(a, max_threads=8)
        assert _ask(sock, japi.compress(b)) == b
        assert _ask(("localhost", port), b, zlib_port=True) == \
            japi.compress(b, max_threads=8)
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
    assert rc == 0
    err.seek(0)
    waves = [json.loads(ln.split(" wave=", 1)[1]) for ln in err
             if ln.startswith("tpu batch served ")]
    assert len(waves) == 3
    assert [w["jpeg"] for w in waves] == [1, 0, 1]
    assert all(not any(w["host"].values()) for w in waves)
    assert waves[0]["verified"] == 1 and waves[1]["decode"]["lanes"] == 1


def test_host_fork_server_subprocess(tmp_path):
    """The host server (-device=host): a jailed child a connection, the
    host codec's bytes back."""
    sock = str(tmp_path / "host.sock")
    proc, _ = _start(["-device=host", f"-socket={sock}"], sock, tmp_path)
    try:
        a = _jpeg(40, 32, seed=49, quality=85)
        lep = _ask(sock, a)
        assert lep == japi.compress(a)
        assert _ask(sock, lep) == a
        assert _ask(sock, b"junk") == b""
    finally:
        proc.kill()
        proc.wait(timeout=60)
