"""Socket serving: unix-domain + TCP + zlib-TCP.

Port of lepton_tpu/serve.py.  With -device=host (_handle, serve's accept
loop, fork_serve; :18-61, :297-443) each accepted connection forks a jailed
worker that reads the whole request (until the peer half-closes),
transcodes it on the host codec (JPEG -> .lep with verification, .lep ->
JPEG), writes the reply and exits, as the reference's socket_serve.cc
does.

On a torch device, the default (_serve_tpu and _process_tpu_batch, with
cli.on_card in the place of _process_batch_bounded; :88-294), one process
drains connections into waves of
LEPTON_TPU_SERVE_WAVE (default 8) requests: every JPEG of a wave is a lane
group of ONE batch_compress_device call, every .lep of it one
batch_decompress_device call, on the card.  Each JPEG reply is verified
with the host decoder.  What the card does not serve goes to the host
codec in a jailed forked child, and every such route is counted by reason
in HOST_ROUTES: a mode-Y container (mode_y), a wave whose batch encode
raised (encode_batch_failed: every JPEG of that wave), a reply that did
not verify (verify_failed), a .lep the device decode flagged or could not
read (decode_failed), and a request of another kind (host_kind: zlepton,
UJG, unknown).  Each wave's stderr line carries those counts, the
wave's segment-codec calls in this process that took the pure-Python
route (python_codec: 0 while the C library builds), its kernel launches
and its stage times.  Only an error that a request causes
(host.REQUEST_ERRORS) takes a host route.  A card fault (cli.CardFault: a
kernel that does not launch, a lost device, a wave still running after
LEPTON_TPU_TIMEOUT_S) stops the server with exit 1, and the clients of the
waves it holds get zero bytes; the JAX server's cooldown, which served
every wave from the host for a while after a hung one, is not ported.
"""
from __future__ import annotations

import json
import os
import select
import signal
import socket
import sys
import time
import zlib

from .util import timing

ROUTES = ("mode_y", "encode_batch_failed", "verify_failed", "decode_failed",
          "host_kind")
# requests answered by the host path since the server started, by reason
HOST_ROUTES = dict.fromkeys(ROUTES, 0)


def _route(wave: dict, reason: str, n: int = 1) -> None:
    HOST_ROUTES[reason] += n
    wave["host"][reason] += n


def new_wave() -> dict:
    """The per-wave record that _process_tpu_batch fills: request
    kinds, host routes, segment-codec calls on the Python route
    (host.SEGMENT_CODEC_ROUTES), JPEG replies verified, kernel launches,
    and the stats of the two batch calls."""
    return dict(jpeg=0, lep=0, other=0, verified=0,
                host=dict.fromkeys(ROUTES, 0), python_codec=0, launches={},
                encode={}, decode={}, verify_s=0.0)


def _handle(conn: socket.socket, opts, zlib_wrap: bool) -> None:
    if opts.get("timebound_ms"):
        # kill this child if the request exceeds its time budget
        # (socket_serve children arm setitimer, jpgcoder.cc:1744-1760)
        signal.setitimer(signal.ITIMER_REAL, opts["timebound_ms"] / 1000.0)
    # jail the per-connection child before touching request bytes: only
    # the already-open connection fd is reachable afterwards
    # (socket_serve.cc children run inside seccomp the same way)
    if not opts.get("unjailed"):
        from .cli import _prepare_for_jail
        from .util.sandbox import install_jail
        _prepare_for_jail(opts)
        install_jail()
    chunks = []
    while True:
        b = conn.recv(65536)
        if not b:
            break
        chunks.append(b)
    data = b"".join(chunks)
    from .cli import _process
    try:
        if zlib_wrap:
            data = zlib.decompress(data)
        out, _ = _process(data, opts)
        if zlib_wrap:
            out = zlib.compress(out)
    except Exception:
        if opts.get("permissive"):
            from .host import generic_compress
            try:
                out = generic_compress(data)
            except Exception:
                out = b""
        else:
            out = b""
    try:
        conn.sendall(out)
        conn.shutdown(socket.SHUT_WR)
    except OSError:
        pass
    conn.close()


def _host_fallback(data: bytes, opts) -> bytes:
    """Degrade one request to the host codec in a JAILED forked child (the
    -tpu serving process itself cannot be jailed, but the fallback parses
    untrusted input, the exact surface the jail confines).  A request that
    still fails gets the zero-byte reply, which also absorbs SystemExit
    inside the child."""
    from .cli import _host_fallback_jailed
    try:
        out = _host_fallback_jailed(data, opts)
        if out:
            return out
    except (Exception, SystemExit):
        pass
    if opts.get("permissive"):
        from .host import generic_compress
        try:
            return generic_compress(data)
        except Exception:
            pass
    return b""


def _launches() -> dict:
    """The launch counters of the -tpu path's kernels."""
    from .kernels import (ans_coder, branch_probs, symbolize, vpx_coder,
                          vpx_decoder)
    return dict(symbol_counts=symbolize.symbol_counts.launches,
                symbol_emit=symbolize.emit_symbols.launches,
                run_heads=branch_probs.run_heads.launches,
                walk_runs=branch_probs.walk_runs.launches,
                vpx_walk=vpx_coder.vpx_walk.launches,
                ans_walk=ans_coder.ans_walk.launches,
                vpx_reader=vpx_decoder.decode_lanes.launches,
                ans_reader=vpx_decoder.decode_lanes.ans_launches)


def _process_tpu_batch(reqs, opts, wave: dict) -> None:
    """Transcode a wave of drained requests through the card: all JPEG
    requests' segments become coder lanes of ONE batch_compress_device
    call (max_threads segments each, the serving-throughput design
    point), and all .lep requests reader lanes of ONE
    batch_decompress_device call.  Verify-by-default runs the host
    decoder on each JPEG reply; what the card does not serve is counted
    in `wave` and HOST_ROUTES and degraded to the host path, and a
    request that still fails gets the zero-byte reply.  Only
    host.REQUEST_ERRORS take a host route: any other error raises.

    reqs: list of [conn, zlib_wrap, data, out] (out filled in place)."""
    import torch

    from .api import batch_compress_device, batch_decompress_device
    from .cli import sniff
    from .host import REQUEST_ERRORS, SEGMENT_CODEC_ROUTES, _roundtrips

    dev = torch.device(opts.get("device", "cuda"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    python_before = SEGMENT_CODEC_ROUTES["python"]
    jpegs = [r for r in reqs if sniff(r[2]) == "jpeg"]
    leps = [r for r in reqs if sniff(r[2]) == "lepton"]
    others = [r for r in reqs if sniff(r[2]) not in ("jpeg", "lepton")]
    wave.update(jpeg=len(jpegs), lep=len(leps), other=len(others))
    outs = None
    if jpegs:
        try:
            outs = batch_compress_device(
                [r[2] for r in jpegs],
                num_segments=opts.get("max_threads", 16),
                device=opts.get("device"), stats=wave["encode"],
                allow_progressive=opts.get("allow_progressive", False),
                jailed_parse=not opts.get("user_unjailed"))
        except REQUEST_ERRORS as e:
            wave["encode_error"] = f"{type(e).__name__}: {e}"
            _route(wave, "encode_batch_failed", len(jpegs))
    for i, r in enumerate(jpegs):
        out = b""
        if outs is not None:
            out = outs[i]
            if opts.get("verify", True):
                # the host decoder's own spans write to no call (part({}))
                with timing.part(wave), \
                        timing.span("serve.verify", "verify_s"), \
                        timing.part({}):
                    ok = _roundtrips(out, r[2])
                wave["verified"] += 1
                if not ok:
                    _route(wave, "verify_failed")
                    out = b""
        if not out:
            out = _host_fallback(r[2], opts)
        r[3] = out
    if leps:
        # lepton -> JPEG rides one batched device-decode wave too
        # (socket_serve.cc serves both directions through the same loop);
        # a request's own fault comes back in its slot
        decs = batch_decompress_device(
            [r[2] for r in leps], device=opts.get("device"),
            stats=wave["decode"], per_request=True)
        for r, out in zip(leps, decs):
            if isinstance(out, (bytes, bytearray)) and out:
                r[3] = bytes(out)
                continue
            _route(wave, "mode_y" if r[2][3:4] == b"Y" else "decode_failed")
            r[3] = _host_fallback(r[2], opts)
    for r in others:
        _route(wave, "host_kind")
        r[3] = _host_fallback(r[2], opts)
    after = _launches()
    wave["launches"] = {k: after[k] - before[k] for k in after}
    wave["python_codec"] = SEGMENT_CODEC_ROUTES["python"] - python_before
    if dev.type == "cuda":
        wave["peak_bytes"] = torch.cuda.max_memory_allocated(dev)


class _Stop(BaseException):
    """SIGTERM, raised out of _wave_loop."""


def _serve_tpu(socks, opts) -> int:
    """Single-process device serving loop, WAVE-pipelined: drained
    requests queue up and are transcoded in waves of LEPTON_TPU_SERVE_WAVE
    (default 8), each wave replied to as soon as it completes, and new
    connections accepted between waves join the next wave.  No
    per-connection fork (the CUDA context does not survive one); isolation
    still holds per wave through the zero-byte contract.  Returns 1 on a
    card fault (cli.CardFault), and 0 on SIGTERM.  A SIGTERM stops the
    loop at once, except between a wave's first reply and its record on
    stderr: there it stops the loop once the record is written, so that
    every wave a client was answered from is logged."""
    term = {"defer": False, "asked": False}

    def _on_term(signum, frame):
        if term["defer"]:
            term["asked"] = True
        else:
            raise _Stop

    signal.signal(signal.SIGTERM, _on_term)
    try:
        return _wave_loop(socks, opts, term)
    except _Stop:
        for s, _ in socks:
            s.close()
        return 0


def _wave_loop(socks, opts, term=None) -> int:
    """_serve_tpu's loop: drain, serve a wave, reply, log the wave.  term:
    _serve_tpu's SIGTERM state (defer, asked)."""
    term = {"defer": False, "asked": False} if term is None else term
    from .cli import CardFault, _prepare_for_jail, card_fault_exit, on_card
    # pre-import the transcode modules so fallback forks never take the
    # import lock a hung device thread could hold (_host_fallback_jailed)
    _prepare_for_jail(dict(opts))
    wave_n = max(1, int(os.environ.get("LEPTON_TPU_SERVE_WAVE", 8)))
    sys.stderr.write(f"tpu batch serving enabled on {opts.get('device')}\n")
    sys.stderr.flush()
    read_timeout = (opts["timebound_ms"] / 1000.0
                    if opts.get("timebound_ms") else 10.0)

    def read_request(conn, zw):
        # a stalled peer must not freeze the whole single-process loop:
        # bound each request read by WALL CLOCK, not per-recv -- a client
        # trickling one byte per 9s would never trip a per-recv timeout
        chunks = []
        deadline = time.monotonic() + read_timeout
        try:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    chunks = []     # over budget: drop the request
                    break
                conn.settimeout(left)
                b = conn.recv(65536)
                if not b:
                    break
                chunks.append(b)
        except OSError:     # includes socket.timeout: drop request
            chunks = []
        data = b"".join(chunks)
        if zw:
            try:
                data = zlib.decompress(data)
            except Exception:
                data = b""
        return data

    pending = []
    reads = {}      # read_s of the requests that wait for a wave
    while True:
        # accept everything currently queued; block only when idle
        try:
            ready, _, _ = select.select(
                [s for s, _ in socks], [], [],
                0.005 if pending else None)
        except InterruptedError:
            continue
        while ready:
            for s in ready:
                zw = next(z for ss, z in socks if ss is s)
                try:
                    conn, _ = s.accept()
                except OSError:
                    continue
                with timing.part(reads), \
                        timing.span("serve.read", "read_s"):
                    pending.append([conn, zw, read_request(conn, zw), b""])
            try:
                ready, _, _ = select.select([s for s, _ in socks], [], [],
                                            0.005)
            except InterruptedError:
                ready = []
        if not pending:
            continue
        reqs = pending[:wave_n]
        del pending[:wave_n]
        wave = new_wave()
        wave["read_s"] = reads.pop("read_s", 0.0)
        with timing.part(wave), timing.span("serve.wave", "wall_s"):
            try:
                with timing.span("serve.transcode", "transcode_s"):
                    on_card(lambda: _process_tpu_batch(reqs, opts, wave))
            except CardFault as e:
                for conn, *_ in reqs + pending:
                    conn.close()
                return card_fault_exit(e, "tpu serving stopped: ")
            term["defer"] = True
            with timing.span("serve.reply", "reply_s"):
                for conn, zw, _, out in reqs:
                    if zw and out:
                        # failures stay zero-byte on the zlib port too: an
                        # empty reply is the failure contract,
                        # zlib.compress(b"") isn't
                        out = zlib.compress(out)
                    try:
                        conn.sendall(out)
                        conn.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    conn.close()
        wave["wall_s"] += wave["read_s"]
        # observable wave fill (the wave size is THE serving-efficiency
        # statistic here), then the wave's record as one JSON object
        sys.stderr.write(
            f"tpu batch served n={len(reqs)} "
            f"bytes={sum(len(r[2]) for r in reqs)} "
            f"queued={len(pending)} wave={json.dumps(wave)}\n")
        sys.stderr.flush()
        term["defer"] = False
        if term["asked"]:
            raise _Stop


def serve(socket_path, listen_port, zlib_port, max_children, opts) -> int:
    socks = []
    if socket_path:
        try:
            os.unlink(socket_path)
        except OSError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(socket_path)
        s.listen(128)
        socks.append((s, False))
        sys.stderr.write(f"listening on {socket_path}\n")
    if listen_port:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", listen_port))
        s.listen(128)
        socks.append((s, False))
        sys.stderr.write(f"listening on tcp {listen_port}\n")
    if zlib_port:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", zlib_port))
        s.listen(128)
        socks.append((s, True))
        sys.stderr.write(f"listening on zlib tcp {zlib_port}\n")
    if not socks:
        return 1

    if opts.get("tpu"):
        return _serve_tpu(socks, opts)

    children = set()

    def reap():
        while children:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                children.clear()
                break
            if pid == 0:
                break
            children.discard(pid)

    while True:
        reap()
        timeout = 0.03 if children else None
        try:
            ready, _, _ = select.select([s for s, _ in socks], [], [],
                                        timeout)
        except InterruptedError:
            continue
        for s in ready:
            zlib_wrap = next(z for ss, z in socks if ss is s)
            if max_children and len(children) >= max_children:
                reap()
                if len(children) >= max_children:
                    continue
            try:
                conn, _ = s.accept()
            except OSError:
                continue
            pid = os.fork()
            if pid == 0:
                for ss, _ in socks:
                    ss.close()
                try:
                    _handle(conn, opts, zlib_wrap)
                finally:
                    os._exit(0)
            children.add(pid)
            conn.close()


def fork_serve(opts) -> int:
    """Named-FIFO pre-fork server (reference fork_serve.cc:78-132).

    For each request: announce a fresh (input, output) FIFO pair on stdout,
    fork a worker that transcodes input -> output, repeat.  Compatible with
    the reference's forktester.py protocol.
    """
    import tempfile
    import threading
    import uuid

    def _exit_on_stdin():
        # Parent lifetime is tied to the controlling process: when the
        # client closes our stdin, terminate (reference fork_serve.cc:40-55).
        try:
            while os.read(0, 4096):
                pass
        except OSError:
            pass
        os._exit(0)

    threading.Thread(target=_exit_on_stdin, daemon=True).start()

    while True:
        base = os.path.join(tempfile.gettempdir(), str(uuid.uuid4()))
        in_path = base + ".in"
        out_path = base + ".out"
        os.mkfifo(in_path, 0o600)
        os.mkfifo(out_path, 0o600)
        sys.stdout.write(in_path + "\n" + out_path + "\n")
        sys.stdout.flush()
        rfd = os.open(in_path, os.O_RDONLY)
        wfd = os.open(out_path, os.O_WRONLY)
        os.unlink(in_path)
        os.unlink(out_path)
        pid = os.fork()
        if pid == 0:
            try:
                # jail the worker before touching request bytes, like the
                # socket children (only the open FIFOs remain reachable)
                if not opts.get("unjailed"):
                    from .cli import _prepare_for_jail
                    from .util.sandbox import install_jail
                    _prepare_for_jail(opts)
                    install_jail()
                chunks = []
                while True:
                    b = os.read(rfd, 65536)
                    if not b:
                        break
                    chunks.append(b)
                data = b"".join(chunks)
                from .cli import _process
                try:
                    out, _ = _process(data, opts)
                except Exception:
                    out = b""
                off = 0
                while off < len(out):
                    off += os.write(wfd, out[off:off + 65536])
            finally:
                os.close(rfd)
                os.close(wfd)
                os._exit(0)
        os.close(rfd)
        os.close(wfd)
        try:
            while os.waitpid(-1, os.WNOHANG)[0] > 0:
                pass
        except ChildProcessError:
            pass
