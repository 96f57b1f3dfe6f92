"""lepton-compatible command line interface of the PyTorch/CUDA port.

Port of lepton_tpu/cli.py: the flag surface of main (:68-365), file-type
sniffing by magic bytes, encode with round-trip verification by default,
the zero-byte output contract and exit codes (:286-333), the default-on
seccomp jail (_prepare_for_jail, _install_jail_and_inject, :452-554),
the device path (-tpu, :144-156, :669-738), which routes the transcode
through the card's kernels while the untrusted parse and any host fallback
run in jailed forked children (_host_fallback_jailed, :381-422; on_card,
from _run_tpu_bounded, :425-449), -v2 billing (_print_bill, :557-595),
-info (_write_info), -lepcat (lepcat_merge, _lepcat) and -benchmark
(:610-651, :783-899).  The socket and FIFO servers are serve.py.

Unlike the JAX CLI, this one runs on the card unless the caller asks for
something else: -device=<torch device> (default cuda) says where the device
path runs (cpu runs the kernels' plain versions), and -device=host runs the
jailed host codec, as the JAX CLI does without -tpu.  -tpu is accepted, so
scripts written for the JAX CLI run unchanged.  The device path checks the
device and builds the kernels before it reads a request.  A card fault
(CardFault: no card, a kernel that does not build or launch, a hung or
failing device call) ends the process with exit 1, a message naming CUDA
and no output; only an error that a request causes (host.REQUEST_ERRORS)
takes the host route, and each host route says so on stderr.

The host path (-device=host) imports no torch.
"""
from __future__ import annotations

import os
import sys

from . import __version__
from .constants import LEPTON_HEADER, ZLEPTON_HEADER


def _err(msg: str) -> None:
    sys.stderr.write(msg + "\n")


HELP = """lepton_tpu_torch v{version}
Usage: python -m lepton_tpu_torch [switches] input_file [output_file]

  overwrite action : overwrite files
  -version         : print version and exit
  -v0|-v1|-v2      : verbosity (-v2 prints the bit billing)
  -timing=<file>   : append stage timings to a log file
  -singlethread    : encode/decode using a single thread
  -allowprogressive: allow progressive jpegs through the compressor
  -rejectprogressive: reject encoding progressive jpegs
  -unjailed        : do not install the seccomp-BPF syscall jail
  -injectsyscall=<1-5>: fault injection: issue a banned syscall from the
                     main thread (1,3) or a segment worker (2,4), or a
                     banned-memory mmap (5, stage-2 filter); under the
                     jail the process must die with SIGSYS
  -maxencodethreads=<n> : upper bound on encode segments
  -minencodethreads=<n> : lower bound on encode segments
  -evensplit       : split segments evenly by row count
  -skipverify      : do not round-trip verify the encode
  -verify          : round-trip verify the encode (default)
  -permissive      : wrap undecodable inputs as generic lepton files
  -brotliheader    : use brotli (v2) header compression
  -ans             : rANS lanes (container v3)
  -lepcat          : concatenate lepton files (v2+) to stdout
  -info            : print the JPEG's structure and exit
  -benchmark       : round-trip the input (or a tiny JPEG) -benchreps=
                     times in -benchthreads= forked codecs
  -fork            : serve requests over FIFO pairs named on stdout
  -socket=<path>   : serve over a unix domain socket
  -listen=<port>   : serve over TCP
  -zliblisten=<port>: serve zlib-wrapped TCP
  -ujg             : write raw coefficients (UJG) instead of a .lep
  -recodememory=<n>: decode within n bytes (O(width) streaming decode;
                     exit 38 when the bound is too small)
  -device=<dev>    : where encode/decode run: a torch device (default
                     cuda: symbolize, coder and token reader on the card;
                     cpu runs the kernels' plain versions), or host for the
                     jailed host codec.  On a torch device this process
                     runs unjailed while the parse runs in a jailed child;
                     with a serve flag, requests batch onto it in waves
  -tpu             : accepted for scripts written for the JAX CLI (the
                     device path is already the default)
"""

# the kernels of the -tpu paths: the coders' probability stage and walks,
# and the token decoder with both readers
PATH_KERNELS = ("symbolize", "branch_probs", "vpx_coder", "ans_coder",
                "vpx_decoder")


def sniff(data: bytes) -> str:
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:2] == LEPTON_HEADER:
        return "lepton"
    if data[:2] == ZLEPTON_HEADER:
        return "zlepton"
    if data[:2] == b"UJ":
        return "ujg"
    return "unknown"


def device_ready(device: str):
    """The torch device the device path runs on, checked and with every path kernel
    built and loaded (in parallel, kernels/cuda_build.py).  Raises
    RuntimeError naming CUDA when the card or a kernel build is missing:
    a card fault ends the process, it never becomes a per-request host
    fallback."""
    from . import api
    from .kernels import cuda_build
    dev = api._device(device)
    if dev.type == "cuda":
        cuda_build.build([k for k in PATH_KERNELS if cuda_build.stale(k)])
        for k in PATH_KERNELS:
            cuda_build.load(k)
    return dev


class CardFault(Exception):
    """An error on the device path that no request causes: a lost or hung
    card, a kernel that does not build or launch, a wrapper's own check.
    The CLI and the server stop on it; it never becomes a host fallback.
    hung: the device call is still running."""

    def __init__(self, msg: str, hung: bool = False):
        super().__init__(msg)
        self.hung = hung


def card_fault_exit(e: CardFault, prefix: str = "") -> int:
    """Report a card fault on stderr, naming CUDA, and return exit code 1.
    Past a hung device call the process leaves at once (os._exit): the
    interpreter's teardown could wait on the thread still inside the CUDA
    runtime."""
    _err(f"{prefix}CUDA card failure: {e}")
    if e.hung:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 1


def on_card(fn):
    """fn(), a call of the device path, under a wall-clock budget
    (LEPTON_TPU_TIMEOUT_S, default 600 s).  One of host.REQUEST_ERRORS
    raises as it is; any other error, and a call still running when the
    budget ends (a hung card never raises), raises CardFault.  The call
    runs in a daemon thread, so the process can exit past a hung one."""
    import threading
    from .host import REQUEST_ERRORS
    budget = float(os.environ.get("LEPTON_TPU_TIMEOUT_S", 600))
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(budget)
    if t.is_alive():
        raise CardFault(f"the device call did not end within {budget:g} s",
                        hung=True)
    err = box.get("err")
    if err is None:
        return box["out"]
    if isinstance(err, REQUEST_ERRORS) or not isinstance(err, Exception):
        raise err
    raise CardFault(f"{type(err).__name__}: {err}") from err


def _host_route(opts, what: str) -> None:
    """Say on stderr that `what` runs on the host codec although the
    device path was asked for."""
    if opts.get("tpu"):
        _err(f"{what}: the device path does not cover it; running on the "
             "host codec")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(
        singlethread=False, allow_progressive=False, verify=True,
        permissive=False, even_split=False, max_threads=8, min_threads=1,
        version=1, verbosity=1, overwrite=False, device="cuda",
    )
    files = []
    socket_path = None
    listen_port = None
    zlib_port = None
    max_children = 0
    for arg in argv:
        if arg in ("-h", "-help", "--help"):
            sys.stdout.write(HELP.format(version=__version__))
            return 0
        elif arg in ("-version", "--version"):
            # the reference prints the 2-hex-digit format version
            # (jpgcoder.cc:1014-1016, ujgversion=1); embeddings parse it
            sys.stdout.write("01\n")
            return 0
        elif arg == "-revision":
            import subprocess as _sp
            try:
                rev = _sp.run(["git", "-C", os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))),
                    "rev-parse", "HEAD"], capture_output=True,
                    text=True).stdout.strip()
            except Exception:
                rev = ""
            sys.stdout.write((rev or "unknown") + "\n")
            return 0
        elif arg == "-singlethread":
            opts["singlethread"] = True
        elif arg in ("-multithread", "-m"):
            # re-enable threading after -singlethread (jpgcoder.cc:1061)
            opts["singlethread"] = False
        elif arg in ("-allowprogressive", "-forceprogressive"):
            # -forceprogressive also keeps the reference's full-framebuffer
            # progressive machinery on for mode Z/Y files (jpgcoder.cc:1052,
            # :2163); the decoder here always decodes from whole planes
            opts["allow_progressive"] = True
        elif arg.startswith("-defermd5"):
            pass  # accepted and ignored, like the reference (:1072)
        elif arg == "-allowfourcolors":
            opts["allow_four_colors"] = True
        elif arg == "-allow34sampling":
            opts["allow_34_sampling"] = True
        elif arg == "-rejectprogressive":
            opts["allow_progressive"] = False
        elif arg in ("-skipverify", "-skiproundtrip", "-skipvalidate",
                     "-skipvalidation", "-skipverification"):
            opts["verify"] = False
        elif arg in ("-verify", "-validate", "-validation", "-verification",
                     "-roundtrip"):
            opts["verify"] = True
        elif arg == "-permissive":
            opts["permissive"] = True
        elif arg == "-evensplit":
            opts["even_split"] = True
        elif arg == "-brotliheader":
            opts["version"] = max(opts["version"], 2)
        elif arg == "-ans":
            opts["version"] = 3
        elif arg == "-lepcat":
            opts["lepcat"] = True
        elif arg == "-info":
            opts["info"] = True
        elif arg == "-benchmark":
            opts["benchmark"] = True
        elif arg == "-fork":
            opts["fork"] = True
        elif arg in ("overwrite", "-o"):
            opts["overwrite"] = True
        elif arg == "-unjailed":
            opts["unjailed"] = True
            opts["user_unjailed"] = True
        elif arg == "-tpu":
            pass    # the device path is the default (-device=)
        elif arg.startswith("-device="):
            opts["device"] = arg.split("=", 1)[1]
        elif arg in ("-preload", "-decode", "-encode", "-recode",
                     "-unkillable", "-hugepages", "-verbose",
                     "-avx2upgrade", "-d", "-dev", "-avx", "-p"):
            # accepted for compatibility: jpgcoder.cc either ignores these
            # or sets flags with no effect on the transcode ("-d" sets the
            # write-only disc_meta, jpgcoder.cc:529,1146; "-dev" only
            # widens which *actions* are CLI-reachable, :776; "-p" proceeds
            # on warnings, err_tresh=2, :1023-1025, which this CLI
            # already does)
            pass
        elif arg.startswith(("-listenbacklog=", "-threadmemory=")):
            pass  # accepted for compatibility
        elif arg.startswith("-benchreps="):
            opts["benchreps"] = int(arg.split("=", 1)[1])
        elif arg.startswith("-benchthreads="):
            opts["benchthreads"] = int(arg.split("=", 1)[1])
        elif arg.startswith("-injectsyscall="):
            opts["injectsyscall"] = int(arg.split("=", 1)[1])
        elif arg.startswith("-maxencodethreads="):
            opts["max_threads"] = int(arg.split("=", 1)[1])
            if opts["max_threads"] > 8:
                # the reference rejects >MAX_NUM_THREADS with exit 13
                # (jpgcoder.cc:1082-1084)
                return 13
        elif arg.startswith("-minencodethreads="):
            opts["min_threads"] = int(arg.split("=", 1)[1])
        elif arg.startswith("-memory="):
            from .util.sandbox import apply_memory_limit
            apply_memory_limit(_parse_size(arg.split("=", 1)[1]))
        elif arg.startswith("-timebound="):
            # milliseconds; bounds each request read of the -tpu server
            v = arg.split("=", 1)[1]
            if v.endswith("ms"):
                opts["timebound_ms"] = int(v[:-2])
            elif v.endswith("s"):
                opts["timebound_ms"] = int(float(v[:-1]) * 1000)
            else:
                opts["timebound_ms"] = int(v)
        elif arg == "-jailed":
            from .util.sandbox import no_new_privs
            no_new_privs()
        elif arg.startswith("-recodememory="):
            opts["recodememory"] = _parse_size(arg.split("=", 1)[1])
        elif arg.startswith("-trunc="):
            opts["trunc"] = _parse_size(arg.split("=", 1)[1])
        elif arg.startswith("-startbyte="):
            opts["start_byte"] = _parse_size(arg.split("=", 1)[1])
        elif arg.startswith("-embedding="):
            opts["embedding"] = _parse_size(arg.split("=", 1)[1])
        elif arg == "-zlib0":
            opts["zlib0"] = True
        elif arg in ("-ujg", "-ujpg"):
            opts["ujg"] = True
        elif arg.startswith("-socket="):
            socket_path = arg.split("=", 1)[1]
        elif arg == "-socket":
            # bare -socket: generate a temporary name like the reference
            # does when ServiceInfo.uds is NULL (socket_serve.cc:31-63)
            import binascii
            import tempfile
            socket_path = os.path.join(
                tempfile.gettempdir(),
                "lepton-%s.sock" % binascii.hexlify(os.urandom(8)).decode())
        elif arg.startswith("-listen="):
            listen_port = int(arg.split("=", 1)[1])
        elif arg == "-listen":
            listen_port = 2402   # reference default (socket_serve.hh:14)
        elif arg.startswith("-zliblisten="):
            zlib_port = int(arg.split("=", 1)[1])
        elif arg == "-zliblisten":
            zlib_port = 2403     # reference default (socket_serve.hh:15)
        elif arg.startswith("-maxchildren="):
            max_children = int(arg.split("=", 1)[1])
        elif len(arg) > 2 and arg[:2] == "-v" and arg[2:].lstrip("-").isdigit():
            # -v<i> parses any integer and clamps to [0,2] (jpgcoder.cc:1001)
            opts["verbosity"] = max(0, min(2, int(arg[2:])))
        elif arg.startswith("-timing=") or arg.startswith("-trunctiming="):
            # append stage timings to a log file (jpgcoder.cc:1078-1086)
            opts["timing_log"] = arg.split("=", 1)[1]
            from .util import timing
            timing.enable(True)
        elif arg.startswith("-"):
            _err(f"unknown flag {arg} (ignored)")
        else:
            files.append(arg)

    if opts["singlethread"]:
        opts["max_threads"] = opts["min_threads"] = 1

    # -lepcat only rewrites container headers and -info only reads a
    # JPEG's header: neither codes anything, so both run on the host
    opts["tpu"] = opts["device"] != "host" and not (
        opts.get("lepcat") or opts.get("info"))
    if opts["tpu"] and (opts.get("benchmark") or opts.get("fork")):
        # both fork a codec a request, and a CUDA context does not
        # survive a fork
        _err("-benchmark and -fork run the host codec: pass -device=host "
             "(the card serves through -socket, -listen and -zliblisten)")
        return 1

    if opts.get("benchmark"):
        return _benchmark(files, reps=opts.get("benchreps", 10),
                          bench_threads=opts.get("benchthreads", 1))

    if opts["tpu"]:
        # the device process runs unjailed: the CUDA runtime needs the
        # files and memory maps that the seccomp allow-list bans.  The
        # untrusted-input parse still runs in a jailed forked child
        # (host._parse_jpeg_jailed) unless the user passed -unjailed
        # themselves, and verification runs the independent host decoder,
        # so the roundtrip gate spans both implementations.
        opts["unjailed"] = True
        try:
            opts["device"] = str(device_ready(opts["device"]))
        except Exception as e:
            _err(f"no usable device {opts['device']!r} "
                 f"({type(e).__name__}: {e}): the device path needs a CUDA "
                 "card and nvcc; pass -device=host for the host codec or "
                 "-device=cpu for the kernels' plain versions")
            return 1

    if opts.get("fork"):
        from .serve import fork_serve
        opts["serving"] = True
        return fork_serve(opts)

    if socket_path or listen_port or zlib_port:
        from .serve import serve
        opts["serving"] = True
        return serve(socket_path, listen_port, zlib_port, max_children, opts)

    if opts.get("lepcat"):
        return _lepcat(files)

    from .util.exitcodes import ExitCode, classify

    if len(files) > 2:
        # more than in+out file args: help + FILE_NOT_FOUND, no output
        # (jpgcoder.cc:788-790)
        _err(f"too many file arguments: {' '.join(files)}")
        return int(ExitCode.FILE_NOT_FOUND)

    # stdin/stdout when no files given -- jailed like the file path (the
    # reference jails stdin mode too: fds are already open, so only the
    # pre-imports are needed before installing seccomp)
    if not files:
        data = sys.stdin.buffer.read()
        _install_jail_and_inject(opts, sniff(data) == "jpeg")
        try:
            out, _ = _process(data, opts)
        except (SystemExit, KeyboardInterrupt):
            raise
        except CardFault as e:
            return card_fault_exit(e)
        except BaseException as e:  # zero-byte output contract
            if opts["verbosity"] > 0:
                _err(f"{type(e).__name__}: {e}")
            return int(classify(e))
        sys.stdout.buffer.write(out)
        return 0

    infile = files[0]
    try:
        data = open(infile, "rb").read() if infile != "-" else \
            sys.stdin.buffer.read()
    except (SystemExit, KeyboardInterrupt):
        raise
    except BaseException as e:
        if opts["verbosity"] > 0:
            _err(f"{type(e).__name__}: {e}")
        return int(classify(e))

    # output filename from the *input* type so the fd can be opened
    # before jailing (jpgcoder.cc opens fds, then jails, :1766)
    in_kind = sniff(data)
    if opts.get("embedding"):
        in_kind = "jpeg"
    encode_side = in_kind == "jpeg" or \
        (in_kind == "unknown" and opts["permissive"])
    if len(files) > 1:
        outfile = files[1]
    else:
        outfile = _swap_ext(infile, ".lep" if encode_side else ".jpg")
    out_f = sys.stdout.buffer if outfile == "-" else open(outfile, "wb")

    _install_jail_and_inject(opts, encode_side)

    import time as _time
    _t0 = _time.perf_counter()
    try:
        out, kind = _process(data, opts)
    except (SystemExit, KeyboardInterrupt):
        raise
    except CardFault as e:
        return card_fault_exit(e)
    except BaseException as e:  # zero-byte output contract (README:62-64)
        if opts["verbosity"] > 0:
            _err(f"{type(e).__name__}: {e}")
        return int(classify(e))
    _elapsed_ms = max(1, int((_time.perf_counter() - _t0) * 1000))
    out_f.write(out)
    if out_f is not sys.stdout.buffer:
        out_f.close()
    if opts["verbosity"] > 0 and kind == "jpeg":
        _err(f"{len(out)} {len(data)}")
        _err(f"{100.0 * len(out) / max(len(data), 1):.2f}%")
        # summary block (jpgcoder.cc:806-817)
        _err(" --------------------------------- ")
        _err(f" time taken        : {_elapsed_ms:8d} msec")
        _err(f" avrg. byte per ms : {len(data) // _elapsed_ms:8d} byte")
        _err(f" avrg. comp. ratio : "
             f"{100.0 * len(out) / max(len(data), 1):8.2f} %")
        _err(" --------------------------------- ")
    if opts["verbosity"] >= 2 and kind == "jpeg":
        _print_bill(data, out)
    if opts.get("timing_log"):
        # the log fd is opened pre-jail (_prepare_for_jail): openat under
        # SECCOMP_RET_KILL_PROCESS raises SIGSYS, not OSError, so an open
        # here would kill the process instead of falling back
        from .util import timing
        tf = opts.get("_timing_log_f")
        if tf is not None:
            timing.print_timing(tf)
            tf.flush()
        else:
            try:
                with open(opts["timing_log"], "a") as tf:
                    timing.print_timing(tf)
            except OSError:
                timing.print_timing(sys.stderr)
    return 0


def _allocator_is_interposed() -> bool:
    """True when a sanitizer allocator is interposed on this process
    (ASan exports its runtime symbols into the global namespace)."""
    import ctypes
    try:
        ctypes.CDLL(None).__asan_region_is_poisoned
        return True
    except AttributeError:
        return False
    except Exception:
        return False


def _host_fallback_jailed(data: bytes, opts) -> bytes:
    """Transcode on the host codec inside a JAILED forked child.

    The -tpu process itself cannot be jailed (the CUDA runtime needs its
    files and memory maps), but the host-codec fallback parses untrusted
    input -- exactly the surface the jail exists to confine.  Fork a
    child, install the seccomp jail there, transcode, and stream the
    result back over a pipe; any child failure maps to the zero-byte
    contract.  The child runs only the torch-free host codec, so it never
    touches the CUDA state it inherits.  The parent must pre-import the
    transcode modules before its first device attempt (_prepare_for_jail):
    the child then never takes the import lock, which a hung device
    thread could be holding at fork time."""
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        try:
            os.close(r)
            child_opts = dict(opts, tpu=False, unjailed=False)
            _prepare_for_jail(child_opts)
            from .util.sandbox import install_jail
            install_jail()
            out, _ = _process(data, child_opts)
        except BaseException:
            out = b""
        try:
            written = 0
            while written < len(out):
                written += os.write(w, out[written:written + (1 << 20)])
            os.close(w)
        except BaseException:
            pass
        os._exit(0)
    os.close(w)
    chunks = []
    while True:
        b = os.read(r, 1 << 20)
        if not b:
            break
        chunks.append(b)
    os.close(r)
    os.waitpid(pid, 0)
    return b"".join(chunks)


def _install_jail_and_inject(opts, encode_side: bool) -> None:
    """Install the default-on seccomp jail (after pre-loading everything
    the transcode needs) and arm any -injectsyscall= fault injection."""
    if not opts.get("unjailed"):
        _prepare_for_jail(opts)
        from .util.sandbox import (install_jail, install_jail_stage2,
                                   prejail_heap)
        # the memory filter: pre-grow the heap to the process memory
        # envelope, then drop brk/mmap/mremap outright (the reference's
        # preallocate-then-strict-filter shape; its 176MB default arena,
        # jpgcoder.cc:829-843).  Requires PYTHONMALLOC=malloc (the
        # launcher re-execs to set it); skipped otherwise because
        # CPython's pymalloc arenas call mmap directly.  Also skipped
        # when the allocator is interposed (ASan/UBSan builds): sanitizer
        # allocators mmap on demand past the pre-grown glibc heap, so
        # stage 2 would kill clean transcodes -- stage 1 still jails
        # those runs.  Installed BEFORE the allowlist filter: that one
        # bans prctl, so no further filter can follow it.
        if os.environ.get("PYTHONMALLOC") == "malloc" and \
                os.environ.get("LEPTON_NO_STAGE2") != "1" and \
                not _allocator_is_interposed():
            budget = int(os.environ.get("LEPTON_STAGE2_HEAP", 192 << 20))
            if prejail_heap(budget):
                install_jail_stage2()
        install_jail()
    if opts.get("injectsyscall") in (1, 3):
        # banned syscall from the main thread before the transcode;
        # under the jail the process dies with SIGSYS
        from .util.sandbox import inject_syscall
        inject_syscall()
    elif opts.get("injectsyscall") == 5:
        # banned-memory syscall (stage-2 filter): direct mmap
        from .util.sandbox import inject_syscall_mmap
        inject_syscall_mmap()
    elif opts.get("injectsyscall") in (2, 4):
        from . import _native
        if encode_side:
            _native.inject_on_encode = True
        else:
            _native.inject_on_decode = True


def _prepare_for_jail(opts) -> None:
    """Pre-import every module and pre-load every shared library the host
    transcode can touch: inside the jail openat/exec are banned, so all
    code and data must be resident first (the reference preallocates
    memory and spawns workers before installing seccomp).  Loads no
    torch: the jailed host path never needs it."""
    from .util import pool, timing
    _tsnap = timing.snapshot()           # warm-up marks are dropped below
    import concurrent.futures            # noqa: F401
    import pickle                        # noqa: F401  (the parse channel)
    import zlib                          # noqa: F401
    from . import _native, host
    from .container import brotli_ffi
    from .jpeg import (bitio, decoder, huffman, imageinfo, parser,  # noqa
                       progressive, recode_progressive, recoder)
    from .container import mux, zlib0    # noqa: F401  (zlepton decode
    #                                      wraps output in-jail)
    from .container import ujg           # noqa: F401
    from .util import billing, exitcodes, membound, sandbox  # noqa: F401
    #                                      (-v2 print_bill runs in-jail)
    if opts.get("timing_log") and "_timing_log_f" not in opts:
        # the -timing= log fd must exist before the jail: openat under
        # SECCOMP_RET_KILL_PROCESS dies with SIGSYS, never OSError
        try:
            opts["_timing_log_f"] = open(opts["timing_log"], "a")
        except OSError:
            opts["_timing_log_f"] = sys.stderr
    _native.get_lib()                    # compile+dlopen before the jail
    try:
        brotli_ffi._load()               # dlopen libbrotli if present
    except OSError:
        pass
    try:
        host._apply_model_env()          # model file must be read pre-jail
        host._model_out_file()           # and the dump fd opened pre-jail
    except (OSError, host.LeptonError):
        pass
    # warm the whole codec with a tiny in-memory roundtrip: one-time lazy
    # initialization (extension-internal opens) must happen pre-jail, the
    # same way the reference preallocates and spawns workers before
    # installing seccomp (jpgcoder.cc:888, :1766)
    tiny = b"\xff\xd8" + host._BASIC_HEADER + b"\xff\xd9"
    lep = host.compress(tiny)
    host.decompress(lep)
    host.decompress_streaming(lep)    # serving's default decode path
    host.generic_compress(b"x")
    host._restricted_loads(pickle.dumps((True, None)))
    pool._warm_pool()     # thread stacks must exist before stage 2
    # the warm-up roundtrip stamped the first-write-wins timing matrix;
    # drop its marks so the real transcode's are the ones kept
    timing.restore(_tsnap)


def _print_bill(jpeg_data: bytes, lep_data: bytes) -> None:
    """Bit-level category accounting at -v2 (the reference's
    print_bill(2), jpgcoder.cc:1944, billing.hh)."""
    try:
        from . import _native, host
        from .container.format import read_container
        from .container.mux import MuxReader
        from .util.billing import print_bill
        parsed, info, dec = host._parse(jpeg_data, allow_progressive=True,
                                        allow_four_colors=True)
        mh, cs = host._truncation_geometry(info, dec)
        img = host._native_image(info, dec.planes, mh, cs)
        # the container's own segmentation, so compressed-bit totals
        # reconcile with the actual mux streams
        hdr, mux_region = read_container(lep_data)
        bcv = info.cmpnfo[0].bcv
        bounds = [th.luma_y_start for th in hdr.handoffs] + [bcv] \
            if hdr.handoffs else [0, bcv]
        segs = [_native.native_symbolize_segment(
            img, bounds[i], bounds[i + 1], i == len(bounds) - 2)
            for i in range(len(bounds) - 1)]
        demux = MuxReader(mux_region)
        stream_bytes = sum(len(demux.buffers[i])
                           for i in range(len(bounds) - 1))
        header_bytes = len(lep_data) - len(mux_region)
        print_bill(segs, sys.stderr, header_bytes=header_bytes,
                   mux_overhead_bytes=len(mux_region) - stream_bytes,
                   stream_bytes=stream_bytes)
    except Exception as e:
        _err(f"billing unavailable: {e}")


def _swap_ext(path: str, ext: str) -> str:
    base, _ = os.path.splitext(path)
    return base + ext


def _parse_size(s: str) -> int:
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1].lower()]
        s = s[:-1]
    return int(s) * mult


def _write_info(data: bytes) -> None:
    """Structure report for a JPEG (write_info, jpgcoder.cc:5612-5682)."""
    from .jpeg.imageinfo import image_info_from_header
    from .jpeg.parser import parse_jpeg
    parsed = parse_jpeg(data)
    info = image_info_from_header(parsed.hdrdata)
    w = sys.stdout.write
    w("<Infofile for JPEG image:>\n\n\n")
    w("coding process: %s\n" % (
        "sequential" if info.jpegtype == 1 else "progressive"))
    w("imageheight: %d / imagewidth: %d\n" % (info.imgheight, info.imgwidth))
    w("component count: %d\n" % info.cmpc)
    w("mcu count: %d/%d/%d (all/v/h)\n\n" % (info.mcuc, info.mcuv,
                                               info.mcuh))
    w("\nfile header structure:\n")
    w(" type  length   hpos\n")
    hdr = parsed.hdrdata
    hpos = 0
    while hpos < len(hdr):
        t = hdr[hpos + 1] if hpos + 1 < len(hdr) else 0
        ln = 2 + ((hdr[hpos + 2] << 8 if hpos + 2 < len(hdr) else 0)
                  + (hdr[hpos + 3] if hpos + 3 < len(hdr) else 0))
        w(" FF%2X  %6d %6d\n" % (t, ln, hpos))
        hpos += ln
    w(" _END       0 %6d\n\n" % hpos)
    for c in range(info.cmpc):
        ci = info.cmpnfo[c]
        w("\ncomponent number %d ->\n" % c)
        w("sample factors: %d/%d (v/h)\n" % (ci.sfv, ci.sfh))
        w("blocks per mcu: %d\n" % ci.mbs)
        w("block count (mcu): %d/%d/%d (all/v/h)\n" % (ci.bc, ci.bcv,
                                                        ci.bch))
        # ImageInfo keeps no single-scan block total; the reference's
        # cmpnfo[].nc is ncv * nch (setup_imginfo)
        w("block count (sng): %d/%d/%d (all/v/h)\n" % (ci.ncv * ci.nch,
                                                        ci.ncv, ci.nch))
        q = info.qtables[ci.qtable_index]
        w("quantiser table ->")
        for i in range(64):
            if i % 8 == 0:
                w("\n")
            w("%4d, " % q[i])
        w("\n\n")


def _process(data: bytes, opts) -> tuple:
    from .host import REQUEST_ERRORS, LeptonError, compress_any, decompress_all
    kind = sniff(data)
    if opts.get("embedding") and kind != "jpeg":
        # -embedding declares a JPEG at an offset; the sniff bytes are prefix
        kind = "jpeg"
    if opts.get("trunc") and kind == "jpeg":
        data = data[:opts["trunc"]]
    if opts.get("info") and kind == "jpeg":
        _write_info(data)
        sys.exit(0)
    if kind == "jpeg" and opts.get("ujg"):
        from .host import ujg_compress
        _host_route(opts, "-ujg")
        return ujg_compress(
            data, allow_progressive=opts["allow_progressive"]), "jpeg"
    if kind == "jpeg":
        # the device encode covers the plain paths; slice/embedding/4:4
        # variants stay on the host codec (same output contract)
        host_only = [flag for flag, on in (
            ("-startbyte", opts.get("start_byte")),
            ("-embedding", opts.get("embedding")),
            ("-allow34sampling", opts.get("allow_34_sampling")),
            ("-evensplit", opts["even_split"])) if on]
        use_tpu = opts.get("tpu") and not host_only
        if host_only:
            _host_route(opts, " ".join(host_only))
        kwargs = dict(
            permissive=opts["permissive"], verify=opts["verify"],
            max_threads=opts["max_threads"], min_threads=opts["min_threads"],
            even_split=opts["even_split"],
            allow_progressive=opts["allow_progressive"],
            version=opts["version"],
            start_byte=opts.get("start_byte", 0),
            embedding=opts.get("embedding", 0),
            allow_four_colors=opts.get("allow_four_colors", False),
            allow_34_sampling=opts.get("allow_34_sampling", False))
        if use_tpu:
            # pre-import the transcode modules so a fallback fork never
            # takes the import lock a hung device thread could hold --
            # and so the JAILED parse child below never opens a file
            _prepare_for_jail(dict(opts))
            # the happy path parses the untrusted JPEG in a jailed forked
            # child (host._parse_jpeg_jailed), mirroring the reference's
            # jail-before-read_jpeg ordering (jpgcoder.cc:1766,2270);
            # only an EXPLICIT -unjailed opts out (the device path itself
            # sets opts["unjailed"] for the device process)
            kwargs["jailed_parse"] = not opts.get("user_unjailed")
            try:
                return on_card(lambda: compress_any(
                    data, engine="device", device=opts["device"],
                    **kwargs)), "jpeg"
            except REQUEST_ERRORS as e:    # a CardFault raises through
                _err(f"tpu encode failed ({type(e).__name__}: {e}); "
                     "falling back to the host codec (jailed child)")
                out = _host_fallback_jailed(data, opts)
                if out:
                    return out, "jpeg"
                raise   # keep the typed failure for exit-code mapping
        return compress_any(data, engine="host", **kwargs), "jpeg"
    if kind == "ujg":
        from .host import ujg_decompress
        _host_route(opts, "a UJG file")
        return ujg_decompress(data), "lepton"
    if kind == "zlepton":
        # a zlepton file is a lepton container with the zeta magic swapped
        # in (jpgcoder.cc:552); decoding one forces stored-zlib output
        data = LEPTON_HEADER + data[2:]
        kind = "lepton"
        opts = dict(opts, zlib0=True)
    if kind == "lepton" and opts.get("zlib0"):
        # decode output rides in a stored-mode zlib stream (jpgcoder.cc:
        # 2204-2220: zlepton input or -zlib0 forces compressed output)
        from .container.zlib0 import zlib0_wrap
        _host_route(opts, "-zlib0 or a zlepton file")
        return zlib0_wrap(decompress_all(data)), "lepton"
    if kind == "lepton" and opts.get("tpu") and \
            not opts.get("recodememory"):
        # device decode (token decode on the card, Huffman re-emit on the
        # host); multi-container concatenations and mode-Y containers,
        # which the card does not decode, take the host decoder
        from .host import _container_end
        if data[3:4] == b"Y":
            _host_route(opts, "a mode-Y container")
        elif _container_end(data, 0) == len(data):
            from .api import decompress_device
            _prepare_for_jail(dict(opts))   # see _host_fallback_jailed
            try:
                return on_card(lambda: decompress_device(
                    data, device=opts["device"])), "lepton"
            except REQUEST_ERRORS as e:    # a CardFault raises through
                _err(f"tpu decode failed ({type(e).__name__}: {e}); "
                     "falling back to the host decoder (jailed child)")
                out = _host_fallback_jailed(data, opts)
                if out:
                    return out, "lepton"
                raise
        else:
            _host_route(opts, "a concatenation of containers")
        return decompress_all(data), "lepton"
    if kind == "lepton":
        from .host import _container_end, decompress_streaming
        if opts.get("recodememory"):
            _host_route(opts, "-recodememory")
            from .container.format import read_container
            from .jpeg.imageinfo import image_info_from_header
            from .util.membound import decompression_memory_bound
            hdr, _ = read_container(data)
            info = image_info_from_header(hdr.hdrdata, allow_34=True)
            # decompress_streaming runs the full-framebuffer decode for
            # v3/progressive/truncated containers; the bound must be
            # checked for the decode that will actually run
            will_stream = (hdr.version != 3 and hdr.mode == ord("Z")
                           and not hdr.early_eof)
            need = decompression_memory_bound(
                info, hdr.num_threads, hdr.original_size,
                streaming=will_stream)
            if need > opts["recodememory"]:
                _err("decompression memory bound exceeded")
                sys.exit(38)  # ExitCode::TOO_MUCH_MEMORY_NEEDED
            # honor the declared bound with the O(width) streaming decode
            return decompress_streaming(data), "lepton"
        if opts.get("serving") and _container_end(data, 0) == len(data):
            # serving decodes O(width) by default: per-connection children
            # keep a 2-row ring instead of the full framebuffer, so
            # max_children concurrent decodes fit a bounded footprint;
            # concatenations take decompress_all
            return decompress_streaming(data), "lepton"
        return decompress_all(data), "lepton"
    if opts["permissive"]:
        from .host import generic_compress
        return generic_compress(data), "generic"
    raise LeptonError("unknown file type (use -permissive for raw bytes)")


def lepcat_merge(datas) -> bytes:
    """Merge .lep containers with a shared mega-header (concat.cc:28-139).

    All per-file header blocks are decompressed, joined with CNT
    continuation markers, recompressed once (brotli q11) into the first
    section; follower sections carry a zero header-size field and each
    section's trailing LE32 holds its own section length."""
    from .container import brotli_ffi
    fixed = [bytearray(d[:28]) for d in datas]
    fixed[0][0:2] = LEPTON_HEADER
    headers = []
    bodies = []
    for d, f28 in zip(datas, fixed):
        if d[2] < 2:
            raise ValueError("only v2+ files support concatenation")
        if d[4] != datas[0][4]:
            raise ValueError("all thread counts must match for concatenation")
        hs = int.from_bytes(f28[24:28], "little")
        headers.append(brotli_ffi.decompress(d[28:28 + hs]))
        bodies.append(d[28 + hs:])
        f28[24:28] = bytes(4)
    mega = bytearray()
    for i, h in enumerate(headers):
        if i:
            if mega[-3:] == b"CMP":
                mega[-3:] = b"CNT"
            else:
                mega += b"CNT"
        mega += h
    cmega = brotli_ffi.compress(bytes(mega), quality=11)
    out = bytearray()
    for i, (f28, body) in enumerate(zip(fixed, bodies)):
        sec = bytearray(f28)
        if i == 0:
            sec[24:28] = len(cmega).to_bytes(4, "little")
            sec += cmega
        sec += body
        sec[-4:] = len(sec).to_bytes(4, "little")
        out += sec
    return bytes(out)


def _lepcat(files) -> int:
    """-lepcat: all file args are inputs, merged stream to stdout
    (matching the reference, where concatenate_files writes to fd 1)."""
    if not files:
        _err("lepcat requires input files")
        return 1
    datas = [open(f, "rb").read() for f in files]
    try:
        sys.stdout.buffer.write(lepcat_merge(datas))
    except ValueError as e:
        _err(str(e))
        return 1
    return 0


def _benchmark(files=None, reps: int = 10, bench_threads: int = 1) -> int:
    """Reference -benchmark semantics (benchmark.cc:66-263): fork
    `bench_threads` parallel codecs, each roundtripping the input
    `reps` times with an md5 gate, and report aggregate bytes/sec
    (g_benchmark_throughput_bytes_per_second).  With no input file the
    embedded tiny JPEG is used (smalljpg.hh equivalent)."""
    import hashlib
    import time as _time
    from .host import _BASIC_HEADER, compress, compress_any, decompress

    if files:
        data = open(files[0], "rb").read()
    else:
        data = b"\xff\xd8" + _BASIC_HEADER + b"\xff\xd9"
    want = hashlib.md5(data).hexdigest()

    def one_worker() -> int:
        for _ in range(reps):
            lep = compress(data)
            out = decompress(lep)
            if hashlib.md5(out).hexdigest() != want:
                return 1
        return 0

    # warm (imports, .so load) outside the timed region, like the
    # reference's preload
    compress_any(data, verify=True)
    t0 = _time.perf_counter()
    if bench_threads <= 1:
        rc = one_worker()
        if rc:
            _err("benchmark md5 mismatch")
            return 1
    else:
        pids = []
        for _ in range(bench_threads):
            pid = os.fork()
            if pid == 0:
                # an exception must not escape os._exit: it would unwind
                # into the parent's interpreter-teardown (atexit handlers,
                # interleaved traceback) inside the forked child
                try:
                    rc_child = one_worker()
                except BaseException:
                    rc_child = 1
                os._exit(rc_child)
            pids.append(pid)
        bad = 0
        for pid in pids:
            _, status = os.waitpid(pid, 0)
            bad |= os.waitstatus_to_exitcode(status)
        if bad:
            _err("benchmark md5 mismatch in a forked codec")
            return 1
    dt = _time.perf_counter() - t0
    total = len(data) * reps * max(bench_threads, 1)
    _err(f"benchmark: {total} bytes in {dt:.3f}s over "
         f"{bench_threads} codec(s) x {reps} reps")
    _err(f"throughput: {total / dt:.0f} bytes/sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
