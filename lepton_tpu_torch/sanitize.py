"""The port's sanitizer runs, the twin of tools/sanitize.sh, in two halves.

Run: python -m lepton_tpu_torch.sanitize host [--tests PATH ...] [--soak N]
     python -m lepton_tpu_torch.sanitize card [--photos DIR] [--out FILE]

host (on the CPU, no card): builds the port's _native/leptonc.c with
tools/sanitize.sh's flags (gcc -O1 -g -fsanitize=address,undefined
-fno-sanitize-recover=all -fPIC -shared) into build/libleptonc_torch_asub.so
and runs, in subprocesses that load it (LEPTONC_TORCH_SO) with gcc's
libasan and libubsan preloaded (LD_PRELOAD) and ASAN_OPTIONS=detect_leaks=0,
pytest over HOST_TESTS (the tests/test_torch_*.py files that reach
leptonc.c, the jailed CLI and parse among them; --tests narrows them)
and a host-side hostile sweep
(soak.run of --soak cases at most 48 px a side on the CPU, whose oracle
is the host codec).  It prints "sanitizer suite clean" and exits 0 only
when every run is clean; any report ends its process non-zero
(-fno-sanitize-recover=all) and the run exits 1.  It takes minutes: the
sanitized library is several times slower, and the port's tests run the
JAX package beside it.

What cannot run under ASan, as tools/sanitize.sh:12-14 leaves out
test_sandbox.py and test_serve_suite.py, is deselected (HOST_DESELECT):
  - test_torch_cli.py::test_injected_syscall_is_killed[5], a direct mmap
    that the jail's second stage must kill.  That stage (the memory
    filter, which bans mmap and brk) is skipped by design when the
    allocator is interposed (cli._install_jail_and_inject), because
    ASan's allocator maps pages on demand; so under ASan the mmap
    succeeds and the process exits 0.  The jail's first stage, the
    jailed CLI and the jailed parse run, and pass.
detect_leaks=0 because Python, torch and jaxlib are not instrumented and
keep their allocations to exit: the leak report would name theirs.
No other report is suppressed, and none that points into leptonc.c.

card (on the card): the bounds-checked build of every csrc/*.cu kernel
(kernels/cuda_build.py, LEPTON_TORCH_CHECKED_KERNELS=1; without the
variable set it runs itself again in a subprocess with it set).  It runs
the negative checks first (NEGATIVE: hand-made inputs whose indices leave
a buffer, each of which must raise cuda_build.KernelBoundsError naming
its site), then soak.hostile_only (python -m lepton_tpu_torch.soak
--hostile-only), a small soak (soak.run of SOAK_CASES cases and the
multi-segment cases, as --n SOAK_CASES runs it), the main batch
(main_batch: four 4032x3024 q90 photos, 16 segments each, 64 lanes, v1
and v3, encode and decode, with the planes of one decode_lanes launch
each) and the roofline probe's chains against their plain loops.  Its
last line is one JSON object of digests of every output, the soak's
outcome counts and .lep digests, the kernel times and the negative
checks' messages; chip_smoke.py phase 19 holds the digests equal to the
default build's.  A bounds violation anywhere raises and exits 1.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

from . import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASAN_SO = os.path.join(_native.BUILD_DIR, "libleptonc_torch_asub.so")
ASAN_FLAGS = ["-O1", "-g", "-fsanitize=address,undefined",
              "-fno-sanitize-recover=all", "-fPIC", "-shared"]
ASAN_OPTIONS = "detect_leaks=0"
# the port's tests that reach leptonc.c
HOST_TESTS = tuple(f"tests/test_torch_{n}.py" for n in (
    "host_codec", "segment_codec", "robustness", "truncated_segments",
    "past_cut", "soak_segments", "cli", "progressive", "encode",
    "decompress"))
# what cannot pass under ASan (see the docstring)
HOST_DESELECT = ("tests/test_torch_cli.py::test_injected_syscall_is_killed[5]",)
SOAK_SIDE = 48
SOAK_CASES = 12
CLEAN = "sanitizer suite clean"
CLEAN_CARD = "checked kernels clean"


# ---------------------------------------------------------------------------
# Host half: ASan + UBSan on leptonc.c
# ---------------------------------------------------------------------------


def build_sanitized(src: str = _native._SRC, out: str = ASAN_SO) -> str:
    """Compile `src` with ASAN_FLAGS into `out` (through a temporary file,
    renamed when done); returns `out`.  Raises CalledProcessError."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(["gcc", *ASAN_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def sanitizer_env(so: str = ASAN_SO) -> dict:
    """The environment of a sanitized run: gcc's libasan and libubsan
    preloaded (Python itself is not instrumented), leaks not reported,
    and the port's native library taken from `so`."""
    libs = [subprocess.run(["gcc", f"-print-file-name={n}"], check=True,
                           capture_output=True, text=True).stdout.strip()
            for n in ("libasan.so", "libubsan.so")]
    env = dict(os.environ)
    env.update(LD_PRELOAD=" ".join(libs), ASAN_OPTIONS=ASAN_OPTIONS,
               UBSAN_OPTIONS="print_stacktrace=1")
    env[_native.SO_ENV] = so
    return env


def run_sanitized(cmd, so: str = ASAN_SO, **kw) -> subprocess.CompletedProcess:
    """Run `cmd` from the repository root under sanitizer_env(so)."""
    return subprocess.run(cmd, cwd=REPO, env=sanitizer_env(so), **kw)


SOAK_SCRIPT = """
import sys
from lepton_tpu_torch import soak
r = soak.run({n}, 0, "cpu", out=None, max_side={side}, log=print)
print("soak:", r.cases, "cases,", r.failed, "failed checks,", r.counts)
sys.exit(1 if r.failed else 0)
"""


def host(tests=HOST_TESTS, soak_cases: int = SOAK_CASES,
         log=print) -> int:
    """The host half: 0 when every sanitized run is clean, else 1."""
    t = time.perf_counter()
    build_sanitized()
    log(f"sanitize host: built {os.path.relpath(ASAN_SO, REPO)} "
        f"({' '.join(ASAN_FLAGS)}) in {time.perf_counter() - t:.1f} s")
    runs = []
    if tests:
        deselect = [a for d in HOST_DESELECT for a in ("--deselect", d)]
        runs.append(("pytest", [sys.executable, "-m", "pytest", "-q",
                                "-p", "no:cacheprovider", "-p", "no:xdist",
                                *deselect, *tests]))
    if soak_cases:
        runs.append(("soak", [sys.executable, "-c", SOAK_SCRIPT.format(
            n=soak_cases, side=SOAK_SIDE)]))
    rc = 0
    for name, cmd in runs:
        t = time.perf_counter()
        r = run_sanitized(cmd)
        log(f"sanitize host: {name} exited {r.returncode} in "
            f"{time.perf_counter() - t:.1f} s")
        rc = rc or r.returncode
    if rc:
        log("sanitize host: NOT clean")
        return 1
    log(CLEAN)
    return 0


# ---------------------------------------------------------------------------
# Card half: the bounds-checked kernels
# ---------------------------------------------------------------------------

PHOTO_SEED = 20240601       # bench.make_photo's photos (chip_smoke phase 4)
PHOTO_SIZE = (4032, 3024)
PHOTOS = 4
SEGMENTS = 16
HOSTILE_CASES = 60          # python -m lepton_tpu_torch.soak --hostile-only
PROBE_ITERS = 2000          # steps of each roofline chain held to its loop
PROBE_CHAINS = (("rmw", 1), ("rmw", 2), ("rmw", 4), ("rmw", 8),
                ("alu", 1), ("mixed", 1))
# the kernels' CUDA-event times in the main batch's stats, by the kernel
# rows of chip_smoke.py (a coder's: the whole coder, sort, probability
# stage and walk)
STAT_MS = {"run_heads": "heads_ms", "walk_runs": "runs_ms",
           "vpx_coder": "coder_ms", "ans_coder": "ans_coder_ms",
           "vpx_decoder": "vpx_decoder_ms", "ans_reader": "ans_decoder_ms"}


def digest(data) -> str:
    """A short sha256 of bytes or of a tensor's contents."""
    if hasattr(data, "cpu"):
        data = data.cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:24]


def photos(directory=None) -> list:
    """The main batch's JPEGs: the sorted *.jpg of `directory`, or made
    by bench.make_photo from PHOTO_SEED."""
    if directory:
        names = sorted(n for n in os.listdir(directory) if n.endswith(".jpg"))
        out = []
        for n in names:
            with open(os.path.join(directory, n), "rb") as f:
                out.append(f.read())
        return out
    from .bench import make_photo
    return [make_photo(PHOTO_SEED + k, *PHOTO_SIZE) for k in range(PHOTOS)]


def main_batch(dev, blobs, runs: int = 2, segments: int = SEGMENTS) -> dict:
    """The main batch through the card both ways, v1 (VPX lanes) and v3
    (rANS lanes), `runs` times (the kernel times are the last run's, so a
    first launch's module load is not among them): batch_compress_device
    in `segments` segments an image, batch_decompress_device back, and one
    decode_lanes launch of the files' plan for the planes and err flags.
    Returns {"v1" / "v3": digests of every .lep, the planes and the err
    flags, lanes, and the kernels' ms (CUDA events; None on the CPU)}.
    Raises AssertionError when a decode does not give the originals
    back."""
    import torch

    from . import api
    from .kernels import vpx_decoder
    out = {}
    for version, coder in ((1, "vpx"), (3, "ans")):
        for _ in range(runs):
            enc, dec = {}, {}
            leps = api.batch_compress_device(blobs, segments, device=dev,
                                             stats=enc, version=version)
            back = api.batch_decompress_device(leps, device=dev, stats=dec)
            plan = vpx_decoder.plan_decode(
                [api._decode_request(lep, i)[0] for i, lep in
                 enumerate(leps)], coder)
            coef, err = vpx_decoder.decode_lanes(**plan.to(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if back != blobs:
            raise AssertionError(f"v{version}: the main batch does not "
                                 "decode to its originals")
        stats = {**enc, **dec}
        walk = "vpx_coder" if version == 1 else "ans_coder"
        reader = "vpx_decoder" if version == 1 else "ans_reader"
        out[f"v{version}"] = dict(
            lep=[digest(b) for b in leps], lep_bytes=sum(map(len, leps)),
            planes=digest(coef), err=int(err.sum()), lanes=len(err),
            ms={k: stats.get(STAT_MS[k])
                for k in ("run_heads", "walk_runs", walk, reader)})
    return out


def _expect(what: str, site: str, fn) -> str:
    """Run fn, which must raise KernelBoundsError at `site`; returns its
    message."""
    import torch

    from .kernels import cuda_build
    try:
        fn()
        torch.cuda.synchronize()
    except cuda_build.KernelBoundsError as e:
        if e.site != site:
            raise AssertionError(f"{what}: {e}; expected the check {site}")
        return str(e)
    raise AssertionError(f"{what}: no KernelBoundsError (expected the "
                         f"check {site})")


def negative_checks(dev) -> dict:
    """Hand-made inputs whose indices leave their buffers, each through
    the checked build: {what: the KernelBoundsError's message}.  The
    decoder's plans go through vpx_decoder.launch_lanes, past the host
    checks of decode_lanes, which refuse each of them first (ValueError,
    checked too).  A coder lane whose output outgrows its cap is no
    violation (the walk stops writing at cap and the wrapper relaunches
    it), so the coders' checks are a rANS lane whose symbol count runs
    past its row and a run head past the keys.  After them a good plan
    decodes: the record was cleared and the context survived."""
    import dataclasses

    import numpy as np
    import torch

    from . import api, soak
    from .kernels import ans_coder, branch_probs, vpx_decoder
    lep = soak.tiny_container(1)
    plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]], "vpx")

    def edited(**arrays):
        out = dataclasses.replace(plan, **{k: getattr(plan, k).copy()
                                           for k in arrays})
        for k, (ix, v) in arrays.items():
            getattr(out, k)[ix] = v
        return out

    last = len(plan.lanes) - 1
    plans = {
        "a row's out_block past the planes": (
            edited(rows=((0, 6), plan.n_blocks)), "coef"),
        "a lane of ntab = 5 colour tables": (
            edited(lanes=((0, 3), 5)), "ntab"),
        "a lane whose rows run past the row table": (
            edited(lanes=((last, 1), plan.lanes[last, 1] + 1)), "row"),
        "a stream longer than its row of bytes": (
            dataclasses.replace(plan, data=np.ascontiguousarray(
                plan.data[:, :4])), "vpx_bytes"),
    }
    out = {}
    for what, (bad, site) in plans.items():
        try:
            vpx_decoder.decode_lanes(**bad.to(dev))
        except ValueError:
            pass
        else:
            raise AssertionError(f"{what}: decode_lanes took the plan")
        out[what] = _expect(what, site, lambda bad=bad:
                            vpx_decoder.launch_lanes(**bad.to(dev)))
    probs = torch.full((1, 64), 128, dtype=torch.uint8, device=dev)
    bit = torch.zeros((1, 64), dtype=torch.uint8, device=dev)
    nsyms = torch.tensor([200], dtype=torch.int32, device=dev)
    what = "a rANS lane of 200 symbols in a row of 64"
    out[what] = _expect(what, "stage",
                        lambda: ans_coder.ans_walk(probs, bit, nsyms))
    idx = torch.arange(1000, 1064, dtype=torch.int32,
                       device=dev).reshape(1, 64)
    keys, shift = branch_probs.group(idx, bit)
    heads = torch.tensor([keys.numel() + 5], dtype=torch.int64, device=dev)
    what = "a run head past the keys"
    out[what] = _expect(what, "keys", lambda: branch_probs.walk_runs(
        keys, shift, heads, idx.shape))
    coef, err = vpx_decoder.decode_lanes(**plan.to(dev))
    if err.any():
        raise AssertionError("the good plan decodes flagged after the "
                             "negative checks")
    return out


def probe_chains(dev) -> dict:
    """Each roofline chain's checksum on the card against its plain loop
    ({chain: checksum}); raises AssertionError on a difference."""
    from .probes import decode_roofline as dr
    out = {}
    for kind, K in PROBE_CHAINS:
        for shared in ((False,) if kind == "alu" else (False, True)):
            got = int(dr.probe(kind, PROBE_ITERS, K, shared, dev).item())
            if got != dr.probe_plain(kind, PROBE_ITERS, K, shared):
                raise AssertionError(f"probe {kind} K={K} shared={shared}: "
                                     "kernel and plain loop differ")
            out[f"{kind} K={K}{' shared' if shared else ''}"] = got
    return out


def card(photo_dir=None, out_path=None, log=print) -> dict:
    """The card half in this process, which must have the checked builds
    (LEPTON_TORCH_CHECKED_KERNELS=1).  Returns the result object."""
    import torch

    from . import api, soak
    from .kernels import cuda_build
    if not cuda_build.checked():
        raise RuntimeError(f"sanitize card needs {cuda_build.CHECKED_ENV}=1")
    dev = api._device(None)
    seconds = {}
    t = time.perf_counter()
    cuda_build.build([n for n in cuda_build.SOURCES
                      if cuda_build.stale(n, True)], (True,))
    seconds["build"] = time.perf_counter() - t
    t = time.perf_counter()
    negative = negative_checks(dev)
    seconds["negative"] = time.perf_counter() - t
    for what, msg in negative.items():
        log(f"sanitize card: {what}: {msg}")
    t = time.perf_counter()
    readers, coders = soak.hostile_only(HOSTILE_CASES, 0, dev)
    seconds["hostile"] = time.perf_counter() - t
    log(f"sanitize card: hostile readers {readers}; coders {coders}")
    t = time.perf_counter()
    report = soak.run(SOAK_CASES, 0, dev, out=None, log=log,
                      multi=soak.MULTI_SEGMENTS)
    seconds["soak"] = time.perf_counter() - t
    if report.failed:
        raise AssertionError(f"the soak failed {report.failed} checks: "
                             f"{report.failures[:4]}")
    log(f"sanitize card: soak of {report.cases} cases, outcome counts "
        f"{report.counts}")
    t = time.perf_counter()
    blobs = photos(photo_dir)
    main = main_batch(dev, blobs)
    seconds["main"] = time.perf_counter() - t
    log(f"sanitize card: main batch {json.dumps(main)}")
    t = time.perf_counter()
    probe = probe_chains(dev)
    seconds["probe"] = time.perf_counter() - t
    torch.cuda.synchronize(dev)
    res = dict(
        checked=True, card=torch.cuda.get_device_name(dev),
        sites={n: len(cuda_build.check_sites(n)) for n in cuda_build.SOURCES},
        negative=negative, hostile={"readers": readers, "coders": coders},
        soak=dict(cases=report.cases, counts=report.counts,
                  failed=report.failed,
                  leps={i: digest(b) for i, b in report.leps.items()
                        if i < SOAK_CASES}),
        main=main, probe=probe, seconds=seconds, ok=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="half", required=True)
    h = sub.add_parser("host", help="ASan+UBSan on leptonc.c (CPU)")
    h.add_argument("--tests", nargs="*", default=list(HOST_TESTS),
                   help="pytest paths or node ids (none: no pytest run)")
    h.add_argument("--soak", type=int, default=SOAK_CASES,
                   help="cases of the host-side soak (0: none)")
    c = sub.add_parser("card", help="the bounds-checked kernels (card)")
    c.add_argument("--photos", default=None,
                   help="a directory of the main batch's *.jpg (default: "
                        "made from PHOTO_SEED)")
    c.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if args.half == "host":
        return host(args.tests, args.soak)
    from .kernels import cuda_build
    if not cuda_build.checked():
        # the checked builds are chosen as the libraries first load
        env = dict(os.environ, **{cuda_build.CHECKED_ENV: "1"})
        return subprocess.run([sys.executable, "-m", __spec__.name,
                               *(argv if argv is not None else sys.argv[1:])],
                              env=env).returncode
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    res = card(args.photos, args.out, log)
    log(CLEAN_CARD)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
