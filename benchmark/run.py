"""Run one cell of the benchmark once, on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name (spec.py).  Set-up makes the cell's images
from the seed (fixtures.py), loads the program (lepton_tpu_torch, whose
kernels and host library are built into build/ inside the checkout on a
checkout's first run) and makes the traffic driver's warm calls; then the
driver's closed loop runs for --seconds.  With --trace 0 the last line of
stdout is the cell's end-to-end metrics; with --trace 1 the window runs
under torch.profiler and the line holds the per-layer metrics, the
device's busy seconds and the breakdown.  After the window, check.py
judges every output; the numbers it compared, each with its limit, are the
last lines of stderr and the last key of the result line ("checks").

It exits 2 and prints no result without CUDA or with fewer cards than the
cell asks for, and 3 where jax, jaxlib, flax or lepton_tpu (by whole
top-level module name) is loaded once the window has closed.  --control
puts the control in the program's place for the comparison (check.py);
the benchmark's own runs never pass it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import spec

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lepton_tpu")
# variables that would make the program depart from the configuration:
# a trained start model (other .lep bytes) or the bounds-checked kernels
DEPARTURES = ("LEPTON_COMPRESSION_MODEL", "LEPTON_TORCH_CHECKED_KERNELS")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no departure from the
    configuration."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    for name in DEPARTURES:
        os.environ.pop(name, None)


class Context:
    """What a traffic driver is given.  allow_progressive is the entry
    points' argument of that name, the configuration's
    (spec.allow_progressive)."""

    def __init__(self, api, device, cell, images, caller):
        self.api = api
        self.device = device
        self.config = cell.config
        self.traffic = cell.traffic
        self.images = images
        self.caller = caller
        self.num_segments = cell.config["container"]["num_segments"]
        self.version = cell.config["container"]["version"]
        self.allow_progressive = spec.allow_progressive(cell.config)
        self.setup_records = []


class Run:
    """What the metric readers read: the window's requests, its length,
    the set-up's seconds, the trace (None in an untraced run) and the
    cell's images."""

    def __init__(self, requests, window_s, setup_s, trace, images, made):
        self.requests = requests
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace
        self.images = images
        self.leps = {}
        for req in list(made) + list(requests):
            if req.makes == "lep" and not req.error:
                for i, out in zip(req.images, req.outputs):
                    self.leps.setdefault(i, out)
        self._lanes = {}

    def of(self, label: str) -> list:
        """The window's requests of one label that did not raise."""
        return [r for r in self.requests if r.label == label and not r.error]

    def jpeg_mb(self, req) -> float:
        return sum(len(self.images[i]) for i in req.images) / 1e6

    def lanes(self, i: int):
        """The coded streams (lanes) of image i's .lep by its mux, or None
        where no call made one or it does not read."""
        if i not in self._lanes:
            from .check import lanes_of
            lep = self.leps.get(i)
            self._lanes[i] = None if lep is None else lanes_of(lep)
        return self._lanes[i]

    def blocks(self, i: int) -> int:
        from .roofline import jpeg_blocks
        return jpeg_blocks(self.images[i])


def _device_info(torch, device, peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def _card_state() -> str:
    """nvidia-smi's name, power limit, SM clock (now and at most),
    temperature and power draw of the first card."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _stages(requests) -> str:
    """Each numeric stats key's median over the window's calls, by label."""
    import statistics
    out = []
    for label in sorted({r.label for r in requests}):
        keys = {}
        for r in requests:
            if r.label == label and not r.error:
                for k, v in r.stats.items():
                    if isinstance(v, (int, float)):
                        keys.setdefault(k, []).append(v)
        out.append(label + " " + " ".join(
            f"{k} {statistics.median(v):.4g}" for k, v in keys.items()))
    return "; ".join(out)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False, cell=None,
             workers: int = None, t0: float = None) -> dict:
    """One run of a cell: the result line's object.  device="cpu" runs the
    program's plain versions (the tests' rehearsal); cell: a spec.Cell in
    place of BENCHMARK.json's (the tests' tiny copies)."""
    from . import fixtures
    from .calls import Caller
    from .check import judge
    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or spec.cell(name)
    driver = spec.driver(cell.traffic)
    import torch
    from lepton_tpu_torch import api
    dev = torch.device(device)
    t = time.perf_counter()
    images = fixtures.images(cell.config, seed,
                             driver.images_needed(cell.traffic))
    phases = {"images_s": time.perf_counter() - t}
    ctx = Context(api, dev, cell, images, Caller(trace))
    state = driver.setup(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    requests = []
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer()
        tracer.start()
    start = time.perf_counter()
    setup_s = start - t0
    driver.window(ctx, state, seconds, requests)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    end = max([r.t1 for r in requests], default=time.perf_counter())
    card = _card_state() if dev.type == "cuda" else "cpu"
    t = time.perf_counter()
    summary = tracer.stop() if tracer else None
    phases.update(setup_s=setup_s, window_s=end - start,
                  trace_s=time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(requests, end - start, setup_s, summary, images,
              ctx.setup_records)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = _device_info(torch, dev, peak)
    if trace:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    t = time.perf_counter()
    checks, failed = judge(images, requests, ctx.setup_records, cell.config,
                           cell.traffic, seed, dev.type == "cuda", control,
                           workers)
    phases["check_s"] = time.perf_counter() - t
    if run.leps:
        print(f"ratio: {sum(map(len, run.leps.values()))} .lep bytes of "
              f"{sum(len(images[i]) for i in run.leps)} JPEG bytes, "
              f"{len(run.leps)} images", file=sys.stderr)
    print("phases: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; {len(requests)} calls", file=sys.stderr)
    print(f"stages (medians): {_stages(requests)}", file=sys.stderr)
    print(f"card after the window: {card}", file=sys.stderr)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": sum(len(r.images) for r in requests),
              "failed": failed, "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    _environment()
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found; no result", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", args.control, cell, t0=T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
