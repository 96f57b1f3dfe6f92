"""One call into the program's entry points, as the window records it.

Caller.call runs fn(stats) between two host clock reads and keeps what the
judgement after the window needs: the images the call was given, its
outputs (or the error it raised), the program's stats dict for it, how many
times each kernel launched and whether it took the host's Python segment
codec (check.py counts a call on the card in which a kernel that its path
needs did not launch as one that ran a plain version).  An output equal
to its image's first is held as that first object, so that the window
keeps one copy of each distinct output.
"""
from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Request:
    label: str            # "encode", "decode", "upload", "read"
    makes: str            # "lep" or "jpeg": what its outputs are
    images: List[int]     # the cell's image indices, one an output
    t0: float
    t1: float = 0.0
    stats: dict = field(default_factory=dict)
    launched: dict = field(default_factory=dict)   # launches by kernel
    host_routes: int = 0
    error: Optional[str] = None
    outputs: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _launch_counters() -> dict:
    """Every kernel wrapper of the program that counts its launches: a
    callable of a lepton_tpu_torch.kernels module with an int attribute
    `launches` (named by the callable) or `<coder>_launches` (named
    `<callable>.<attribute>`), found by looking, so that a kernel a later
    change adds is counted too."""
    found = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("lepton_tpu_torch.kernels.") or module is None:
            continue
        for value in vars(module).values():
            if not callable(value) or not hasattr(value, "__dict__"):
                continue
            for attr, count in vars(value).items():
                if (attr == "launches" or attr.endswith("_launches")) \
                        and isinstance(count, int):
                    key = getattr(value, "__name__", repr(value))
                    if attr != "launches":
                        key += "." + attr
                    found[key] = (value, attr)
    return found


class Caller:
    """Times and records calls; trace=True opens a host span a call."""

    def __init__(self, trace: bool = False):
        from lepton_tpu_torch import host
        # import every kernel module the entry points use, so that their
        # counters are found before the first call
        from lepton_tpu_torch import api  # noqa: F401
        self.routes = host.SEGMENT_CODEC_ROUTES
        self.counters = _launch_counters()
        self.trace = trace
        self.kept = {}       # (makes, image): the first output of its kind

    def launches(self) -> dict:
        return {k: getattr(f, a) for k, (f, a) in self.counters.items()}

    def call(self, label: str, makes: str, images, fn) -> Request:
        req = Request(label, makes, list(images), 0.0)
        launches, routes = self.launches(), self.routes["python"]
        req.t0 = time.perf_counter()
        try:
            if self.trace:
                from .trace import span
                with span(f"entry.{label}"):
                    out = fn(req.stats)
            else:
                out = fn(req.stats)
            req.outputs = list(out)
        except Exception as e:
            req.error = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=sys.stderr)
        req.t1 = time.perf_counter()
        self._keep(req)
        req.launched = {k: n - launches[k]
                        for k, n in self.launches().items()}
        req.host_routes = self.routes["python"] - routes
        return req

    def _keep(self, req: Request) -> None:
        """Hold an output equal to its image's first as that same object,
        so that the window's records keep one copy of each distinct output
        and the process's memory stays flat over the window."""
        for j, (i, out) in enumerate(zip(req.images, req.outputs)):
            first = self.kept.setdefault((req.makes, i), out)
            if out is not first and out == first:
                req.outputs[j] = first
