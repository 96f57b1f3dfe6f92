"""Each traffic driver's loop for a second on a tiny copy of each cell, on
the CPU with the program's plain versions (device="cpu"): the result
object has exactly the keys the contract names, each metric the cell
reports, and every output judged correct.  On the card (marker cuda),
one short run of the command itself."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import CELLS, SPARE, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS + tuple(SPARE))
def test_rehearsal(name):
    cell = tiny(name)
    res = run.run_cell(name, 2**31 + 3, 1.0, False, "cpu", cell=cell,
                       workers=2)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert all(c["value"] == 0 for c in res["checks"].values())
    json.dumps(res)


def test_rehearsal_traced():
    """A traced run carries the per-layer metrics it can read on the CPU,
    busy_s and window_s, and the breakdown before the checks."""
    name = "phone12mp.bulk_encode"
    cell = tiny(name, images=1)
    res = run.run_cell(name, 7, 1.0, True, "cpu", cell=cell, workers=1)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"] is True
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "parse_ms_per_mb.encode" in res["metrics"]
    # no device on the CPU: no idle share, no roofline
    assert "device_idle_pct.encode" not in res["metrics"]


def test_run_command_without_a_card():
    """The command itself exits with another code than 0 and prints
    nothing on stdout when no card is there."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         CELLS[0], "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    name = CELLS[-1]
    res = run.run_cell(name, 2**31 + 21, 2.0, False, "cuda",
                       cell=tiny(name))
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
