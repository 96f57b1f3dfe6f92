"""The progressive-photo cell as BENCHMARK.json names it: its
configuration file is phone12mp's with the progressive entries; a traced
second of the cell built from that file, cut to a size a test run holds
(CPU, plain versions), is correct and reports the re-emit's per-layer
metrics, and its control is not correct.  (conftest.SPARE's in-memory
cell of the same name is what test_rehearsal and
test_control_is_not_correct build.)"""
from __future__ import annotations

import copy

from benchmark import run, spec
from benchmark.tests.conftest import PROGRESSIVE

NAME = "phoneprog12mp.bulk_decode"


def test_cell_is_phone12mp_with_progressive_photos():
    cell, base = spec.cell(NAME), spec.cell("phone12mp.bulk_decode")
    assert cell.chips == 1 and cell.traffic == base.traffic
    assert spec.allow_progressive(cell.config)
    for key in ("images", "container"):
        want = {**base.config[key], **PROGRESSIVE[key]}
        got = dict(cell.config[key])
        if key == "images":
            # the coding's description is the one entry that differs
            assert got.pop("coding").startswith("progressive")
            want.pop("coding")
        assert got == want, key
    for key in ("kernels", "model", "reduced"):
        assert cell.config[key] == base.config[key]
    assert {m["name"] for m in cell.end_to_end} == {"decode_mbps",
                                                    "setup_s"}
    # the baseline decode cell's metrics, and two of the mode-X re-emit
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in base.per_layer} | {
        "reemit_scan_mbps.decode_x", "reemit_concurrency.decode_x"}


def _tiny():
    """The cell from its file, its photos cut to 48x32, 2 a batch."""
    c = spec.cell(NAME)
    config, traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    config["images"]["width"], config["images"]["height"] = 48, 32
    traffic["batch_images"] = 2
    return spec.Cell(c.name, c.chips, config, traffic, c.end_to_end,
                     c.per_layer)


def test_traced_rehearsal_of_the_cell():
    res = run.run_cell(NAME, 2**31 + 11, 1.0, True, "cpu", cell=_tiny(),
                       workers=2)
    assert res["correct"] is True and res["failed"] == 0
    assert all(ch["value"] == 0 for ch in res["checks"].values())
    metrics = {k: m["value"] for k, m in res["metrics"].items()}
    # no device on the CPU: no idle share
    assert set(metrics) == {m["name"] for m in spec.cell(NAME).per_layer
                            } - {"device_idle_pct.decode"}
    assert all(v > 0 for v in metrics.values())
    # one request re-emitted at a time
    assert metrics["reemit_concurrency.decode_x"] <= 1.0


def test_control_of_the_cell_is_not_correct():
    res = run.run_cell(NAME, 2**31 + 5, 1.0, False, "cpu", control=True,
                       cell=_tiny(), workers=2)
    assert res["correct"] is False
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert checks["wrong_lep"] > 0 and checks["wrong_jpeg"] > 0
