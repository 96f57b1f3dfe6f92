"""The comparison that decides `correct` fails its control and the faults
a cell can have, at a size a test run holds (tiny copies, CPU).

The control (run_cell(control=True)): the reference's .lep coded with
7-bit probabilities in place of each sampled image's outputs, and the
lossy transcode in place of each decoded JPEG.  The faults, planted
under the entry points: half of a batch left out (its outputs copies of
the other half's), and one byte altered where a stream or a decoded JPEG
is produced.  A run on one card has no exchange between chips and no
state that a step carries, so those faults do not apply."""
from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tests.conftest import CELLS, SPARE, tiny


@pytest.mark.parametrize("name", CELLS + tuple(SPARE))
def test_control_is_not_correct(name):
    res = run.run_cell(name, 2**31 + 5, 1.0, False, "cpu", control=True,
                       cell=tiny(name), workers=2)
    assert res["correct"] is False
    checks = {k: c["value"] for k, c in res["checks"].items()}
    decodes = name.endswith("decode") or name.endswith("single")
    # the decode cell's .lep files are the set-up's, held to the reference
    assert checks["wrong_lep"] > 0
    assert (checks["wrong_jpeg"] > 0) == decodes


def _half_of_encode(monkeypatch):
    from lepton_tpu_torch.kernels import batch_encode
    real = batch_encode.encode_images_device

    def half(images, *a, **k):
        keep = max(1, len(images) // 2)
        out = real(images[:keep], *a, **k)
        return out + [out[0]] * (len(images) - keep)
    monkeypatch.setattr(batch_encode, "encode_images_device", half)


def _byte_of_stream(monkeypatch):
    from lepton_tpu_torch.kernels import batch_encode
    real = batch_encode.finalize

    def altered(*a, **k):
        streams = real(*a, **k)
        last = bytearray(streams[-1])
        last[len(last) // 2] ^= 0x10
        return streams[:-1] + [bytes(last)]
    monkeypatch.setattr(batch_encode, "finalize", altered)


def _half_of_decode(monkeypatch):
    from lepton_tpu_torch import api
    real = api._reemit
    first = []

    def half(*a, **k):
        out = real(*a, **k)
        first.append(out)
        return first[0] if len(first) % 2 == 0 else out
    monkeypatch.setattr(api, "_reemit", half)


def _byte_of_jpeg(monkeypatch):
    from lepton_tpu_torch import api
    real = api._reemit

    def altered(*a, **k):
        out = bytearray(real(*a, **k))
        out[len(out) // 2] ^= 0x01
        return bytes(out)
    monkeypatch.setattr(api, "_reemit", altered)


@pytest.mark.parametrize("name,fault", [
    (f"{config}.{traffic}", fault) for config in ("phone12mp", "phoneprog12mp")
    for traffic, fault in (
        ("bulk_encode", _half_of_encode), ("bulk_encode", _byte_of_stream),
        ("single", _byte_of_stream), ("single", _byte_of_jpeg),
        ("bulk_decode", _half_of_decode), ("bulk_decode", _byte_of_jpeg))])
def test_fault_is_not_correct(name, fault, monkeypatch):
    """Planted after set-up, so that the inputs the set-up makes are
    sound and the window's calls carry the fault."""
    from benchmark.traffic import bulk_decode, bulk_encode, single
    drivers = {"bulk_encode": bulk_encode, "bulk_decode": bulk_decode,
               "single": single}
    cell = tiny(name)
    driver = drivers[cell.traffic["kind"]]
    real_window = driver.window

    def window(*a, **k):
        fault(monkeypatch)
        return real_window(*a, **k)
    monkeypatch.setattr(driver, "window", window)
    res = run.run_cell(name, 2**31 + 6, 1.0, False, "cpu", cell=cell,
                       workers=2)
    assert res["correct"] is False
    assert res["failed"] > 0


@pytest.mark.parametrize("launched,plain", [
    ({"symbol_counts": 12, "emit_symbols": 12, "run_heads": 1,
      "walk_runs": 1, "vpx_walk": 1}, 0),
    ({"symbol_counts": 12, "emit_symbols": 12, "run_heads": 1,
      "walk_runs": 0, "vpx_walk": 1}, 2),
    ({"decode_lanes": 1}, 2),
])
def test_a_stage_that_did_not_launch_is_plain(launched, plain):
    """On the card, a call in which any kernel of its path did not launch
    counts as one that ran a plain version, whatever the others did."""
    from benchmark import fixtures
    from benchmark.calls import Request
    from benchmark.check import judge
    from benchmark.reference import encode as ref
    cell = tiny(CELLS[0])
    images = [fixtures.make_photo(k, 48, 32) for k in range(2)]
    req = Request("encode", "lep", [0, 1], 0.0, 1.0, launched=launched,
                  outputs=[ref.expected_lep(j, 16) for j in images])
    traffic = dict(cell.traffic, reference_lanes=0)
    checks, failed = judge(images, [req], [], cell.config, traffic, 1,
                           on_card=True)
    assert checks["plain"] == (plain, 0) and failed == plain
    assert all(v == 0 for k, (v, _) in checks.items() if k != "plain")
