"""The import rule: nothing the benchmark's run loads is JAX or the JAX
package, by whole top-level module name (lepton_tpu_torch begins with
lepton_tpu and is not it), and the reference loads nothing of the
program."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE = os.path.join(ROOT, "benchmark", "reference")
FORBIDDEN = {"jax", "jaxlib", "flax", "lepton_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of every module loaded by `code` in a fresh
    interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_a_run_imports_is_free_of_jax():
    """benchmark.run with every module a run loads: the spec, each cell's
    traffic driver, generator and metric readers, the trace, the checks
    and the program's entry points."""
    code = """
import benchmark.run, benchmark.check, benchmark.trace, benchmark.calls
from benchmark import spec, fixtures
import json, importlib
bench = json.load(open('BENCHMARK.json'))
for w in bench['workloads']:
    c = spec.cell(w['name'])
    spec.driver(c.traffic)
    importlib.import_module('benchmark.generators.' + c.config['images']['generator'])
    for m in c.end_to_end + c.per_layer:
        spec.metric_reader(m['name'])
from benchmark.calls import Caller
Caller()
import lepton_tpu_torch.api
"""
    loaded = _loaded(code)
    assert "lepton_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded("import benchmark.reference.encode, benchmark.check")
    assert not loaded & (FORBIDDEN | {"lepton_tpu_torch", "torch"})


def test_reference_sources_import_no_program():
    """Every import statement under benchmark/reference, read from the
    source: numpy, the standard library and the package itself."""
    for base, _, files in os.walk(REFERENCE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert top not in FORBIDDEN | {"lepton_tpu_torch",
                                                   "torch"}, (f, name)


def test_forbidden_modules_by_whole_name(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "lepton_tpu_torch_like",
                        types.ModuleType("x"))
    for name in list(sys.modules):      # other tests may load the JAX package
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "lepton_tpu.api", types.ModuleType("z"))
    assert run.forbidden_modules() == ["jax", "lepton_tpu"]


@pytest.mark.parametrize("argv", [
    ["--workload", "phone12mp.bulk_encode", "--seed", "1", "--seconds", "1"],
])
def test_run_refuses_without_a_card(argv, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(argv + ["--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA" in out.err
