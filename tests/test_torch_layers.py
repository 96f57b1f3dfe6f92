"""The port's layers: a module under kernels/, jpeg/, container/, codec/,
coder/, model/ or util/ imports none of the layers above it (host, api,
parallel, serve, cli) and no script at the repository's root
(chip_smoke.py, say), lazily inside a function included; and every
module:attribute that benchmark/spans.json wraps resolves."""
import ast
import importlib
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "lepton_tpu_torch"
LOWER = ("kernels", "jpeg", "container", "codec", "coder", "model", "util")
UPPER = {"host", "api", "parallel", "serve", "cli"}
SCRIPTS = {p.stem for p in ROOT.glob("*.py")}
MODULES = sorted(p.relative_to(ROOT).as_posix()
                 for layer in LOWER
                 for p in (ROOT / PKG / layer).glob("*.py"))


def _imported(path: str):
    """Each name that the module at path imports, as a dotted name from
    the root: a module, or a module's attribute."""
    package = path.split("/")[:-1]
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] \
                if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            yield module
            yield from (f"{module}.{a.name}" for a in node.names)


def test_lower_layers_found():
    assert len(MODULES) > 30 and "chip_smoke" in SCRIPTS


@pytest.mark.parametrize("path", MODULES)
def test_lower_layer_imports_no_upper_layer(path):
    upward = []
    for name in _imported(path):
        parts = name.split(".")
        if parts[0] in SCRIPTS or (parts[0] == PKG and len(parts) > 1
                                   and parts[1] in UPPER):
            upward.append(name)
    assert upward == [], f"{path} imports {upward}"


SPANS = json.loads((ROOT / "benchmark" / "spans.json").read_text())


@pytest.mark.parametrize("target", sorted(
    t for targets in SPANS.values() for t in targets))
def test_span_target_resolves(target):
    """A wrapped name is a module attribute that the main path looks up
    at call time: it must exist, and be a function."""
    module, attr = target.split(":")
    assert callable(getattr(importlib.import_module(module), attr))
