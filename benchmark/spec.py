"""What a cell is made of, found by name under benchmark/.

BENCHMARK.json at the root names the cells; each cell names a
configuration (benchmark/configs/<config>.json), a traffic mix
(benchmark/traffic/<traffic>.json, whose "kind" names the driver
benchmark/traffic/<kind>.py), and the metrics it reports, each read by
benchmark/metrics/<metric name>.py.  Nothing here knows a cell by name.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    and metrics; KeyError where BENCHMARK.json has no such cell."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config = _load_json(os.path.join(HERE, "configs",
                                     f"{entry['config']}.json"))
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      f"{entry['traffic']}.json"))
    return Cell(name, entry["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def driver(traffic: dict):
    """The traffic driver module of a mix's kind."""
    return importlib.import_module(f"benchmark.traffic.{traffic['kind']}")


def metric_reader(name: str):
    """read(run) of benchmark/metrics/<name>.py (names may hold dots, so
    the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def allow_progressive(config: dict) -> bool:
    """The deployment's allow_progressive (upstream's -allowprogressive):
    whether progressive and multi-scan JPEGs are taken, each into a mode-X
    container, or refused.  The configuration's
    container.allow_progressive; false where absent."""
    value = config["container"].get("allow_progressive", False)
    if not isinstance(value, bool):
        raise ValueError(f"container.allow_progressive {value!r}: a bool")
    return value
