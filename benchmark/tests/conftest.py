"""Shared fixtures of the benchmark's CPU tests: tiny copies of each
cell and of the spare cells, the card's presence (decided in a fixture,
never at import)."""
from __future__ import annotations

import copy

import pytest

from benchmark import spec

CELLS = tuple(w["name"] for w in spec._load_json(
    f"{spec.ROOT}/BENCHMARK.json")["workloads"])
# a configuration's entries that make it a progressive-photo one, kept in
# memory: its photos progressive JPEGs, which the deployment takes (each
# into a mode-X container)
PROGRESSIVE = {"images": {"progressive": True},
               "container": {"allow_progressive": True}}
# cells that BENCHMARK.json does not have, by the name a cell would have:
# (configuration, traffic, entries changed in the configuration), for
# traffic kinds that no cell runs yet and for progressive photos, which no
# configuration file names yet
SPARE = {"phone12mp.single": ("phone12mp", "single", {}),
         **{f"phoneprog12mp.{t}": ("phone12mp", t, PROGRESSIVE)
            for t in ("bulk_encode", "bulk_decode", "single")}}


def tiny(name: str, images: int = 2) -> spec.Cell:
    """The cell with its images cut to 48x32 and its batch or pool to
    `images`, each image held to the reference."""
    if name in SPARE:
        config, traffic = (spec._load_json(f"{spec.HERE}/{d}/{n}.json")
                           for d, n in zip(("configs", "traffic"),
                                           SPARE[name]))
        c = spec.Cell(name, 1, config, traffic, [], [])
        changes = SPARE[name][2]
    else:
        c = spec.cell(name)
        changes = {}
    config, traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    for key, entries in changes.items():
        config[key].update(entries)
    gen = config["images"]
    gen["width"], gen["height"] = 48, 32
    for key in ("batch_images", "pool_images"):
        if key in traffic:
            traffic[key] = images
    if "reference_images" in traffic:
        traffic["reference_images"] = images
    if "warm_reads" in traffic:
        traffic["warm_reads"] = 1
    return spec.Cell(c.name, c.chips, config, traffic, c.end_to_end,
                     c.per_layer)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
