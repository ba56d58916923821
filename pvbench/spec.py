"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics. Everything that belongs to one of them sits in a file
of its own under this folder:

- a configuration: ``configs/<config>.json`` (the ``file`` its entry
  names), the network's sizes, precisions and, for training, the recipe.
  Its network is its own: ``network`` (the backbone's module name,
  ``resnet18_8s``, ``resnet34_8s`` or ``resnet50_8s``), ``block``
  (``BasicBlock`` or ``Bottleneck``), ``stage_sizes``, ``output_stride``,
  the widths ``fcdim``, ``s8dim``, ``s4dim``, ``s2dim``, ``raw_dim`` and
  the outputs ``seg_dim``, ``ver_dim``, which the reference
  (reference/fcn.py), the FLOP count (flops.py), the program's model and
  the seeded weights all read; ``weights`` is a flax checkpoint of a
  BasicBlock network under the checkout, or ``"seeded"``: drawn from the
  run's seed by the recipe's law, BatchNorm statistics from one
  train-mode pass of the reference over 16 of the run's frames;
- a traffic mix: ``traffic/<traffic>.json``, the parameters that the one
  generator (pvbench/inputs.py) and the loop it names (``loop``) read;
- a cell: ``workloads/<cell>.json``, its configuration, traffic, chips
  and the limits of the comparison that decides ``correct``;
- a per-layer metric: ``metrics/<metric>.py``, its reader (``read``),
  ``UNIT``, ``LAYER`` and ``MOVES``.

A new configuration, mix, cell or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: dict = None) -> dict:
    """The cell ``name``: its BENCHMARK.json entry, with its file's
    ``check`` limits, its configuration (``cfg``) and traffic (``mix``)
    loaded."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if own[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} "
                             f"{own[key]!r}, BENCHMARK.json {entry[key]!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {**entry, "check": own["check"],
            "cfg": _json(os.path.join(ROOT, conf["file"])),
            "mix": _json(os.path.join(HERE, "traffic",
                                      f"{entry['traffic']}.json"))}


def end_to_end(bench: dict, name: str) -> List[str]:
    """The end-to-end metrics that the cell ``name`` reports."""
    return [m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(bench: dict, name: str) -> List[str]:
    """The per-layer metrics that the cell ``name`` reports: those that
    list it, and those without a list whose ``moves`` it reports."""
    mine = set(end_to_end(bench, name))
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in mine)]


def metric_module(name: str):
    """The module of ``metrics/<name>.py`` (a name may hold dots, so it is
    loaded from its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"pvbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_modules(names: List[str]) -> Dict[str, object]:
    return {n: metric_module(n) for n in names}
