"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``, as the manifest's ``file``
says), its traffic (``traffic/<traffic>.json``) and each metric's reader
(``metrics/<metric>.py``).  Adding a cell, a mix or a metric adds files
and manifest entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

__all__ = ["HERE", "ROOT", "load", "cell", "config", "traffic", "metrics_for",
           "reader"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: "
                   f"{', '.join(w['name'] for w in man['workloads'])})")


def config(man: Dict, cell_: Dict, root: str = ROOT) -> Dict:
    for c in man["configs"]:
        if c["name"] == cell_["config"]:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell_['config']!r} in "
                   f"BENCHMARK.json")


def traffic(cell_: Dict, root: str = ROOT) -> Dict:
    with open(os.path.join(root, "portbench", "traffic",
                           cell_["traffic"] + ".json")) as f:
        return json.load(f)


def metrics_for(man: Dict, cell_name: str, traced: bool) -> List[Dict]:
    """The metrics a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with a ``workloads``
    list only in the cells it names."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, root: str = ROOT):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
