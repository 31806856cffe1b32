"""CPU tests of the benchmark: small sizes, the program's CPU paths.
Tests marked ``cuda`` need the card and skip without it."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Small sizes of every cell for the CPU: lanes, horizon, feeds, rates.
SMALL = {
    "configs": {"opt-poisson10": {"end_time": 20.0}},
    "traffic": {
        "fused": {"lanes": 24, "check_lanes": 6, "route": "plain",
                  "engine": "fused", "warmup_end_time": 5.0},
        "scan": {"lanes": 24, "check_lanes": 6, "warmup_end_time": 5.0},
        "f1m": {"feeds": 4096, "rate_batches_per_s": 200.0,
                "warmup_batches": 40},
    },
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch sees none")


def small_root(dest: str, sizes=SMALL) -> str:
    """A copy of the benchmark's manifest and data files under ``dest``,
    cut to the CPU's sizes, with the held-back cells' entries
    (``portbench/held_back.json``) added; the code stays the
    repository's."""
    os.makedirs(os.path.join(dest, "portbench"), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    with open(os.path.join(ROOT, "portbench", "held_back.json")) as f:
        held = json.load(f)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        man[group] += held[group]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(man, f, indent=2)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", d),
                        os.path.join(dest, "portbench", d))
    for kind, files in sizes.items():
        for name, edits in files.items():
            p = os.path.join(dest, "portbench", kind, name + ".json")
            with open(p) as f:
                data = json.load(f)
            data.update(edits)
            with open(p, "w") as f:
                json.dump(data, f)
    return dest


@pytest.fixture
def root(tmp_path):
    return small_root(str(tmp_path / "root"))
