"""The manifest is found by name and keeps the contract's shape; a cell,
a mix and a metric added as files are picked up with no edit."""

import json
import os
import re
import shutil

import pytest

from helpers import run_cell
from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_name_resolves_to_its_files():
    man = manifest.load()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    for w in man["workloads"]:
        c = manifest.cell(man, w["name"])
        assert manifest.config(man, c)["name"] == w["config"]
        t = manifest.traffic(c)
        assert os.path.exists(os.path.join(
            manifest.HERE, "drivers", t["driver"] + ".py"))
        assert w["chips"] == 1
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("held_back", [False, True])
def test_contract_shapes(root, held_back):
    """The manifest, and with the held-back cells' entries added back."""
    man = manifest.load(root) if held_back else manifest.load()
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(man)) < 64 * 1024


def test_added_cell_mix_and_metric_are_picked_up(root):
    """A new mix (a data file), a cell naming it and a metric with its
    reader, added as files and manifest entries: the harness runs and
    reports them with no other change."""
    shutil.copy(os.path.join(root, "portbench", "traffic", "scan.json"),
                os.path.join(root, "portbench", "traffic", "short.json"))
    p = os.path.join(root, "portbench", "traffic", "short.json")
    with open(p) as f:
        t = json.load(f)
    t["lanes"] = 8
    with open(p, "w") as f:
        json.dump(t, f)
    with open(os.path.join(root, "portbench", "metrics",
                           "lanes_per_s.py"), "w") as f:
        f.write("def read(rec):\n"
                "    return rec.attempted / rec.values['window_s']\n")
    mp = os.path.join(root, "BENCHMARK.json")
    with open(mp) as f:
        man = json.load(f)
    man["workloads"].append({"name": "opt-poisson10.short",
                             "config": "opt-poisson10", "traffic": "short",
                             "chips": 1, "why": "eight lanes"})
    man["end_to_end"].append({"name": "lanes_per_s", "unit": "lanes/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["opt-poisson10.short"]})
    with open(mp, "w") as f:
        json.dump(man, f)
    line, rc = run_cell(root, "opt-poisson10.short")
    assert rc == 0 and line["correct"]
    assert line["attempted"] % 8 == 0
    assert set(line["metrics"]) == {"lanes_per_s", "setup_s"}
    assert line["metrics"]["lanes_per_s"]["unit"] == "lanes/s"
