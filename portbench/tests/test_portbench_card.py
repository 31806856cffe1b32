"""Each cell through ``portbench/run.py`` on the card, short windows, as
a process of its own: a correct result, traced and untraced."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from portbench import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 101), "--seconds", "3",
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
