"""A run end to end on the CPU: the result line's keys, the refusal to
run without a card, the import guard, and the comparison failing under
the control and under each fault the cells can have."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from helpers import cell_files, run_cell
from portbench import control, manifest, run
from portbench.drivers import serve, sim

CELLS = ("opt-poisson10.fused", "opt-poisson10.scan", "opt-serve.f1m")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_its_line_has_the_keys(root, cell):
    line, rc = run_cell(root, cell)
    assert rc == 0
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


def test_without_a_card_the_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "opt-poisson10.fused", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2
    assert p.stdout == ""


def test_outside_a_checkout_of_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    tmp_path / "portbench")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "opt-poisson10.fused", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "redqueen_tpu_torch_extra",
                        sys.modules[__name__])
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "redqueen_tpu.sim",
                        sys.modules[__name__])
    assert run.forbidden_loaded() == ["redqueen_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {ROOT!r}); "
        f"sys.path.insert(0, {os.path.join(ROOT, 'portbench', 'tests')!r})\n"
        "from helpers import run_cell\n"
        "from portbench import run\n"
        f"for cell in {CELLS!r}:\n"
        f"    line, rc = run_cell({root!r}, cell, seconds=0.2)\n"
        "    assert rc == 0, cell\n"
        "print(json.dumps([run.forbidden_loaded(),\n"
        "                  'redqueen_tpu_torch' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [[], True]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    r = control.readings(cell, [5, 6, 7], 0.3, "cpu", root=root)
    assert all(x["rc"] == 0 and x["correct"] is False for x in r)


# ---- faults planted in the timed path ------------------------------------

class _SimProgram(sim.Program):
    def __init__(self, root, cell):
        cfg, tr = cell_files(root, cell)
        super().__init__(cfg, tr, torch.device("cpu"))


class HalfTheBatch(_SimProgram):
    """Simulates the first half of the lanes; the rest come back empty."""

    def simulate(self, seeds):
        log = super().simulate(seeds)
        h = log.times.shape[0] // 2
        log.times[h:] = float("inf")
        log.srcs[h:] = -1
        log.n_events[h:] = 0
        return log


class AnswerAltered(_SimProgram):
    """The time-in-top-1 of the lane with the most events is off by a
    hundredth."""

    def score(self, log):
        top, posts = super().score(log)
        top = top.clone()
        top[int(torch.argmax(log.n_events))] += 0.01
        return top, posts


class OneLaneAltered(_SimProgram):
    """In every batch, the third event of the lane with the fewest events
    (never the lane with the most, which every batch keeps) is late by a
    hundredth."""

    def simulate(self, seeds):
        log = super().simulate(seeds)
        lane = int(torch.argmin(log.n_events))
        log.times[lane, 2] += 0.01
        return log


@pytest.mark.parametrize("cell", ["opt-poisson10.fused",
                                  "opt-poisson10.scan"])
@pytest.mark.parametrize("fault,caught", [
    (_SimProgram, set()), (HalfTheBatch, {"event_gap"}),
    (AnswerAltered, {"metrics_gap"}), (OneLaneAltered, {"event_gap"})])
def test_sim_faults_are_not_correct(root, cell, fault, caught):
    _sample_one_lane(root, cell)
    line, rc = run_cell(root, cell, system=fault(root, cell))
    assert rc == 0 and _failed(line) >= caught
    assert line["correct"] is (not caught)


def _sample_one_lane(root, cell):
    """Cut the cell's sample of each later batch to one lane, so that a
    fault in one lane shows only where the run checks every lane of a
    batch."""
    mix = manifest.cell(manifest.load(root), cell)["traffic"]
    path = os.path.join(root, "portbench", "traffic", mix + ".json")
    with open(path) as f:
        tr = json.load(f)
    tr["check_lanes"] = 1
    with open(path, "w") as f:
        json.dump(tr, f)


@pytest.mark.parametrize("cell", ["opt-poisson10.fused",
                                  "opt-poisson10.scan"])
def test_sim_step_returning_its_state_unchanged_is_not_correct(
        root, cell, monkeypatch):
    """Every seventh step emits its event but hands back the state it was
    given (so the same event comes again)."""
    from redqueen_tpu_torch.ops import event_step, scan_core

    calls = {"n": 0}
    make_step = event_step.make_step

    def broken_make_step(spec, c):
        step = make_step(spec, c)

        def wrapped(carry):
            new, t, s = step(carry)
            calls["n"] += 1
            return (carry if calls["n"] % 7 == 0 else new), t, s
        return wrapped

    monkeypatch.setattr(event_step, "make_step", broken_make_step)
    real = scan_core.RunChunk.step

    def broken_step(self, params, state, consts):
        new, t, s = real(self, params, state, consts)
        calls["n"] += 1
        return (state if calls["n"] % 7 == 0 else new), t, s

    monkeypatch.setattr(scan_core.RunChunk, "step", broken_step)
    line, rc = run_cell(root, cell)
    assert calls["n"] > 0
    assert rc == 0 and "event_gap" in _failed(line)


def _serve_program(root, cell, cls, tmp_path):
    cfg, _ = cell_files(root, cell)

    def make(n_feeds, key):
        return cls(cfg, n_feeds, key, str(tmp_path / "serving"),
                   torch.device("cpu"))
    return make


class HalfTheEvents(serve.Program):
    """Each batch reaches the apply with half of its events."""

    def submit(self, batch):
        seq, times, feeds = batch
        h = len(times) // 2
        return super().submit((seq, times[:h], feeds[:h]))


class DecisionAltered(serve.Program):
    """One decision's intensity is off by one where it is returned."""

    def poll(self):
        out = super().poll()
        return [(s, p, t, lam + (1.0 if s == 50 else 0.0))
                for s, p, t, lam in out]


def _failed(line):
    return {n for n, c in line["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cls,caught", [
    (serve.Program, set()),
    (HalfTheEvents, {"decision_gap", "carry_mismatch", "journal_missing"}),
    (DecisionAltered, {"decision_gap", "journal_missing"})])
def test_serving_faults_are_not_correct(root, cls, caught, tmp_path):
    line, rc = run_cell(root, "opt-serve.f1m", system=_serve_program(
        root, "opt-serve.f1m", cls, tmp_path))
    assert rc == 0 and _failed(line) >= caught
    assert line["correct"] is (not caught)


def test_serving_ack_before_the_quorum_is_not_correct(root, monkeypatch):
    """The replicated append returns without waiting for a follower's
    acknowledgement: every record is still written everywhere by the
    close, but decisions come back before a quorum held them."""
    from redqueen_tpu_torch.serving import replication

    monkeypatch.setattr(replication.ReplicatedJournal, "_await_quorum",
                        lambda self, n: True)
    line, rc = run_cell(root, "opt-serve.f1m")
    assert rc == 0 and line["correct"] is False
    assert _failed(line) == {"quorum_late"}


def test_serving_step_returning_its_state_unchanged_is_not_correct(
        root, monkeypatch):
    """Every fifth batch's apply returns the carry it was given."""
    from redqueen_tpu_torch.serving import state as sstate

    real = sstate._step
    calls = {"n": 0}

    def broken(state, *a):
        out = real(state, *a)
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            return (state.t, state.rank, state.health) + out[3:]
        return out

    monkeypatch.setattr(sstate, "_step", broken)
    line, rc = run_cell(root, "opt-serve.f1m")
    assert calls["n"] > 0
    assert rc == 0 and line["correct"] is False
    assert "decision_gap" in _failed(line)
