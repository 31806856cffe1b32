"""A run end to end on the CPU: the result line's keys, the refusal to
run without a card, the import guard, which later lanes the check judges
under and over a mix's ``check_later_max``, and the comparison failing
under the control and under each fault the cells can have."""

import json
import os
import subprocess
import sys

import pytest
import torch

import numpy as np

from conftest import ROOT, SMALL, small_root
from helpers import (StepClock, cell_files, later_judged, recording,
                     run_cell, with_traffic)
from portbench import common, control, manifest, run
from portbench.drivers import serve, sim

CELLS = ("opt-poisson10.fused", "opt-poisson10.scan", "opt-serve.f1m")
SIM_CELLS = ("opt-poisson10.fused", "opt-poisson10.scan")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
#: A cap on the later lanes judged that a run of a few batches passes.
CAP = 3
#: A window that holds three batches under :class:`helpers.StepClock`.
STEP_SECONDS = 1.0


@pytest.fixture
def capped(tmp_path):
    """The small copy with both sim mixes' later lanes capped at ``CAP``."""
    sizes = with_traffic(with_traffic(SMALL, "fused", check_later_max=CAP),
                         "scan", check_later_max=CAP)
    return small_root(str(tmp_path / "capped"), sizes=sizes)


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


@pytest.mark.parametrize("cell", SIM_CELLS)
def test_the_capped_control_is_not_correct(capped, cell, monkeypatch):
    """The control through the same selection, past the cap."""
    monkeypatch.setattr(sim, "time", StepClock())
    records = recording(monkeypatch, sim)
    r = control.readings(cell, [5], STEP_SECONDS, "cpu", root=capped)
    assert r[0]["rc"] == 0 and r[0]["correct"] is False
    notes = records[0].notes
    assert notes["later_lanes_judged"] == CAP < notes["later_lanes_seen"]


# ---- which later lanes the check judges ----------------------------------

def test_later_rows_under_the_cap_are_every_lane_in_order():
    events = [np.array([5, 9]), np.array([], int), np.array([1, 2, 3])]
    rows = common.later_rows(events, 5, 1)
    assert [r.tolist() for r in rows] == [[0, 1], [], [0, 1, 2]]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 7, 2 ** 40])
def test_later_rows_over_the_cap_hold_the_heaviest_lane(seed):
    events = [np.arange(n) * (b + 1) for b, n in enumerate((6, 1, 9, 4))]
    rows = common.later_rows(events, 4, seed)
    assert sum(map(len, rows)) == 4
    assert 8 in rows[2]                        # 8 * 3, the most events
    for r, e in zip(rows, events):
        assert list(r) == sorted(set(r)) and all(0 <= i < len(e)
                                                 for i in r)


def test_later_rows_follow_the_seed_alone():
    events = [np.ones(40), np.ones(40)]
    a = common.later_rows(events, 6, 11)
    assert all((x == y).all() for x, y in
               zip(common.later_rows(events, 6, 11), a))
    assert any(len(x) != len(y) or (x != y).any() for x, y in
               zip(common.later_rows(events, 6, 12), a))


class _SimProgram(sim.Program):
    def __init__(self, root, cell):
        cfg, tr = cell_files(root, cell)
        super().__init__(cfg, tr, torch.device("cpu"))


class Kept(_SimProgram):
    """The program, noting each batch's kept lanes and their events (the
    warm-up runs on a copy of the base class and is not noted)."""

    def __init__(self, root, cell):
        super().__init__(root, cell)
        self.kept = []

    def keep(self, log, top, posts, sample):
        k = super().keep(log, top, posts, sample)
        self.kept.append((k[0].tolist(), k[3].tolist()))
        return k


def _stepped_run(root, cell, monkeypatch, seed=2 ** 31 + 7):
    """A run whose window holds three batches: its line, the program, the
    later lanes judged as (batch, lane) in order, and the run's notes."""
    monkeypatch.setattr(sim, "time", StepClock())
    records = recording(monkeypatch, sim)
    system = Kept(root, cell)
    line, rc = run_cell(root, cell, seed=seed, seconds=STEP_SECONDS,
                        system=system)
    assert rc == 0 and len(system.kept) == 3
    return line, system, later_judged(records[0]), records[0].notes


def _candidates(system):
    return [(b, lane) for b, (lanes, _) in enumerate(system.kept) if b
            for lane in lanes]


@pytest.mark.parametrize("cell", SIM_CELLS)
def test_under_the_cap_every_later_lane_is_judged_in_order(
        root, cell, monkeypatch):
    line, system, later, notes = _stepped_run(root, cell, monkeypatch)
    assert later == _candidates(system) and len(later) > CAP
    assert notes["later_lanes_seen"] == notes["later_lanes_judged"] == \
        len(later)
    assert notes["checked_lanes"] == len(later) + 25   # the first batch's
    assert notes["check_s"] > 0
    # A cap the run just reaches judges the same lanes, with the same
    # result.
    mix = manifest.cell(manifest.load(root), cell)["traffic"]
    path = os.path.join(root, "portbench", "traffic", mix + ".json")
    with open(path) as f:
        tr = json.load(f)
    with open(path, "w") as f:
        json.dump({**tr, "check_later_max": len(later)}, f)
    line2, _, later2, notes2 = _stepped_run(root, cell, monkeypatch)
    assert later2 == later and notes2["checked_lanes"] == \
        notes["checked_lanes"]
    assert line2["checks"] == line["checks"]
    assert (line2["correct"], line2["attempted"]) == \
        (line["correct"], line["attempted"])


@pytest.mark.parametrize("cell", SIM_CELLS)
def test_over_the_cap_the_cap_is_judged_with_the_heaviest_lane(
        capped, cell, monkeypatch):
    line, system, later, notes = _stepped_run(capped, cell, monkeypatch)
    assert line["correct"] is True
    cands = _candidates(system)
    events = [n for b, (_, ns) in enumerate(system.kept) if b for n in ns]
    assert len(later) == CAP < len(cands)
    assert later == [c for c in cands if c in later]   # in their order
    assert cands[events.index(max(events))] in later
    assert (notes["later_lanes_seen"], notes["later_lanes_judged"]) == \
        (len(cands), CAP)
    assert notes["checked_lanes"] == CAP + 25


@pytest.mark.parametrize("cell", SIM_CELLS)
def test_the_later_sample_follows_the_seed(capped, cell, monkeypatch):
    def positions(seed):
        _, system, later, _ = _stepped_run(capped, cell, monkeypatch, seed)
        return [(b, system.kept[b][0].index(lane)) for b, lane in later]

    a = positions(11)
    assert positions(11) == a
    assert positions(12) != a


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


class LaterBatchesAltered(_SimProgram):
    """In every batch after the first, the third event of each lane is
    late by a hundredth: only the later lanes judged can catch it (the
    first call is the first timed batch; the warm-up runs on a copy of
    the base class)."""

    def simulate(self, seeds):
        log = super().simulate(seeds)
        self.batches = getattr(self, "batches", 0) + 1
        if self.batches > 1:
            log.times[:, 2] += 0.01
        return log


@pytest.mark.parametrize("cap", [None, CAP])
@pytest.mark.parametrize("cell", SIM_CELLS)
@pytest.mark.parametrize("fault,caught", [
    (_SimProgram, set()), (HalfTheBatch, {"event_gap"}),
    (AnswerAltered, {"metrics_gap"}), (OneLaneAltered, {"event_gap"}),
    (LaterBatchesAltered, {"event_gap"})])
def test_sim_faults_are_not_correct(root, capped, monkeypatch, cell, fault,
                                    caught, cap):
    """Each fault fails the run, also where the cap leaves ``CAP`` of the
    later lanes to judge (the window holds three batches)."""
    root = capped if cap else root
    _sample_one_lane(root, cell)
    monkeypatch.setattr(sim, "time", StepClock())
    records = recording(monkeypatch, sim)
    line, rc = run_cell(root, cell, seconds=STEP_SECONDS,
                        system=fault(root, cell))
    assert rc == 0 and _failed(line) >= caught
    assert line["correct"] is (not caught)
    if cap:
        notes = records[0].notes
        assert notes["later_lanes_judged"] == CAP < \
            notes["later_lanes_seen"]


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


@pytest.mark.parametrize("cap", [None, CAP])
@pytest.mark.parametrize("cell", SIM_CELLS)
def test_sim_step_returning_its_state_unchanged_is_not_correct(
        root, capped, cell, monkeypatch, cap):
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
    monkeypatch.setattr(sim, "time", StepClock())
    records = recording(monkeypatch, sim)
    line, rc = run_cell(capped if cap else root, cell,
                        seconds=STEP_SECONDS)
    assert calls["n"] > 0
    assert rc == 0 and "event_gap" in _failed(line)
    if cap:
        notes = records[0].notes
        assert notes["later_lanes_judged"] == CAP < \
            notes["later_lanes_seen"]


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
