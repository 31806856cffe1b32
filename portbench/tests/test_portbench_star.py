"""The star cell (``opt-hawkes1k.star``) end to end on the CPU at small
sizes: a correct run and its result line, the traced run's per-layer
metrics (the profiler stood in for: the CPU has no device to trace), the
cell's manifest entries, which later lanes the check judges under and
over the mix's ``check_later_max``, the control reading not correct, and
faults planted in the timed path failing their checks."""

import json
import os
import time

import pytest
import torch

from conftest import small_root
from helpers import (StepClock, cell_files, later_judged, recording,
                     run_cell, with_traffic)
from portbench import control, manifest
from portbench.drivers import star

CELL = "opt-hawkes1k.star"
#: This cell's CPU sizes: 32 feeds to T = 20, 6 lanes a batch, every lane
#: of the first batch checked.
SIZES = {
    "configs": {"opt-hawkes1k": {"followers": 32, "end_time": 20.0,
                                 "wall_cap": 128, "post_cap": 512}},
    "traffic": {"star": {"lanes": 6, "check_lanes": 2,
                         "warmup_end_time": 5.0}},
}
PER_LAYER = {"star.streams_ms", "hawkes.step_ms", "star.fires_ms",
             "star.roofline_pct", "device_idle.sim"}
#: A cap on the later lanes judged that a run of a few batches passes.
CAP = 3
#: A window that holds four batches under :class:`helpers.StepClock`.
STEP_SECONDS = 1.0


@pytest.fixture
def sroot(tmp_path):
    return small_root(str(tmp_path / "root"), sizes=SIZES)


@pytest.fixture
def capped(tmp_path):
    """The small copy with the later lanes judged capped at ``CAP``."""
    return small_root(str(tmp_path / "capped"), sizes=with_traffic(
        SIZES, "star", check_later_max=CAP))


def _failed(line):
    return {n for n, c in line["checks"].items() if c["value"] > c["limit"]}


def test_sound_run_is_correct(sroot):
    line, rc = run_cell(sroot, CELL)
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"wall_gap", "post_gap", "metrics_gap"}
    assert set(line["metrics"]) == {"sim_events_per_s", "setup_s"}
    assert line["attempted"] % 6 == 0 and line["failed"] == 0
    assert line["metrics"]["sim_events_per_s"]["value"] > 0


class _StandInTrace(star.LaunchTrace):
    """The profiler stood in for: one device operation over the whole
    window, its launch unknown."""

    def start(self):
        self.t0_ns = time.time_ns()

    def stop(self):
        self.t1_ns = time.time_ns()

    def collect(self):
        self.device = [("stand-in", self.t0_ns, self.t1_ns)]
        self.launch = [None]


def test_traced_run_reports_the_star_metrics(sroot, monkeypatch):
    monkeypatch.setattr(star, "LaunchTrace", _StandInTrace)
    line, rc = run_cell(sroot, CELL, trace=1)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == PER_LAYER
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 < m["star.roofline_pct"] <= 100
    assert 0 < m["hawkes.step_ms"] < m["star.streams_ms"]
    assert m["star.fires_ms"] > 0


def test_the_cells_manifest_entries():
    man = manifest.load()
    c = manifest.cell(man, CELL)
    assert c["chips"] == 1 and c["traffic"] == "star"
    (conf,) = [x for x in man["configs"] if x["name"] == c["config"]]
    assert conf["reduced"] == [] and len(conf["why"]) <= 200
    cfg = manifest.config(man, c)
    assert (cfg["followers"], cfg["end_time"], cfg["wall_cap"],
            cfg["post_cap"]) == (1000, 100.0, 1024, 8192)
    assert manifest.traffic(c)["lanes"] == 256
    reported = {m["name"] for m in manifest.metrics_for(man, CELL, True)}
    assert reported == PER_LAYER
    assert {m["name"] for m in manifest.metrics_for(man, CELL, False)} == \
        {"sim_events_per_s", "setup_s"}


def test_the_control_is_not_correct(sroot):
    r = control.readings(CELL, [5, 6, 7], 0.3, "cpu", root=sroot)
    assert all(x["rc"] == 0 and x["correct"] is False for x in r)
    assert all(_failed(x) == {"wall_gap", "post_gap", "metrics_gap"}
               for x in r)


def test_the_capped_control_is_not_correct(capped, monkeypatch):
    """The control through the same selection, past the cap."""
    monkeypatch.setattr(star, "time", StepClock())
    records = recording(monkeypatch, star)
    r = control.readings(CELL, [5], STEP_SECONDS, "cpu", root=capped)
    assert r[0]["rc"] == 0 and r[0]["correct"] is False
    assert _failed(r[0]) == {"wall_gap", "post_gap", "metrics_gap"}
    notes = records[0].notes
    assert notes["later_lanes_judged"] == CAP < notes["later_lanes_seen"]


# ---- which later lanes the check judges ----------------------------------

class _Program(star.Program):
    def __init__(self, root):
        cfg, tr = cell_files(root, CELL)
        super().__init__(cfg, tr, torch.device("cpu"))


class Kept(_Program):
    """The program, noting each batch's kept lanes and their wall events
    (the warm-up runs on a copy of the base class and is not noted)."""

    def __init__(self, root):
        super().__init__(root)
        self.kept = []

    def keep(self, res, mean, sample):
        k = super().keep(res, mean, sample)
        self.kept.append((k["lanes"].tolist(),
                          k["wall_n"].sum(-1).tolist()))
        return k


def _stepped_run(root, monkeypatch, seed=2 ** 31 + 7):
    """A run whose window holds four batches: its line, the program, the
    later lanes judged as (batch, lane) in order, and the run's notes."""
    monkeypatch.setattr(star, "time", StepClock())
    records = recording(monkeypatch, star)
    system = Kept(root)
    line, rc = run_cell(root, CELL, seed=seed, seconds=STEP_SECONDS,
                        system=system)
    assert rc == 0 and len(system.kept) == 4
    return line, system, later_judged(records[0]), records[0].notes


def _candidates(system):
    return [(b, lane) for b, (lanes, _) in enumerate(system.kept) if b
            for lane in lanes]


def test_under_the_cap_every_later_lane_is_judged_in_order(
        sroot, monkeypatch):
    line, system, later, notes = _stepped_run(sroot, monkeypatch)
    assert later == _candidates(system) and len(later) > CAP
    assert notes["later_lanes_seen"] == notes["later_lanes_judged"] == \
        len(later)
    assert notes["checked_lanes"] == len(later) + 6
    assert notes["check_s"] > 0
    # A cap the run just reaches judges the same lanes, with the same
    # result.
    path = os.path.join(sroot, "portbench", "traffic", "star.json")
    with open(path) as f:
        tr = json.load(f)
    with open(path, "w") as f:
        json.dump({**tr, "check_later_max": len(later)}, f)
    line2, _, later2, notes2 = _stepped_run(sroot, monkeypatch)
    assert later2 == later and notes2["checked_lanes"] == \
        notes["checked_lanes"]
    assert line2["checks"] == line["checks"]
    assert (line2["correct"], line2["attempted"]) == \
        (line["correct"], line["attempted"])


def test_over_the_cap_the_cap_is_judged_with_the_heaviest_lane(
        capped, monkeypatch):
    line, system, later, notes = _stepped_run(capped, monkeypatch)
    assert line["correct"] is True
    cands = _candidates(system)
    events = [n for b, (_, ns) in enumerate(system.kept) if b for n in ns]
    assert len(later) == CAP < len(cands)
    assert later == [c for c in cands if c in later]   # in their order
    assert cands[events.index(max(events))] in later
    assert (notes["later_lanes_seen"], notes["later_lanes_judged"]) == \
        (len(cands), CAP)
    assert notes["checked_lanes"] == CAP + 6


def test_the_later_sample_follows_the_seed(capped, monkeypatch):
    def positions(seed):
        _, system, later, _ = _stepped_run(capped, monkeypatch, seed)
        return [(b, system.kept[b][0].index(lane)) for b, lane in later]

    a = positions(11)
    assert positions(11) == a
    assert positions(12) != a


# ---- faults planted in the timed path ------------------------------------


class WallEventMoved(_Program):
    """The third wall event of one feed of the lane with the most events
    is late by a hundredth."""

    def simulate(self, seeds):
        res = super().simulate(seeds)
        lane = int(torch.argmax(res.wall_n.sum(-1)))
        res.wall_times[lane, 0, 2] += 0.01
        return res


class PostDropped(_Program):
    """The lane with the most events loses its fifth post."""

    def simulate(self, seeds):
        res = super().simulate(seeds)
        lane = int(torch.argmax(res.wall_n.sum(-1)))
        own = res.own_times[lane]
        own[4:-1] = own[5:].clone()
        own[-1] = float("inf")
        res.n_posts[lane] -= 1
        return res


class OneLaneAltered(_Program):
    """In every batch, a wall event of the lane with the fewest events
    (never the lane with the most, which every batch keeps) is late by a
    hundredth."""

    def simulate(self, seeds):
        res = super().simulate(seeds)
        lane = int(torch.argmin(res.wall_n.sum(-1)))
        res.wall_times[lane, 1, 2] += 0.01
        return res


class BiasedAcceptance(_Program):
    """The thinning accepts a proposal up to 0.9% above the intensity
    (``u * bound <= 1.009 * intensity``): it samples another law, and
    every decision it flips lies within 1% of a tie."""

    def simulate(self, seeds):
        from redqueen_tpu_torch.ops import prng, streams

        real = streams.thinning_proposal

        def biased(key, t, lbd, *rest):
            nxt, t_new, lbd_new, _ = real(key, t, lbd, *rest)
            u = prng.uniform_from_bits23(
                prng.random_bits(prng.split(key, 3)[..., 2, :]))
            return nxt, t_new, lbd_new, u * lbd <= 1.009 * lbd_new

        streams.thinning_proposal = biased
        try:
            return super().simulate(seeds)
        finally:
            streams.thinning_proposal = real


class LaterBatchesAltered(_Program):
    """In every batch after the first, the third wall event of each
    lane's first feed is late by a hundredth: only the later lanes
    judged can catch it (the first call is the first timed batch; the
    warm-up runs on a copy of the base class)."""

    def simulate(self, seeds):
        res = super().simulate(seeds)
        self.batches = getattr(self, "batches", 0) + 1
        if self.batches > 1:
            res.wall_times[:, 0, 2] += 0.01
        return res


def _sample_one_lane(root):
    """Cut the sample of each later batch to one lane, so that a fault in
    one lane shows only where the run checks every lane of a batch."""
    path = os.path.join(root, "portbench", "traffic", "star.json")
    with open(path) as f:
        tr = json.load(f)
    tr["check_lanes"] = 1
    with open(path, "w") as f:
        json.dump(tr, f)


@pytest.mark.parametrize("cap", [None, CAP])
@pytest.mark.parametrize("fault,caught", [
    (_Program, set()), (WallEventMoved, {"wall_gap"}),
    (PostDropped, {"post_gap"}), (OneLaneAltered, {"wall_gap"}),
    (BiasedAcceptance, {"wall_gap"}), (LaterBatchesAltered, {"wall_gap"})])
def test_faults_are_not_correct(sroot, capped, monkeypatch, fault, caught,
                                cap):
    """Each fault fails the run, also where the cap leaves ``CAP`` of the
    later lanes to judge (the window holds four batches)."""
    root = capped if cap else sroot
    _sample_one_lane(root)
    monkeypatch.setattr(star, "time", StepClock())
    records = recording(monkeypatch, star)
    line, rc = run_cell(root, CELL, seconds=STEP_SECONDS,
                        system=fault(root))
    assert rc == 0 and _failed(line) >= caught
    assert line["correct"] is (not caught)
    if cap:
        notes = records[0].notes
        assert notes["later_lanes_judged"] == CAP < \
            notes["later_lanes_seen"]


@pytest.mark.parametrize("cap", [None, CAP])
def test_thinning_stopped_one_probe_early_is_not_correct(sroot, capped,
                                                         monkeypatch, cap):
    """The thinning loop leaves one probe (``PROBE_EVERY`` steps) before
    its last: the sources still drawing then lose their last events."""
    from types import SimpleNamespace

    from redqueen_tpu_torch import device as _device
    from redqueen_tpu_torch.ops import streams

    real = streams.hawkes_stream
    cut = {"n": 0}

    def early(*a, **k):
        reads = []

        def counting(x):
            reads.append(1)
            return _device.host_read(x)

        monkeypatch.setattr(streams, "_device",
                            SimpleNamespace(host_read=counting))
        real(*a, **k)
        stop = len(reads) - 1   # the read before the loop's last one

        def stopping(x):
            reads.append(1)
            return len(reads) - n0 < stop and _device.host_read(x)

        n0 = len(reads)
        monkeypatch.setattr(streams, "_device",
                            SimpleNamespace(host_read=stopping))
        try:
            out = real(*a, **k)
        finally:
            monkeypatch.setattr(streams, "_device", _device)
        cut["n"] += 1
        return out

    monkeypatch.setattr(streams, "hawkes_stream", early)
    monkeypatch.setattr(star, "time", StepClock())
    records = recording(monkeypatch, star)
    line, rc = run_cell(capped if cap else sroot, CELL,
                        seconds=STEP_SECONDS)
    assert cut["n"] > 0
    assert rc == 0 and line["correct"] is False
    assert "wall_gap" in _failed(line)
    if cap:
        notes = records[0].notes
        assert notes["later_lanes_judged"] == CAP < \
            notes["later_lanes_seen"]


def test_a_stage_lasts_until_the_work_it_launched_ends():
    """A span [100, 200) ns that launched an operation running to 300 ns
    held the batch 200 ns; an operation launched after it, or with no
    launch record, does not count."""
    from types import SimpleNamespace

    trace = SimpleNamespace(
        device=[("a", 160, 300), ("b", 260, 900), ("c", 120, 950)],
        launch=[150, 250, None])
    spans = [{"name": "x", "t_ns": 100, "dur": 100e-9},
             {"name": "y", "t_ns": 400, "dur": 50e-9}]
    assert star.stage_s(spans, trace, "x") == pytest.approx(200e-9)
    assert star.stage_s(spans, trace, "y") == pytest.approx(50e-9)
    assert star.stage_s(spans, trace, "z") == 0.0
