"""The star engine's telemetry: a traced ``simulate_star_batch`` records
``star.simulate_batch`` (``lanes``, ``feeds``, ``fire_mode``) over
``star.checks`` (the input checks, then the overflow read),
``star.streams`` with ``star.streams.hawkes`` inside, ``star.fires``
(``mode``, ``compress``) and ``star.metrics``, and the counters
``star.hawkes.steps`` (the thinning loop's steps, added once a stream),
``star.hawkes.host_reads`` and ``star.fires.uncompressed`` (retries after
a record-budget overflow).  No span is opened inside the loop.  With
telemetry off, nothing is recorded.  Exact."""

import numpy as np
import pytest

from redqueen_tpu_torch.ops import streams
from redqueen_tpu_torch.parallel import bigf as TB
from redqueen_tpu_torch.parallel import star_run
from redqueen_tpu_torch.runtime import telemetry as T

TREE = {"star.simulate_batch": None,
        "star.checks": "star.simulate_batch",
        "star.streams": "star.simulate_batch",
        "star.streams.hawkes": "star.streams",
        "star.fires": "star.simulate_batch",
        "star.metrics": "star.simulate_batch"}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setattr(star_run, "_COMPRESS_BLOCKLIST", set())
    T.configure(enabled=True, reset=True)
    yield
    T.configure(enabled=False, reset=True)


def _run(T_end=15.0, q=1.0, F=6, B=3, wall_cap=128):
    sb = TB.StarBuilder(n_feeds=F, end_time=T_end)
    for f in range(F):
        sb.wall_hawkes(f, 0.5, 0.8, 2.0)
    sb.ctrl_opt(q=q)
    cfg, wall, ctrl = sb.build(wall_cap=wall_cap, post_cap=4096,
                               device="cpu")
    return TB.simulate_star_batch(cfg, *TB.broadcast_star(wall, ctrl, B),
                                  np.arange(B) + 11, fire_mode="doubling",
                                  device="cpu")


def _counting(monkeypatch):
    """Count the thinning loop's proposals and host reads."""
    n = {"proposals": 0, "reads": 0}
    real_prop, real_dev = streams.thinning_proposal, streams._device

    def proposal(*a):
        n["proposals"] += 1
        return real_prop(*a)

    class Dev:
        @staticmethod
        def host_read(x):
            n["reads"] += 1
            return real_dev.host_read(x)

    monkeypatch.setattr(streams, "thinning_proposal", proposal)
    monkeypatch.setattr(streams, "_device", Dev)
    return n


def test_spans_nest_and_counters_count_the_loop(monkeypatch):
    n = _counting(monkeypatch)
    _run()
    spans = T.get().drain_spans()
    by_sid = {s["sid"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert sorted(names) == sorted(list(TREE) + ["star.checks"])
    for s in spans:
        parent = by_sid.get(s.get("parent"), {}).get("name")
        assert parent == TREE[s["name"]], s["name"]
    (root,) = [s for s in spans if s["name"] == "star.simulate_batch"]
    assert root["attrs"] == {"lanes": 3, "feeds": 6,
                             "fire_mode": "doubling"}
    (fires,) = [s for s in spans if s["name"] == "star.fires"]
    assert fires["attrs"] == {"mode": "doubling", "compress": True}
    (hawkes,) = [s for s in spans if s["name"] == "star.streams.hawkes"]
    assert hawkes["attrs"] == {"sources": 18}
    c = T.get().counters
    assert c["star.hawkes.steps"] == n["proposals"] > 0
    assert c["star.hawkes.host_reads"] == n["reads"]
    assert "star.fires.uncompressed" not in c
    # Children lie inside their parents on the wall clock.
    for s in spans:
        if s.get("parent") in by_sid:
            p = by_sid[s["parent"]]
            assert p["t_ns"] <= s["t_ns"]
            assert s["t_ns"] + s["dur"] * 1e9 <= \
                p["t_ns"] + p["dur"] * 1e9 + 1e3


def test_no_span_is_opened_inside_the_thinning_loop(monkeypatch):
    """A horizon eight times as long runs more steps and records the
    same spans."""
    got = []
    for T_end in (5.0, 40.0):
        n = _counting(monkeypatch)
        _run(T_end=T_end)
        got.append((sorted(s["name"] for s in T.get().drain_spans()),
                    n["proposals"]))
        T.configure(reset=True)
    assert got[0][0] == got[1][0]
    assert got[1][1] > got[0][1]


def test_an_overflowing_record_budget_counts_its_retry():
    """Short clocks (q tiny): every wall event is a record, a feed has
    more than the budget, and the fires run again uncompressed; the
    streams run once."""
    res = _run(T_end=100.0, q=1e-6, F=2, B=2, wall_cap=256)
    assert int(res.wall_n.max()) > 64
    spans = T.get().drain_spans()
    fires = [s["attrs"]["compress"] for s in spans
             if s["name"] == "star.fires"]
    assert fires == [True, False]
    assert sum(s["name"] == "star.streams" for s in spans) == 1
    assert T.get().counters["star.fires.uncompressed"] == 1
    assert sum(s["name"] == "star.checks" for s in spans) == 3


def test_disabled_telemetry_records_nothing():
    T.configure(enabled=False, reset=True)
    _run()
    assert T.get().drain_spans() == [] and T.get().counters == {}
