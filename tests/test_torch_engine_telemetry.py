"""Engine telemetry of the port under the JAX package's names, so that
one trace reader (``tools/rqtrace.py``) reads both packages' traces:
``engine.scan.drive``/``superchunk``/``sync`` and the counter
``engine.scan.dispatches`` (``tests/test_telemetry.py``'s engine case),
the ``engine.dispatch`` event with its ``engine.dispatch.*`` counters,
and the fused engine's ``engine.pallas.run``/``launch``/``sync`` with
``engine.pallas.launches`` equal to the launches (the plain version on
the CPU).  The port's own spans in the same path (``sim.*``, ``scan.*``,
``fused.*``, ``metrics.*``) form the tree the trace readers rely on, on
the wall clock in integer nanoseconds.  With telemetry off, nothing is
recorded.  Exact."""

import time

import numpy as np
import pytest

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu.runtime import telemetry as JT
from redqueen_tpu_torch import sim
from redqueen_tpu_torch.runtime import telemetry as T
from torch_parity import partitionable  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _reset():
    T.configure(enabled=True, reset=True)
    yield
    T.configure(enabled=False, reset=True)


def _component(pkg, **kw):
    gb = pkg.GraphBuilder(n_sinks=3, end_time=2.0)
    gb.add_poisson(rate=2.0)
    gb.add_opt(q=1.0)
    return gb.build(capacity=64, **kw)


def _names(spans):
    return {s["name"] for s in spans}


def test_engine_spans():
    cfg, params, adj = _component(rt, device="cpu")
    sim.simulate(cfg, params, adj, seed=0, device="cpu")
    assert {"engine.scan.drive", "engine.scan.superchunk",
            "engine.scan.sync"} <= _names(T.get().drain_spans())


def test_scan_spans_and_counters_match_the_references():
    """The same batch through both packages: the same span names, the
    same dispatch counts and the same ``engine.dispatch`` provenance."""
    JT.configure(enabled=True, reset=True)
    try:
        cj, pj, aj = _component(J)
        P, A = J.stack_components([pj] * 4, [aj] * 4)
        J.simulate_batch(cj, P, A, np.arange(4), sync_every=2,
                         engine="auto")
        jspans, jcnt = JT.get().drain_spans(), dict(JT.get().counters)
    finally:
        JT.configure(enabled=False, reset=True)
    ct, pt, at = _component(rt, device="cpu")
    P, A = rt.stack_components([pt] * 4, [at] * 4)
    rt.simulate_batch(ct, P, A, np.arange(4), sync_every=2, engine="auto",
                      device="cpu")
    spans, cnt = T.get().drain_spans(), dict(T.get().counters)
    engine_names = {n for n in _names(jspans) if n.startswith("engine.")}
    assert engine_names == {n for n in _names(spans)
                            if n.startswith("engine.")}
    assert cnt == jcnt
    drive = [s for s in spans if s["name"] == "engine.scan.drive"]
    assert len(drive) == 1
    assert drive[0]["attrs"]["dispatches"] == cnt["engine.scan.dispatches"]
    (ev,) = [s for s in spans if s["name"] == "engine.dispatch"]
    assert ev["attrs"]["engine"] == "scan"
    assert ev["attrs"]["requested"] == "auto"
    assert "scan engine" in ev["attrs"]["reason"]


@pytest.mark.parametrize("engine", ["fused", "pallas"])
@pytest.mark.parametrize("k", [1, 2])
def test_fused_engine_spans_count_its_launches(engine, k):
    ct, pt, at = _component(rt, device="cpu")
    P, A = rt.stack_components([pt] * 3, [at] * 3)
    log = rt.simulate_batch(ct, P, A, np.arange(3), sync_every=k,
                            engine=engine, device="cpu")
    spans, cnt = T.get().drain_spans(), dict(T.get().counters)
    names = [s["name"] for s in spans]
    assert names.count("engine.pallas.launch") == log.dispatches
    assert names.count("engine.pallas.sync") == log.dispatches
    assert cnt["engine.pallas.launches"] == log.dispatches >= 1
    assert cnt["engine.dispatch.pallas"] == 1
    (run,) = [s for s in spans if s["name"] == "engine.pallas.run"]
    assert run["attrs"]["dispatches"] == log.dispatches
    assert run["attrs"]["k"] == k and run["attrs"]["lanes"] == 3
    (ev,) = [s for s in spans if s["name"] == "engine.dispatch"]
    assert ev["attrs"] == {"engine": "pallas", "requested": engine}
    launches = [s for s in spans if s["name"] == "engine.pallas.launch"]
    assert all(s["parent"] == run["sid"] for s in launches)


def test_disabled_telemetry_records_nothing():
    T.configure(enabled=False, reset=True)
    ct, pt, at = _component(rt, device="cpu")
    P, A = rt.stack_components([pt] * 2, [at] * 2)
    rt.simulate_batch(ct, P, A, np.arange(2), engine="fused", device="cpu")
    rt.simulate_batch(ct, P, A, np.arange(2), device="cpu")
    assert T.get().drain_spans() == [] and T.get().counters == {}


# ---------------------------------------------------------------------------
# The port's own spans in the simulate and metrics path
# ---------------------------------------------------------------------------

#: ``simulate_batch``'s span tree: each span's parent, by name.
SCAN_TREE = {
    "sim.checks": "sim.simulate_batch",
    "engine.dispatch": "sim.simulate_batch",
    "scan.init": "sim.simulate_batch",
    "engine.scan.drive": "sim.simulate_batch",
    "engine.scan.superchunk": "engine.scan.drive",
    "scan.step": "engine.scan.superchunk",
    "scan.panel": "scan.step",
    "scan.fire": "scan.step",
    "scan.react": "scan.step",
    "engine.scan.sync": "engine.scan.superchunk",
    "scan.log": "sim.simulate_batch",
}
FUSED_TREE = {
    "sim.checks": "sim.simulate_batch",
    "engine.dispatch": "sim.simulate_batch",
    "fused.prepare": "sim.simulate_batch",
    "engine.pallas.run": "sim.simulate_batch",
    "engine.pallas.launch": "engine.pallas.run",
    "engine.pallas.sync": "engine.pallas.run",
    "fused.log": "sim.simulate_batch",
}
METRICS_TREE = {
    "metrics.feed.extent": "metrics.feed",
    "metrics.feed.loop": "metrics.feed",
}


def _batch_and_metrics(engine, B=4, sync_every=2):
    ct, pt, at = _component(rt, device="cpu")
    P, A = rt.stack_components([pt] * B, [at] * B)
    log = rt.simulate_batch(ct, P, A, np.arange(B), sync_every=sync_every,
                            engine=engine, device="cpu")
    rt.feed_metrics_batch(log.times, log.srcs, A, 1, ct.end_time)
    rt.num_posts(log.srcs, 1)
    return log


def _parents(spans):
    by_sid = {s["sid"]: s["name"] for s in spans}
    return {(s["name"], by_sid.get(s.get("parent"))) for s in spans}


def _interval(s):
    return s["t_ns"], s["t_ns"] + round(s["dur"] * 1e9)


@pytest.mark.parametrize("engine,tree", [("scan", SCAN_TREE),
                                         ("fused", FUSED_TREE)])
def test_simulate_batch_span_tree(engine, tree):
    log = _batch_and_metrics(engine)
    spans = T.get().drain_spans()
    want = {(k, v) for k, v in {**tree, **METRICS_TREE}.items()} | {
        ("sim.simulate_batch", None), ("metrics.feed", None),
        ("metrics.num_posts", None)}
    assert _parents(spans) == want
    (root,) = [s for s in spans if s["name"] == "sim.simulate_batch"]
    assert root["attrs"] == {"engine": engine, "lanes": 4}
    assert log.engine == ("scan" if engine == "scan" else "plain")


def test_scan_steps_and_metrics_columns_count_the_loops():
    log = _batch_and_metrics("scan", sync_every=1)
    spans = T.get().drain_spans()
    names = [s["name"] for s in spans]
    assert names.count("scan.step") == log.times.shape[1] > 0
    for stage in ("scan.panel", "scan.fire", "scan.react"):
        assert names.count(stage) == names.count("scan.step")
    valid = np.flatnonzero((log.srcs >= 0).any(0).numpy())
    (feed,) = [s for s in spans if s["name"] == "metrics.feed"]
    assert feed["attrs"]["columns"] == valid[-1] + 1


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_spans_sit_on_the_wall_clock_inside_their_parents(engine):
    before = time.time_ns()
    _batch_and_metrics(engine)
    after = time.time_ns()
    spans = T.get().drain_spans()
    by_sid = {s["sid"]: s for s in spans}
    for s in spans:
        a, b = _interval(s)
        assert before <= a <= b <= after
        assert s["t"] == round(s["t_ns"] / 1e9, 6)
        parent = by_sid.get(s.get("parent"))
        if parent is not None:
            pa, pb = _interval(parent)
            assert pa <= a and b <= pb + 1   # dur rounds to the ns


def test_disabled_telemetry_records_nothing_in_the_metrics_pass():
    T.configure(enabled=False, reset=True)
    for engine in ("scan", "fused"):
        _batch_and_metrics(engine)
    assert T.get().drain_spans() == [] and T.get().counters == {}


def test_new_spans_keep_engine_names_and_counters_of_the_reference():
    """The port's own spans add no ``engine.*`` name and no counter: a
    batch and its metrics pass count what the JAX package counts."""
    JT.configure(enabled=True, reset=True)
    try:
        cj, pj, aj = _component(J)
        P, A = J.stack_components([pj] * 4, [aj] * 4)
        J.simulate_batch(cj, P, A, np.arange(4), sync_every=2)
        jspans, jcnt = JT.get().drain_spans(), dict(JT.get().counters)
    finally:
        JT.configure(enabled=False, reset=True)
    _batch_and_metrics("scan")
    spans, cnt = T.get().drain_spans(), dict(T.get().counters)
    assert cnt == jcnt
    assert {n for n in _names(spans) if n.startswith("engine.")} == {
        n for n in _names(jspans) if n.startswith("engine.")}


def test_span_dict_carries_integer_nanoseconds():
    tel = T.Telemetry(enabled=True)
    before = time.time_ns()
    with tel.span("outer"):
        with tel.span("inner") as sp:
            sp.event("mark")
    tel.event("point")
    after = time.time_ns()
    spans = {s["name"]: s for s in tel.drain_spans()}
    for s in spans.values():
        assert isinstance(s["t_ns"], int) and before <= s["t_ns"] <= after
    assert spans["point"]["dur"] == 0.0
    assert spans["outer"]["t_ns"] <= spans["inner"]["t_ns"]
    assert 0.0 <= spans["inner"]["events"][0][1] <= spans["inner"]["dur"]


def test_flight_ring_keeps_the_scan_engine_spans_of_a_traced_run(tmp_path):
    """The per-step spans stay out of the flight ring, so a scan run's
    salvage (the ring's last ``FLIGHT_SALVAGE_SPANS``) still holds every
    superchunk and sync span, the ones that say where a dead child
    stopped; the export buffer keeps the per-step spans."""
    ring = str(tmp_path / T.FLIGHT_FILENAME)
    gb = rt.GraphBuilder(n_sinks=3, end_time=6.0)
    gb.add_poisson(rate=2.0)
    gb.add_opt(q=1.0)
    ct, pt, at = gb.build(capacity=8, device="cpu")
    P, A = rt.stack_components([pt] * 4, [at] * 4)
    T.configure(enabled=True, reset=True, flight=ring)
    try:
        rt.simulate_batch(ct, P, A, np.arange(4), sync_every=1,
                          device="cpu")
        spans = T.get().drain_spans()
    finally:
        T.get().close()
    salvage = T.read_flight(ring)[-T.FLIGHT_SALVAGE_SPANS:]
    names = [s["name"] for s in spans]
    per_step = ("scan.step", "scan.panel", "scan.fire", "scan.react")
    # Enough steps that their spans alone would fill the salvage.
    assert sum(names.count(n) for n in per_step) > T.FLIGHT_SALVAGE_SPANS
    assert names.count("engine.scan.superchunk") >= 2
    assert not {s["name"] for s in salvage} & set(per_step)
    engine = {s["sid"] for s in spans
              if s["name"] in ("engine.scan.superchunk", "engine.scan.sync",
                               "engine.scan.drive")}
    assert engine <= {s["sid"] for s in salvage}


class _SecondsClock:
    """A monotonic clock in seconds that moves by half a second a read."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 0.5
        return self.now


def test_a_seconds_clock_keeps_the_references_meaning():
    """``Telemetry(clock=)`` takes the reference's clock in seconds: the
    same fake clock gives both packages the same durations and event
    offsets; the default clock keeps integer nanoseconds on the wall."""
    got = []
    for tel in (JT.Telemetry(enabled=True, clock=_SecondsClock()),
                T.Telemetry(enabled=True, clock=_SecondsClock())):
        with tel.span("outer") as sp:
            sp.event("mark")
            with tel.span("inner"):
                pass
        tel.event("point")
        got.append(sorted((s["name"], s["dur"], str(s.get("events")))
                          for s in tel.drain_spans()))
    assert got[0] == got[1]
    assert dict((n, d) for n, d, _ in got[1]) == {
        "outer": 2.0, "inner": 0.5, "point": 0.0}
    t0 = time.time_ns()
    tel = T.Telemetry(enabled=True, clock=_SecondsClock())
    with tel.span("x"):
        pass
    (s,) = tel.drain_spans()
    assert isinstance(s["t_ns"], int) and t0 <= s["t_ns"] <= time.time_ns()
