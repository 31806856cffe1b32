"""Engine telemetry of the port under the JAX package's names, so that
one trace reader (``tools/rqtrace.py``) reads both packages' traces:
``engine.scan.drive``/``superchunk``/``sync`` and the counter
``engine.scan.dispatches`` (``tests/test_telemetry.py``'s engine case),
the ``engine.dispatch`` event with its ``engine.dispatch.*`` counters,
and the fused engine's ``engine.pallas.run``/``launch``/``sync`` with
``engine.pallas.launches`` equal to the launches (the plain version on
the CPU).  With telemetry off, nothing is recorded.  Exact."""

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
