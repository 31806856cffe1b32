"""The port's fused engine (redqueen_tpu_torch/ops/event_engine.py, with
the event kernel's plain version on the CPU) against the JAX megakernel
``simulate_pallas(..., interpret=True)``, lane by lane, at the same
integer seeds and the same ``sync_every``, on components carried across
with ``convert.py``.

Criteria: ``srcs`` and ``n_events`` identical on every lane, ``times``
within rtol 1e-6 (torch's and XLA's CPU log1p/exp differ by at most one
ulp, so a draw may round differently); health words equal under the
``RQ_FAULT`` numeric faults; a replay-only mix bit-identical.  A lane
whose srcs diverge must do so first at a near-tie (the two competing
clocks within 4 ulp): such a lane is checked up to that step and belongs
in ROADMAP.md Queue 3."""

import dataclasses
import functools

import jax  # noqa: F401  (platform selection happens in conftest)
import numpy as np
import pytest
import torch

from redqueen_tpu import config as jcfg
from redqueen_tpu.ops.pallas_engine import simulate_pallas
from redqueen_tpu.runtime import faultinject as jfault
from redqueen_tpu.sim import NumericalHealthError as JaxHealthError
import redqueen_tpu_torch as rt
from redqueen_tpu_torch.config import PARAM_FIELDS
from redqueen_tpu_torch.convert import (
    sim_config_from_fields,
    source_params_from_numpy,
)
from redqueen_tpu_torch.ops import event_engine
from redqueen_tpu_torch.runtime import faultinject as tfault
from redqueen_tpu_torch.runtime import numerics as tnum

RTOL = 1e-6


def _headline(F=10, T=20.0):
    gb = jcfg.GraphBuilder(n_sinks=F, end_time=T)
    gb.add_opt(q=1.0)
    for i in range(F):
        gb.add_poisson(rate=1.0, sinks=[i])
    return gb


def _mix():
    gb = jcfg.GraphBuilder(n_sinks=5, end_time=15.0)
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_piecewise([0.0, 7.0], [1.0, 0.3], sinks=[2])
    gb.add_realdata([1.0, 2.5, 6.0, 14.0], sinks=[3])
    gb.add_poisson(rate=0.7, sinks=[4])
    return gb


def _replay():
    gb = jcfg.GraphBuilder(n_sinks=2, end_time=10.0)
    gb.add_realdata([0.5, 1.25, 2.0, 3.75, 9.5, 11.0], sinks=[0])
    gb.add_realdata([0.1, 4.2, 8.8], sinks=[1])
    return gb


def _two_opt():
    """Opt rows 0 and 3 (not adjacent): both read feed 1, each also reads
    a feed the other does not, and source 5 shares no feed with row 0,
    so one (row, source) pair never reacts."""
    gb = jcfg.GraphBuilder(n_sinks=4, end_time=15.0)
    gb.add_opt(q=1.0, sinks=[0, 1, 2])
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_opt(q=0.5, sinks=[1, 3])
    gb.add_poisson(rate=0.8, sinks=[2, 3])
    gb.add_poisson(rate=0.6, sinks=[3])
    return gb


def _health_mix():
    gb = jcfg.GraphBuilder(n_sinks=2, end_time=12.0)
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    return gb


def _hawkes_first():
    gb = jcfg.GraphBuilder(n_sinks=2, end_time=12.0)
    gb.add_hawkes(l0=0.8, alpha=0.3, beta=1.0, sinks=[0])
    gb.add_poisson(rate=1.0, sinks=[1])
    return gb


def _both(gb, capacity, B):
    """(JAX cfg, params, adj) and the port's, carried across."""
    cfg, p, a = gb.build(capacity=capacity)
    pj, aj = jcfg.stack_components([p] * B, [a] * B)
    tcfg = sim_config_from_fields(dataclasses.asdict(cfg))
    tp = source_params_from_numpy(
        {f: np.asarray(getattr(pj, f)) for f in PARAM_FIELDS}, device="cpu")
    ta = torch.from_numpy(np.array(aj))
    return (cfg, pj, aj), (tcfg, tp, ta)


def _run_both(gb, capacity, B, k, seeds=None, max_chunks=100):
    (cfg, pj, aj), (tcfg, tp, ta) = _both(gb, capacity, B)
    seeds = np.arange(B) if seeds is None else seeds
    lj = simulate_pallas(cfg, pj, aj, seeds, max_chunks=max_chunks,
                         interpret=True, sync_every=k)
    lt = event_engine.simulate_fused(tcfg, tp, ta, seeds,
                                     max_chunks=max_chunks, sync_every=k,
                                     device="cpu")
    return lj, lt


def _ulps(a, b):
    return abs(float(a) - float(b)) / float(
        np.spacing(np.float32(max(abs(a), abs(b)))))


def assert_lanes_match(lj, lt, exact=False):
    """Per-lane parity of two event logs (see the module docstring)."""
    sj, st = np.asarray(lj.srcs), lt.srcs.numpy()
    tj, tt = np.asarray(lj.times), lt.times.numpy()
    nj, nt = np.asarray(lj.n_events), lt.n_events.numpy()
    assert lt.dispatches == lj.dispatches
    assert sj.shape == st.shape
    diverged = []
    for lane in range(sj.shape[0]):
        if np.array_equal(sj[lane], st[lane]):
            assert nj[lane] == nt[lane], lane
            if exact:
                np.testing.assert_array_equal(tt[lane], tj[lane])
            else:
                np.testing.assert_allclose(tt[lane], tj[lane], rtol=RTOL,
                                           atol=0, err_msg=f"lane {lane}")
            continue
        i = int(np.flatnonzero(sj[lane] != st[lane])[0])
        np.testing.assert_allclose(tt[lane, :i], tj[lane, :i], rtol=RTOL,
                                   atol=0, err_msg=f"lane {lane}")
        assert not exact, f"lane {lane} diverged at step {i} in exact mode"
        assert _ulps(tt[lane, i], tj[lane, i]) <= 4, (
            f"lane {lane} first diverges at step {i} without a near-tie: "
            f"{tt[lane, i]} (src {st[lane, i]}) vs {tj[lane, i]} "
            f"(src {sj[lane, i]})")
        diverged.append(lane)
    return diverged


# (name, builder, capacity, B, k): the headline at S=11/F=10, a Hawkes +
# piecewise + replay mix, a multi-chunk, multi-launch run, and two Opt
# rows at non-adjacent indices.
CASES = {
    "headline": (lambda: _headline(10, 20.0), 64, 8, 8),
    "mix": (_mix, 32, 4, 2),
    "multi_chunk": (lambda: _headline(4, 30.0), 16, 3, 2),
    "two_opt": (_two_opt, 32, 5, 2),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    make, cap, B, k = CASES[name]
    return _run_both(make(), cap, B, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_srcs_and_counts_identical_times_within_rtol(name):
    lj, lt = _case(name)
    diverged = assert_lanes_match(lj, lt)
    assert not diverged, (
        f"{name}: lanes {diverged} diverge at a near-tie; record the case "
        f"in ROADMAP.md Queue 3")
    assert lt.engine == "plain"


@pytest.mark.parametrize("name", sorted(CASES))
def test_health_all_clear_and_log_shapes(name):
    lj, lt = _case(name)
    np.testing.assert_array_equal(lt.health.numpy(), np.asarray(lj.health))
    assert not lt.health.any()
    B = lt.n_events.shape[0]
    assert lt.times.shape == lt.srcs.shape and lt.times.shape[0] == B
    assert lt.times.dtype == torch.float32 and lt.srcs.dtype == torch.int32
    valid = lt.srcs >= 0
    assert torch.equal(valid.sum(1).int(), lt.n_events)
    assert not torch.isnan(lt.times).any()


def test_multi_chunk_really_spans_launches():
    _, lt = _case("multi_chunk")
    assert lt.dispatches >= 3
    assert int(lt.n_events.max()) > 2 * 16


def test_two_opt_case_fires_and_reacts_on_both_rows():
    _, lt = _case("two_opt")
    srcs = lt.srcs.numpy()
    for r in (0, 3):
        assert (srcs == r).sum() > 0, f"Opt row {r} never posted"
    assert lt.dispatches >= 2


def test_replay_only_bit_identical():
    lj, lt = _run_both(_replay(), 16, 3, 1)
    assert assert_lanes_match(lj, lt, exact=True) == []
    np.testing.assert_array_equal(lt.times.numpy(), np.asarray(lj.times))


@pytest.mark.parametrize("mode,lane,make", [
    ("nan", 1, _health_mix),
    ("inf", 1, _hawkes_first),
])
def test_health_equal_under_numeric_fault(monkeypatch, mode, lane, make):
    monkeypatch.setenv(jfault.ENV_FAULT, f"numeric:{mode}@lane{lane}")
    lj, lt = _run_both(make(), 64, 3, 1)
    hj, ht = np.asarray(lj.health), lt.health.numpy()
    np.testing.assert_array_equal(ht, hj)
    assert ht[lane] != 0 and (np.delete(ht, lane) == 0).all()
    want = (tnum.BIT_NONFINITE_TIME if mode == "nan"
            else tnum.BIT_NONFINITE_STATE)
    assert ht[lane] & want
    assert assert_lanes_match(lj, lt) == []


def test_cadence_preserves_events():
    (_, _, _), (tcfg, tp, ta) = _both(_headline(4, 30.0), 16, 3)
    a = event_engine.simulate_fused(tcfg, tp, ta, np.arange(3),
                                    sync_every=1, device="cpu")
    b = event_engine.simulate_fused(tcfg, tp, ta, np.arange(3),
                                    sync_every=4, device="cpu")
    assert torch.equal(a.n_events, b.n_events)
    assert b.dispatches < a.dispatches
    for lane in range(3):
        va, vb = a.srcs[lane] >= 0, b.srcs[lane] >= 0
        assert torch.equal(a.times[lane][va], b.times[lane][vb])
        assert torch.equal(a.srcs[lane][va], b.srcs[lane][vb])


def test_overflow_raises_in_both():
    (cfg, pj, aj), (tcfg, tp, ta) = _both(_headline(4, 30.0), 16, 2)
    with pytest.raises(RuntimeError, match="still active") as ej:
        simulate_pallas(cfg, pj, aj, np.arange(2), max_chunks=2,
                        interpret=True, sync_every=1)
    with pytest.raises(RuntimeError, match="still active") as et:
        event_engine.simulate_fused(tcfg, tp, ta, np.arange(2),
                                    max_chunks=2, sync_every=1, device="cpu")
    assert str(et.value) == str(ej.value)


def test_all_lanes_sick_raises_in_both(monkeypatch):
    monkeypatch.setenv(jfault.ENV_FAULT, "numeric:nan@lane0")
    (cfg, pj, aj), (tcfg, tp, ta) = _both(_health_mix(), 64, 1)
    with pytest.raises(JaxHealthError) as ej:
        simulate_pallas(cfg, pj, aj, np.arange(1), interpret=True,
                        sync_every=1)
    with pytest.raises(tnum.NumericalHealthError) as et:
        event_engine.simulate_fused(tcfg, tp, ta, np.arange(1),
                                    sync_every=1, device="cpu")
    assert et.value.reasons == ej.value.reasons == {
        0: ["non-finite event time"]}


def test_rmtpp_mix_refused_with_reason():
    gb = rt.GraphBuilder(n_sinks=2, end_time=10.0)
    gb.add_opt()
    gb.add_rmtpp()
    cfg, p, a = gb.build(capacity=64, device="cpu")
    ok, why = event_engine.coverage(cfg)
    assert not ok and "rmtpp" in why and "scan engine" in why
    pb, ab = rt.stack_components([p], [a])
    with pytest.raises(ValueError, match="supports only"):
        event_engine.simulate_fused(cfg, pb, ab, np.array([0]), device="cpu")
    # The scan engine runs the mix once weights are attached; without
    # them the host check names the missing weights.
    with pytest.raises(ValueError, match="params.rmtpp is None"):
        rt.simulate_batch(cfg, pb, ab, np.array([0]), device="cpu")


def test_handbuilt_config_not_covered():
    cfg = rt.SimConfig(n_sources=2, n_sinks=2, end_time=1.0)
    ok, why = event_engine.coverage(cfg)
    assert not ok and "present_kinds" in why


def test_key_array_seeds_refused():
    (_, _, _), (tcfg, tp, ta) = _both(_headline(2, 5.0), 16, 2)
    with pytest.raises(ValueError, match="integer seeds"):
        event_engine.simulate_fused(tcfg, tp, ta, np.zeros((2, 2), int),
                                    device="cpu")


@pytest.mark.parametrize("spec", [
    "numeric:nan@lane3", "numeric:INF@lane0", "numeric:nan@lane2,chunk1",
    "hang:5", "",
])
def test_numeric_fault_spec_read_as_jax_reads_it(monkeypatch, spec):
    monkeypatch.setenv(jfault.ENV_FAULT, spec)
    want = jfault.active_numeric_lane(4)
    assert tfault.active_numeric_lane(4) == want
