"""The port's scan engine (ops/scan_core.py + sim.py) against the JAX
package's scan engine on the CPU, run live at the same seeds with
``jax_threefry_partitionable`` pinned to True: the ``tests/test_golden.py``
shapes, every non-neural kind, poisoned lanes under both numeric modes,
``simulate``, chunk and superchunk invariance, the overflow and
all-lanes-dead raises, and a JAX carry resumed in the port.

Tolerance: ``srcs``, ``n_events``, health and ``dispatches`` identical,
``times`` within rtol 1e-6 (see ``torch_parity``); the port against
itself bit-identical."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu.utils import metrics as jm
from redqueen_tpu_torch.runtime import faultinject
import torch_parity as tp
from torch_parity import partitionable  # noqa: F401  (autouse fixture)


def _same_port_logs(a, b):
    assert torch.equal(a.srcs, b.srcs) and torch.equal(a.n_events,
                                                       b.n_events)
    assert torch.equal(a.times.view(torch.int32), b.times.view(torch.int32))


def test_golden_single_shape_live():
    (cj, pj, aj), (ct, pt, at) = (
        tp.build(J, tp.golden, 4, 20.0, 256, 1),
        tp.build(rt, tp.golden, 4, 20.0, 256, 1, device="cpu"))
    lj = J.simulate(cj, _unstack(pj), aj[0], seed=42)
    lt = rt.simulate(ct, _unstack(pt), at[0], seed=42, device="cpu")
    assert not lt.batched and lt.engine == "scan"
    tp.assert_same_log(lj, lt)
    mj = jm.feed_metrics(lj.times, lj.srcs, aj[0], 0, 20.0)
    mt = rt.feed_metrics(lt.times, lt.srcs, at[0], 0, 20.0)
    np.testing.assert_allclose(float(mt.mean_time_in_top_k()),
                               float(mj.mean_time_in_top_k()), rtol=1e-5)


def _unstack(params):
    """Lane 0 of stacked params of either package."""
    if isinstance(params, rt.SourceParams):
        return dataclasses.replace(params, **{
            f: getattr(params, f)[0] for f in rt.config.PARAM_FIELDS})
    return jax.tree_util.tree_map(lambda x: x[0], params)


def test_golden_batch_shape_live_and_simulate_is_its_lane():
    lj, lt = tp.run_both(tp.golden, 4, 20.0, 256, 3, seeds=np.array([7, 8, 9]))
    tp.assert_same_log(lj, lt)
    _, (ct, pt, at) = tp.build_both(tp.golden, 4, 20.0, 256, 1)
    one = rt.simulate(ct, _unstack(pt), at[0], seed=8, device="cpu")
    assert torch.equal(one.srcs, lt.srcs[1])
    assert torch.equal(one.times.view(torch.int32),
                       lt.times[1].view(torch.int32))
    assert int(one.n_events) == int(lt.n_events[1])


def test_every_kind_mix_matches():
    lj, lt = tp.run_both(tp.every_kind, 5, 15.0, 16, 8)
    tp.assert_same_log(lj, lt)
    assert lt.dispatches >= 2 and int(lt.n_events.min()) > 16


def test_hand_built_config_compiles_every_kind():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.every_kind, 5, 15.0, 16, 8)
    fields = dict(n_sources=cj.n_sources, n_sinks=5, end_time=15.0,
                  capacity=16)
    lj = J.simulate_batch(J.SimConfig(**fields), pj, aj, np.arange(8))
    lt = rt.simulate_batch(rt.SimConfig(**fields), pt, at, np.arange(8),
                           device="cpu")
    tp.assert_same_log(lj, lt)


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_poisoned_lane_matches(monkeypatch, mode):
    monkeypatch.setenv(faultinject.ENV_FAULT, f"numeric:{mode}@lane2")
    lj, lt = tp.run_both(tp.every_kind, 5, 15.0, 16, 8)
    tp.assert_same_log(lj, lt)
    h = lt.health.numpy()
    assert h[2] != 0 and (np.delete(h, 2) == 0).all()


def test_every_lane_dead_raises(monkeypatch):
    monkeypatch.setenv(faultinject.ENV_FAULT, "numeric:nan@lane0")
    _, (ct, pt, at) = tp.build_both(tp.golden, 4, 5.0, 16, 1)
    with pytest.raises(rt.NumericalHealthError, match="numerically dead"):
        rt.simulate_batch(ct, pt, at, np.array([0]), device="cpu")


def test_chunk_boundaries_and_sync_every_change_nothing():
    """Capacity and ``sync_every`` change only how the run is cut: the
    valid events are the same bits, and each cut's buffer and dispatch
    count are the JAX package's."""
    base = None
    for cap, k in [(16, 1), (16, 3), (64, 8), (256, 2)]:
        (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.golden, 4, 20.0, cap, 4)
        lt = rt.simulate_batch(ct, pt, at, np.arange(4), sync_every=k,
                               device="cpu")
        n = int(lt.n_events.max())
        if base is None:
            base = lt
        _same_port_logs(
            rt.EventLog(lt.times[:, :n], lt.srcs[:, :n], lt.n_events, ct),
            rt.EventLog(base.times[:, :n], base.srcs[:, :n], base.n_events,
                        ct))
        if cap == 16:
            lj = J.simulate_batch(cj, pj, aj, np.arange(4), sync_every=k)
            tp.assert_same_log(lj, lt)


def test_max_chunks_overflow_raises_like_jax():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.golden, 4, 20.0, 16, 2)
    with pytest.raises(RuntimeError, match="refusing to truncate"):
        J.simulate_batch(cj, pj, aj, np.arange(2), max_chunks=3)
    with pytest.raises(RuntimeError, match="refusing to truncate"):
        rt.simulate_batch(ct, pt, at, np.arange(2), max_chunks=3,
                          device="cpu")


@pytest.mark.parametrize("fill,F,T,cap,B", [
    (tp.every_kind, 5, 7.5, 16, 8), (tp.golden, 4, 50.0, 64, 4)])
def test_jax_carry_resumed_in_the_port(fill, F, T, cap, B):
    """A JAX run to T with return_state, carried across, resumed by the
    port to 2T: the extension log and the final carry equal the JAX
    package's own resume."""
    (cj, pj, aj), (ct, pt, at) = tp.build_both(fill, F, T, cap, B)
    _, sj = J.simulate_batch(cj, pj, aj, np.arange(B), return_state=True)
    cj2 = dataclasses.replace(cj, end_time=2 * T)
    ct2 = dataclasses.replace(ct, end_time=2 * T)
    lj, sj2 = J.resume(cj2, pj, aj, sj)
    st = rt.sim_state_from_numpy(tp.state_fields(sj), device="cpu")
    lt, st2 = rt.resume(ct2, pt, at, st)
    tp.assert_same_log(lj, lt)
    want, got = tp.state_fields(sj2), rt.sim_state_to_numpy(st2)
    for f, w in want.items():
        if w is None:
            assert got[f] is None, f
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(got[f], w, rtol=tp.RTOL, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)


def test_single_jax_carry_gains_a_lane_axis():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.golden, 4, 5.0, 64, 1)
    _, sj = J.simulate(cj, _unstack(pj), aj[0], seed=3, return_state=True)
    st = rt.sim_state_from_numpy(tp.state_fields(sj), device="cpu")
    assert st.batch_size == 1 and st.t_next.shape == (1, 5)
    poisoned = rt.runtime.numerics.poison_lane(st, 0, "nan")
    assert torch.isnan(poisoned.t_next[0, 0]) and not torch.isnan(
        st.t_next).any()


def test_resume_with_budget_matches_jax():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.golden, 4, 10.0, 64, 4)
    _, sj = J.simulate_batch(cj, pj, aj, np.arange(4), return_state=True,
                             max_events=7)
    _, st = rt.simulate_batch(ct, pt, at, np.arange(4), return_state=True,
                              max_events=7, device="cpu")
    cj2 = dataclasses.replace(cj, end_time=20.0)
    ct2 = dataclasses.replace(ct, end_time=20.0)
    lj, _ = J.resume(cj2, pj, aj, sj, max_events=np.array([0, 3, 50, 9]))
    lt, st2 = rt.resume(ct2, pt, at, st, max_events=np.array([0, 3, 50, 9]))
    tp.assert_same_log(lj, lt)
    assert lt.n_events.tolist()[:2] == [0, 3]
    assert torch.equal(st2.budget, st.n_events + torch.tensor(
        [0, 3, 50, 9], dtype=torch.int32))


def test_slab_and_rmtpp_name_their_roadmap_items():
    """``slab=`` is ported now (Queue 1 item 3): a slabbed batch equals
    the unslabbed one and refuses ``return_state``.  RMTPP is ported too
    (item 5): without weights both engine choices refuse it by name, and
    with them ``auto`` runs it on the scan engine, slabbed or not."""
    _, (ct, pt, at) = tp.build_both(tp.golden, 4, 5.0, 16, 2)
    whole = rt.simulate_batch(ct, pt, at, np.arange(2), device="cpu")
    slabbed = rt.simulate_batch(ct, pt, at, np.arange(2), slab=1,
                                device="cpu")
    _same_port_logs(whole, slabbed)
    with pytest.raises(ValueError, match="return_state"):
        rt.simulate_batch(ct, pt, at, np.arange(2), slab=1,
                          return_state=True, device="cpu")
    gb = rt.GraphBuilder(n_sinks=2, end_time=5.0)
    gb.add_opt()
    gb.add_rmtpp()
    cfg, p, a = gb.build(capacity=16, device="cpu")
    pb, ab = rt.stack_components([p], [a])
    for engine in ("scan", "auto"):
        with pytest.raises(ValueError, match="params.rmtpp is None"):
            rt.simulate_batch(cfg, pb, ab, np.array([0]), engine=engine,
                              device="cpu")
    from redqueen_tpu_torch.models import rmtpp

    w = rmtpp.init_weights(0, hidden=cfg.rmtpp_hidden, device="cpu")
    pb, ab = rt.stack_components([rmtpp.attach(p, w)] * 2, [a] * 2)
    whole = rt.simulate_batch(cfg, pb, ab, np.arange(2), engine="auto",
                              device="cpu")
    assert whole.engine == "scan" and "rmtpp" in whole.engine_reason
    _same_port_logs(whole, rt.simulate_batch(cfg, pb, ab, np.arange(2),
                                             slab=1, device="cpu"))
