"""The port end to end on the CPU: builder -> engine -> metrics against
the JAX package on the same component and seeds (the fused engine
against the JAX megakernel, the scan engine, the default of both
packages, against the JAX scan engine), the 4σ quality gate against the
NumPy oracle (as tests/test_pallas_chunk.py gates the JAX megakernel),
the scan engine's contracts (``max_events``, ``return_state`` and
``resume``, key-array seeds, the engine choice), the import boundary of
the port, and its default device."""

import ast
import dataclasses
import os

import jax  # noqa: F401  (platform selection happens in conftest)
import numpy as np
import pytest
import torch

import redqueen_tpu as J
from jax import random as jr
from redqueen_tpu.config import GraphBuilder as JaxBuilder
from redqueen_tpu.config import stack_components as jax_stack
from redqueen_tpu.ops.pallas_engine import simulate_pallas
from redqueen_tpu.oracle.numpy_ref import SimOpts
from redqueen_tpu.utils import metrics as jm
from redqueen_tpu.utils import metrics_pandas as mp
import redqueen_tpu_torch as rt
from redqueen_tpu_torch.ops import event_engine
import torch_parity as tp
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(pkg_builder, F, T, q, rate, capacity, **build_kw):
    gb = pkg_builder(n_sinks=F, end_time=T)
    me = gb.add_opt(q=q)
    for i in range(F):
        gb.add_poisson(rate=rate, sinks=[i])
    return (*gb.build(capacity=capacity, **build_kw), me)


def test_slice_matches_jax_slice():
    F, T, B, k = 10, 20.0, 6, 8
    cap, mc = rt.shape_budget(F, T, 1.0)
    cj, pj, aj, me = _build(JaxBuilder, F, T, 1.0, 1.0, cap)
    pbj, abj = jax_stack([pj] * B, [aj] * B)
    lj = simulate_pallas(cj, pbj, abj, np.arange(B), max_chunks=mc,
                         interpret=True, sync_every=k)
    mj = jm.feed_metrics_batch(lj.times, lj.srcs, abj, me, T)
    ct, pt, at, me_t = _build(rt.GraphBuilder, F, T, 1.0, 1.0, cap,
                              device="cpu")
    pbt, abt = rt.stack_components([pt] * B, [at] * B)
    lt = rt.simulate_batch(ct, pbt, abt, np.arange(B), max_chunks=mc,
                           sync_every=k, engine="fused", device="cpu")
    mt = rt.feed_metrics_batch(lt.times, lt.srcs, abt, me_t, T)
    assert me_t == me and lt.engine == "plain"
    np.testing.assert_array_equal(lt.n_events.numpy(),
                                  np.asarray(lj.n_events))
    np.testing.assert_array_equal(lt.srcs.numpy(), np.asarray(lj.srcs))
    np.testing.assert_array_equal(rt.num_posts(lt.srcs, me).numpy(),
                                  np.asarray(jm.num_posts(lj.srcs, me)))
    # Each event time may differ by an ulp (the log1p gap); an integral
    # moves by at most the sum of its lane's event-time shifts.
    tj, tt = np.asarray(lj.times, np.float64), lt.times.numpy().astype(
        np.float64)
    fin = np.isfinite(tj)
    shift = np.abs(np.where(fin, tt, 0.0) - np.where(fin, tj, 0.0)).sum(1)
    np.testing.assert_allclose(tt[fin], tj[fin], rtol=1e-6, atol=0)
    top_t = mt.mean_time_in_top_k().numpy().astype(np.float64)
    top_j = np.asarray(mj.mean_time_in_top_k(), np.float64)
    assert np.all(np.abs(top_t - top_j) <= shift + 1e-6 * np.abs(top_j))


def _oracle_gate(engine):
    """Time-in-top-1 and posts of the port on ``engine`` agree with the
    NumPy oracle within 4 sigma (independent streams on each side)."""
    F, T, q, rate, B = 4, 30.0, 1.0, 1.0, 24
    cap, mc = rt.shape_budget(F, T, rate)
    cfg, p0, a0, me = _build(rt.GraphBuilder, F, T, q, rate, cap,
                             device="cpu")
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    log = rt.simulate_batch(cfg, params, adj, np.arange(B), max_chunks=mc,
                            engine=engine, device="cpu")
    tops_p = rt.feed_metrics_batch(log.times, log.srcs, adj, me, T) \
        .mean_time_in_top_k().numpy()
    posts_p = rt.num_posts(log.srcs, me).numpy()
    tops_o, posts_o = [], []
    for seed in range(12):
        others = [
            ("poisson", dict(src_id=100 + i, seed=3000 + 53 * seed + i,
                             rate=rate, sink_ids=[i]))
            for i in range(F)
        ]
        so = SimOpts(src_id=0, sink_ids=list(range(F)),
                     other_sources=others, end_time=T, q=q)
        df = so.create_manager_with_opt(seed=seed).run_till() \
            .state.get_dataframe()
        tops_o.append(mp.time_in_top_k(df, 1, T, src_id=0,
                                       sink_ids=so.sink_ids))
        posts_o.append(mp.num_posts_of_src(df, 0))
    for name, a, b in [("top1", tops_p, np.asarray(tops_o)),
                       ("posts", posts_p, np.asarray(posts_o))]:
        se = np.sqrt(a.var() / len(a) + b.var() / len(b))
        assert abs(a.mean() - b.mean()) < 4 * max(se, 1e-9), (
            name, a.mean(), b.mean())


def test_slice_passes_the_oracle_gate():
    _oracle_gate("fused")


def test_scan_engine_passes_the_oracle_gate():
    _oracle_gate("scan")


def _port_files():
    pkg = os.path.join(REPO, "redqueen_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas",
             "redqueen_tpu")
# The pandas export and evaluation layer and the NumPy oracle's copy, and
# nothing else, import pandas (the package's __init__ imports none of
# them).
PANDAS_MODULES = ("redqueen_tpu_torch/utils/dataframe.py",
                  "redqueen_tpu_torch/utils/metrics_pandas.py",
                  "redqueen_tpu_torch/oracle/numpy_ref.py")


def test_port_imports_no_jax_flax_pandas_or_reference():
    files = _port_files()
    assert len(files) >= 15
    bad = []
    for path in files:
        rel = os.path.relpath(path, REPO)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.ImportFrom):
                names = [f".{node.module}"] + [f".{a.name}"
                                               for a in node.names]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top == "pandas" and rel in PANDAS_MODULES:
                    continue
                if top in FORBIDDEN:
                    bad.append(f"{rel}: {name}")
                if rel == "redqueen_tpu_torch/__init__.py" and (
                        "pandas" in name or "dataframe" in name):
                    bad.append(f"{rel}: {name}")
    assert not bad, bad


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    cfg, p, a, _ = _build(rt.GraphBuilder, 2, 5.0, 1.0, 1.0, 16,
                          device="cpu")
    pb, ab = rt.stack_components([p], [a])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.simulate_batch(cfg, pb, ab, np.array([0]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        event_engine.simulate_fused(cfg, pb, ab, np.array([0]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.source_params_from_numpy(rt.source_params_to_numpy(pb))


def _headline_both(B, T=10.0, capacity=64):
    return tp.build_both(tp.golden, 4, T, capacity, B)


def test_default_call_gives_the_jax_default_stream():
    """``simulate_batch(cfg, params, adj, seeds)`` with no engine runs the
    scan engine in both packages and gives the same stream."""
    (cj, pj, aj), (ct, pt, at) = _headline_both(6)
    lj = J.simulate_batch(cj, pj, aj, np.arange(6))
    lt = rt.simulate_batch(ct, pt, at, np.arange(6), device="cpu")
    assert lj.engine == lt.engine == "scan" and lt.engine_reason is None
    tp.assert_same_log(lj, lt)


@pytest.mark.parametrize("fill,F,T,cap", [
    (tp.golden, 4, 20.0, 64), (tp.every_kind, 5, 15.0, 16)])
def test_engine_scan_matches_the_jax_scan_engine(fill, F, T, cap):
    lj, lt = tp.run_both(fill, F, T, cap, 6, engine="scan")
    tp.assert_same_log(lj, lt)


@pytest.mark.parametrize("max_events", [5, np.array([0, 3, 11, 40, 1, 7])])
def test_max_events_stops_each_lane_exactly_on_a_prefix(max_events):
    (cj, pj, aj), (ct, pt, at) = _headline_both(6)
    full = rt.simulate_batch(ct, pt, at, np.arange(6), device="cpu")
    lt = rt.simulate_batch(ct, pt, at, np.arange(6), max_events=max_events,
                           device="cpu")
    lj = J.simulate_batch(cj, pj, aj, np.arange(6), max_events=max_events)
    tp.assert_same_log(lj, lt)
    want = np.broadcast_to(max_events, (6,))
    np.testing.assert_array_equal(lt.n_events.numpy(), want)
    for b, n in enumerate(want):
        assert torch.equal(lt.srcs[b, :n], full.srcs[b, :n])
        assert torch.equal(lt.times[b, :n].view(torch.int32),
                           full.times[b, :n].view(torch.int32))
        assert (lt.srcs[b, n:] == -1).all()


def test_return_state_and_resume_equal_the_continuous_run():
    (cj, pj, aj), (ct, pt, at) = _headline_both(6, T=5.0)
    ct2 = dataclasses.replace(ct, end_time=10.0)
    cont = rt.simulate_batch(ct2, pt, at, np.arange(6), device="cpu")
    first, state = rt.simulate_batch(ct, pt, at, np.arange(6),
                                     return_state=True, device="cpu")
    assert isinstance(state, rt.SimState) and state.batch_size == 6
    ext, _ = rt.resume(ct2, pt, at, state)
    for b in range(6):
        n1, n2 = int(first.n_events[b]), int(ext.n_events[b])
        assert n1 + n2 == int(cont.n_events[b]) and n2 > 0
        assert torch.equal(torch.cat([first.srcs[b, :n1], ext.srcs[b, :n2]]),
                           cont.srcs[b, :n1 + n2])
        assert torch.equal(
            torch.cat([first.times[b, :n1], ext.times[b, :n2]])
            .view(torch.int32), cont.times[b, :n1 + n2].view(torch.int32))
    # The JAX package's resume of its own carry gives the same extension.
    _, sj = J.simulate_batch(cj, pj, aj, np.arange(6), return_state=True)
    lj, _ = J.resume(dataclasses.replace(cj, end_time=10.0), pj, aj, sj)
    tp.assert_same_log(lj, ext)


def test_key_array_seeds_equal_prng_key_seeds():
    (cj, pj, aj), (ct, pt, at) = _headline_both(6)
    keys = np.asarray(jax.vmap(jr.PRNGKey)(np.arange(6)))
    by_int = rt.simulate_batch(ct, pt, at, np.arange(6), device="cpu")
    by_key = rt.simulate_batch(ct, pt, at, keys, device="cpu")
    assert torch.equal(by_int.srcs, by_key.srcs)
    split = np.asarray(jr.split(jr.PRNGKey(11), 6))
    tp.assert_same_log(J.simulate_batch(cj, pj, aj, split),
                       rt.simulate_batch(ct, pt, at, split, device="cpu"))


@pytest.mark.parametrize("kw,reason", [
    (dict(), "runs on the card"),
    (dict(max_events=3), "max_events"),
    (dict(return_state=True), "return_state"),
    (dict(seeds=np.zeros((1, 2), np.uint32)), "key-array seeds"),
])
def test_auto_takes_the_scan_engine_with_its_reason(kw, reason):
    cfg, p, a, _ = _build(rt.GraphBuilder, 2, 5.0, 1.0, 1.0, 16,
                          device="cpu")
    pb, ab = rt.stack_components([p], [a])
    seeds = kw.pop("seeds", np.array([0]))
    out = rt.simulate_batch(cfg, pb, ab, seeds, engine="auto", device="cpu",
                            **kw)
    log = out[0] if isinstance(out, tuple) else out
    assert log.engine == "scan" and reason in log.engine_reason
    if reason != "runs on the card":
        with pytest.raises(ValueError, match=f"engine='fused'.*{reason}"):
            rt.simulate_batch(cfg, pb, ab, seeds, engine="fused",
                              device="cpu", **kw)


def test_select_engine_on_the_card_and_its_shape_limit():
    cfg, p, a, _ = _build(rt.GraphBuilder, 2, 5.0, 1.0, 1.0, 16,
                          device="cpu")
    pb, _ = rt.stack_components([p], [a])
    assert rt.select_engine(cfg, pb, engine="auto", device="cuda") == \
        ("fused", None)
    assert rt.select_engine(cfg, pb, engine="scan") == ("scan", None)
    assert rt.select_engine(cfg, pb, engine="fused", device="cpu") == \
        ("fused", None)
    gb = rt.GraphBuilder(n_sinks=1, end_time=5.0)
    for _ in range(40):
        gb.add_poisson(rate=1.0)
    big, pbig, _ = gb.build(capacity=16, device="cpu")
    name, why = rt.select_engine(big, pbig, engine="auto", device="cuda")
    assert name == "scan" and "MAX_S" in why


def test_unknown_engine_rejected():
    cfg, p, a, _ = _build(rt.GraphBuilder, 2, 5.0, 1.0, 1.0, 16,
                          device="cpu")
    pb, ab = rt.stack_components([p], [a])
    with pytest.raises(ValueError, match="unknown engine"):
        rt.simulate_batch(cfg, pb, ab, np.array([0]), engine="warp",
                          device="cpu")


def test_non_finite_params_rejected_host_side():
    cfg, p, a, _ = _build(rt.GraphBuilder, 2, 5.0, 1.0, 1.0, 16,
                          device="cpu")
    pb, ab = rt.stack_components([p], [a])
    pb.rate[0, 1] = float("nan")
    with pytest.raises(ValueError, match="SourceParams.rate"):
        rt.simulate_batch(cfg, pb, ab, np.array([0]), device="cpu")
