"""The inputs are a function of ``--seed`` alone, for seeds of any
size, and the work count reads only events and shapes."""

import numpy as np
import pytest
import torch

import redqueen_tpu_torch as rt
from portbench import roofline
from portbench.drivers import serve, sim
from portbench.reference import sim as ref

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_seeds_are_fixed_by_the_seed(seed):
    a = sim.lane_seeds(seed, 3, 1000)
    assert np.array_equal(a, sim.lane_seeds(seed, 3, 1000))
    assert a.min() >= 0 and a.max() < 2 ** 32
    assert not np.array_equal(a, sim.lane_seeds(seed, 4, 1000))
    assert not np.array_equal(a, sim.lane_seeds(seed + 1, 3, 1000))


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_stream_and_arrivals_are_fixed_by_the_seed(seed):
    a = serve.stream(seed, 50, 2048, 64.0, 1.0)
    b = serve.stream(seed, 50, 2048, 64.0, 1.0)
    for (s1, t1, f1), (s2, t2, f2) in zip(a, b):
        assert s1 == s2 and np.array_equal(t1, t2) and np.array_equal(f1, f2)
        assert np.all(np.diff(t1) >= 0) and f1.max(initial=0) < 2048
    assert [s for s, _, _ in a] == list(range(50))
    d = serve.arrivals(seed, 200, 1000.0)
    assert np.array_equal(d, serve.arrivals(seed, 200, 1000.0))
    assert np.all(np.diff(d) > 0)
    other = serve.stream(seed + 1, 50, 2048, 64.0, 1.0)
    assert any(len(x[1]) != len(y[1]) or not np.array_equal(x[1], y[1])
               for x, y in zip(a, other))


def _source_counts(srcs, nev, S):
    valid = np.arange(srcs.shape[1])[None, :] < nev[:, None]
    return np.bincount(np.where(valid, srcs, S).ravel(),
                       minlength=S + 1)[:S]


def _headline(B, T, capacity):
    gb = rt.GraphBuilder(n_sinks=10, end_time=T)
    opt = gb.add_opt(q=1.0)
    for f in range(10):
        gb.add_poisson(rate=1.0, sinks=[f])
    cfg, p0, a0 = gb.build(capacity=capacity, device="cpu")
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, opt


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_work_count_ignores_chunking(engine):
    """The same events at two chunk capacities and two launch sizes (so
    other launch counts, padded steps and log widths) give the same work
    and least time."""
    B, T = 6, 15.0
    seeds = np.arange(B) + 99
    comp = ref.headline_component(dict(followers=10, wall_rate=1.0, q=1.0,
                                       s_sink=1.0, end_time=T))
    out = []
    for capacity, k in ((16, 1), (64, 8)):
        cfg, params, adj, _ = _headline(B, T, capacity)
        log = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=200,
                                sync_every=k, engine=engine, device="cpu")
        srcs, nev = log.srcs.numpy(), log.n_events.numpy()
        counts = _source_counts(srcs, nev, comp.S)
        padded = np.pad(srcs, ((0, 0), (0, 37)), constant_values=-1)
        assert np.array_equal(counts,
                              _source_counts(padded, nev, comp.S))
        out.append((log.times.shape[1], log.dispatches, nev.copy(),
                    roofline.work(comp.kind == ref.OPT, comp.adj, counts, B)))
    (w0, d0, n0, a), (w1, d1, n1, b) = out
    assert (w0, d0) != (w1, d1)
    assert np.array_equal(n0, n1)
    assert a == b
    assert roofline.least_s(a) == roofline.least_s(b) > 0
    assert a["events"] == n0.sum()
