"""Shared pieces of the port's CPU parity tests against the JAX package's
scan engine: the same component built by both packages, the same seeds
through both, and the comparison of their logs.

The JAX package's keyed draws depend on ``jax_threefry_partitionable``;
the port mirrors the ``True`` layout, so :func:`partitionable` pins it
for every test of a module that imports it (and restores the old value).

Tolerance: ``srcs``, ``n_events``, health and ``dispatches`` identical;
``times`` within rtol 1e-6 (torch's and XLA's CPU ``log1p`` may differ by
an ulp)."""

import jax
import numpy as np
import pytest

import redqueen_tpu as J
import redqueen_tpu_torch as rt

RTOL = 1e-6


@pytest.fixture(autouse=True)
def autotune_cache(tmp_path, monkeypatch):
    """The lane layer's autotune cache in the test's own directory."""
    monkeypatch.setenv("RQ_LANES_AUTOTUNE", str(tmp_path / "autotune.json"))


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def golden(gb):
    """``tests/test_golden.py``'s component: one Opt against a Poisson
    wall of rate 1 on each feed."""
    gb.add_opt(q=1.0)
    for i in range(gb.n_sinks):
        gb.add_poisson(rate=1.0, sinks=[i])


def every_kind(gb):
    """Every non-neural kind on 5 feeds, two Opt rows among them."""
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_piecewise([0.0, 7.0], [1.0, 0.3], sinks=[2])
    gb.add_realdata([1.0, 2.5, 6.0, 14.0], sinks=[3])
    gb.add_poisson(rate=0.7, sinks=[4])
    gb.add_opt(q=0.5, sinks=[1, 3])


def opt_rows(n):
    """``n`` Opt rows on two of 5 feeds each, and a Poisson wall per
    feed: the unrolled react path up to 4 rows, the masked one above."""
    def fill(gb):
        for r in range(n):
            gb.add_opt(q=0.5 + 0.1 * r, sinks=[r % 5, (r + 2) % 5])
        for i in range(5):
            gb.add_poisson(rate=1.0, sinks=[i])
    return fill


def build(pkg, fill, F, T, capacity, B, **kw):
    """``(cfg, params [B], adj [B])`` of ``B`` copies of one component
    built by ``pkg`` (``redqueen_tpu`` or ``redqueen_tpu_torch``)."""
    gb = pkg.GraphBuilder(n_sinks=F, end_time=T)
    fill(gb)
    cfg, p, a = gb.build(capacity=capacity, **kw)
    params, adj = pkg.stack_components([p] * B, [a] * B)
    return cfg, params, adj


def build_both(fill, F, T, capacity, B):
    return (build(J, fill, F, T, capacity, B),
            build(rt, fill, F, T, capacity, B, device="cpu"))


def assert_same_log(lj, lt, rtol=RTOL):
    """A JAX ``EventLog`` against the port's (batched or single)."""
    sj, st = np.asarray(lj.srcs), lt.srcs.numpy()
    assert sj.shape == st.shape
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(lt.n_events.numpy(),
                                  np.asarray(lj.n_events))
    if lj.health is not None:
        np.testing.assert_array_equal(lt.health.numpy(),
                                      np.asarray(lj.health))
    tj, tt = np.asarray(lj.times), lt.times.numpy()
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(tj))
    fin = np.isfinite(tj)
    np.testing.assert_allclose(tt[fin], tj[fin], rtol=rtol, atol=0)
    assert lt.dispatches == lj.dispatches


def run_both(fill, F, T, capacity, B, seeds=None, **kw):
    """The same batch through both scan engines: ``(jax log, port log)``."""
    (cj, pj, aj), (ct, pt, at) = build_both(fill, F, T, capacity, B)
    seeds = np.arange(B) if seeds is None else seeds
    lj = J.simulate_batch(cj, pj, aj, seeds, **kw)
    lt = rt.simulate_batch(ct, pt, at, seeds, device="cpu", **kw)
    return lj, lt


def state_fields(state):
    """A JAX ``SimState`` as one numpy array per field (None kept)."""
    from redqueen_tpu_torch.config import STATE_FIELDS

    return {f: None if getattr(state, f) is None
            else np.asarray(getattr(state, f)) for f in STATE_FIELDS}
