"""The port's samplers and guarded primitives (ops/sampling.py,
runtime/numerics.py) against the JAX package's on the same seeded numpy
inputs: the JAX function under ``vmap``, the port's batched.

Tolerance: the guards' clamps and substitutions bit-identical, their
``log``/``log1p``/``exp`` within an ulp; sampled times within rtol
1e-6 (torch's and XLA's CPU ``exp``/``log1p`` may differ by an ulp),
with identical ``ok`` flags and identical +inf positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random as jr

from redqueen_tpu.ops import sampling as js
from redqueen_tpu.runtime import numerics as jn
from redqueen_tpu_torch.ops import prng
from redqueen_tpu_torch.ops import sampling as ts
from redqueen_tpu_torch.runtime import numerics as tn
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

N = 256


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a.astype(np.float32))


def _keys(seed, n=N):
    return np.asarray(jax.vmap(jr.PRNGKey)(jnp.arange(n) + seed))


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


# Normal floats only: XLA's CPU flushes subnormals to zero, torch keeps
# them, a difference of the backends that no sampler input reaches.
EDGE = np.float32([0.0, -0.0, 2e-38, -1.0, -0.99999994, -2.0, 0.5, 3.0,
                   np.inf, -np.inf, np.nan, 88.0, 100.0, -1e30])


@pytest.mark.parametrize("name", ["safe_log", "safe_log1p", "nan_to_posinf",
                                  "safe_exp"])
def test_guarded_primitives_match(name):
    want = np.asarray(getattr(jn, name)(jnp.asarray(EDGE)))
    got = getattr(tn, name)(torch.from_numpy(EDGE)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    same = (ulps <= (0 if name == "nan_to_posinf" else 1)) \
        | (np.isnan(got) & np.isnan(want))
    assert same.all(), (EDGE[~same], got[~same], want[~same])


def test_default_max_proposals_matches():
    assert tn.DEFAULT_MAX_PROPOSALS == jn.DEFAULT_MAX_PROPOSALS == 1_000_000


def test_exponential_delta_and_from_uniform():
    rng = np.random.RandomState(0)
    rate = rng.uniform(0.1, 5.0, N).astype(np.float32)
    rate[:8] = 0.0
    keys = _keys(11)
    want = jax.vmap(js.exponential_delta)(jnp.asarray(keys),
                                         jnp.asarray(rate))
    _close(ts.exponential_delta(_t(keys), _t(rate)).numpy(), want)
    u = rng.uniform(0, 1, N).astype(np.float32)
    u[8] = np.float32(1 - 2.0**-24)
    want = js.exponential_from_uniform(jnp.asarray(u), jnp.asarray(rate))
    _close(ts.exponential_from_uniform(_t(u), _t(rate)).numpy(), want)


def _hawkes_inputs(seed):
    rng = np.random.RandomState(seed)
    return dict(
        t_from=rng.uniform(0, 20, N), l0=rng.uniform(0.05, 2.0, N),
        alpha=rng.uniform(0.0, 0.9, N), beta=rng.uniform(0.2, 3.0, N),
        exc=rng.uniform(0.0, 3.0, N), exc_t=rng.uniform(-5, 0, N))


ORDER = ("t_from", "l0", "alpha", "beta", "exc", "exc_t")


def test_hawkes_intensity_matches():
    x = _hawkes_inputs(1)
    t = x["t_from"]
    want = js.hawkes_intensity(*(jnp.float32(x[k]) for k in
                                 ("t_from", "l0", "exc", "exc_t", "beta")))
    got = ts.hawkes_intensity(*(_t(x[k]) for k in
                                ("t_from", "l0", "exc", "exc_t", "beta")))
    _close(got.numpy(), want)
    assert t.shape == (N,)


@pytest.mark.parametrize("t_max,cap", [(np.inf, 1_000_000), (25.0, 1_000_000),
                                       (np.inf, 1)])
def test_hawkes_next_time_matches(t_max, cap):
    x = _hawkes_inputs(2)
    keys = _keys(21)

    def one(k, *a):
        return js.hawkes_next_time(k, *a, t_max, max_proposals=cap,
                                   return_ok=True)

    tj, okj = jax.vmap(one)(jnp.asarray(keys),
                            *(jnp.float32(x[k]) for k in ORDER))
    tt, okt = ts.hawkes_next_time(_t(keys), *(_t(x[k]) for k in ORDER),
                                  t_max, max_proposals=cap, return_ok=True)
    _close(tt.numpy(), tj)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    if cap == 1:
        assert not okt.all()     # some entries need more than 1 proposal


def test_hawkes_nan_bound_flags_and_active_mask():
    x = _hawkes_inputs(3)
    x["l0"][:4] = np.nan
    keys = _keys(31)
    active = np.ones(N, bool)
    active[4:8] = False
    tj, okj = jax.vmap(lambda k, *a: js.hawkes_next_time(
        k, *a, np.inf, return_ok=True))(jnp.asarray(keys),
                                        *(jnp.float32(x[k]) for k in ORDER))
    tt, okt = ts.hawkes_next_time(_t(keys), *(_t(x[k]) for k in ORDER),
                                  np.inf, return_ok=True,
                                  active=torch.from_numpy(active))
    assert not okt[:4].any() and not np.asarray(okj)[:4].any()
    assert torch.isinf(tt[4:8]).all() and okt[4:8].all()
    keep = active
    _close(tt.numpy()[keep], np.asarray(tj)[keep])
    np.testing.assert_array_equal(okt.numpy()[keep], np.asarray(okj)[keep])


def test_hawkes_bound_scale_checked_and_followed():
    x = _hawkes_inputs(4)
    keys = _keys(41)
    with pytest.raises(ValueError, match="bound_scale"):
        ts.hawkes_next_time(_t(keys), *(_t(x[k]) for k in ORDER), np.inf,
                            bound_scale=0.5)
    with pytest.raises(ValueError, match="max_proposals"):
        ts.hawkes_next_time(_t(keys), *(_t(x[k]) for k in ORDER), np.inf,
                            max_proposals=0)
    tj = jax.vmap(lambda k, *a: js.hawkes_next_time(
        k, *a, np.inf, bound_scale=3.0))(jnp.asarray(keys),
                                         *(jnp.float32(x[k]) for k in ORDER))
    tt = ts.hawkes_next_time(_t(keys), *(_t(x[k]) for k in ORDER), np.inf,
                             bound_scale=3.0)
    _close(tt.numpy(), tj)


def test_piecewise_next_time_matches():
    rng = np.random.RandomState(5)
    K = 5
    ct = np.sort(rng.uniform(0, 30, (N, K)), 1).astype(np.float32)
    rates = rng.uniform(0, 2, (N, K)).astype(np.float32)
    rates[:16, -1] = 0.0                       # finite total hazard
    ct[16:24, 3:] = np.inf                     # padded knots
    rates[16:24, 3:] = 0.0
    t_from = rng.uniform(-5, 35, N).astype(np.float32)
    keys = _keys(51)
    want = jax.vmap(js.piecewise_next_time)(
        jnp.asarray(keys), jnp.asarray(t_from), jnp.asarray(ct),
        jnp.asarray(rates))
    got = ts.piecewise_next_time(_t(keys), _t(t_from), _t(ct), _t(rates))
    _close(got.numpy(), want)


def test_piecewise_returns_float32_t_from():
    """The reference's property-test case: rate 1e6 from t_from = 49.99999
    returns float32(49.99999), a zero gap after rounding, in both."""
    ct = np.float32([[0.0, 50.0]])
    rates = np.float32([[1e6, 1e6]])
    key = _keys(61, 1)
    want = np.asarray(jax.vmap(js.piecewise_next_time)(
        jnp.asarray(key), jnp.asarray([49.99999]), jnp.asarray(ct),
        jnp.asarray(rates)))
    got = ts.piecewise_next_time(_t(key), torch.tensor([49.99999],
                                                       dtype=torch.float64),
                                 _t(ct), _t(rates)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_piecewise_from_target_uses_the_mirror_draw():
    keys = _t(_keys(71, 8))
    ct = torch.zeros((8, 1))
    rates = torch.ones((8, 1))
    got = ts.piecewise_next_time(keys, torch.zeros(8), ct, rates)
    torch.testing.assert_close(got, prng.exponential(keys), rtol=0, atol=0)
