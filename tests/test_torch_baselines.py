"""The port's offline baseline (``redqueen_tpu_torch/baselines.py``)
against the JAX package's on the CPU, in float32 as there.

Tolerances: the fitted rates within rtol 1e-5 (atol 1e-7 for a segment
the fit leaves at zero): both bisections run the same fixed iteration
counts, and a decision flipped by an ulp of the sums moves the root by
far less; the objective within rtol 1e-5."""

import numpy as np
import pytest

from redqueen_tpu import baselines as jb
from redqueen_tpu_torch import baselines as tb


CASES = {
    "uniform": (np.full((3, 4), 2.0), np.full(4, 25.0), 20.0),
    "heterogeneous": (np.random.RandomState(0).uniform(0.1, 5.0, (7, 6)),
                      np.random.RandomState(1).uniform(5.0, 20.0, 6), 10.0),
    "big_budget": (np.random.RandomState(2).uniform(0.1, 5.0, (5, 3)),
                   np.array([10.0, 30.0, 60.0]), 300.0),
    "quiet_and_busy": (np.array([[1e-4, 1.0, 500.0]]), np.ones(3), 2.0),
    "zero_rates": (np.array([[0.0, 2.0], [0.0, 2.0]]), np.array([10.0, 10.0]),
                   4.0),
    "one_follower": (np.array([0.5, 3.0, 1.0]), np.array([20.0, 20.0, 20.0]),
                     15.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_offline_rates_match_jax(case):
    L, d, budget = CASES[case]
    mu_j = np.asarray(jb.offline_rates(L, d, budget))
    mu_t = tb.offline_rates(L, d, budget, device="cpu")
    np.testing.assert_allclose(mu_t.numpy(), mu_j, rtol=1e-5, atol=1e-7)
    assert np.isclose(float((d * mu_t.numpy()).sum()), budget, rtol=1e-3)
    np.testing.assert_allclose(
        float(tb.offline_visibility(mu_t, L, d)),
        float(jb.offline_visibility(mu_j, L, d)), rtol=1e-5)


def test_offline_schedule_matches_jax_and_validates():
    L = np.tile([0.4, 3.0], (4, 1))
    ct_t, r_t = tb.offline_schedule(L, [0.0, 30.0], 60.0, 25.0, device="cpu")
    ct_j, r_j = jb.offline_schedule(L, [0.0, 30.0], 60.0, 25.0)
    np.testing.assert_array_equal(ct_t, ct_j)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-5)
    assert r_t.dtype == np.float64
    with pytest.raises(ValueError, match="strictly increasing"):
        tb.offline_schedule(L, [0.0, 0.0], 60.0, 25.0, device="cpu")
    with pytest.raises(ValueError, match="must precede end_time"):
        tb.offline_schedule(L, [0.0, 60.0], 60.0, 25.0, device="cpu")


def test_budget_matched_poisson_rate():
    assert tb.budget_matched_poisson_rate(50, 100.0) == \
        jb.budget_matched_poisson_rate(50, 100.0) == 0.5
    assert tb.budget_matched_poisson_rate(30, 20.0, start_time=5.0) == 2.0
