"""The port's learning experiments on the CPU: ``closed_loop --quick``
recovers its world inside the JAX package's ``TOLERANCES`` (the same
numbers) and equals the reference's ``run()`` at the same settings, and
``live_swap --quick`` (a learner in a fresh interpreter SIGKILLed
mid-fit, a regime shift, a guarded hot swap, the recovery audit) passes
every bound of the reference's.

closed_loop against the reference (its world built at a 4,096-event
chunk, the port's at :data:`closed_loop.CAPACITY`): the simulated
stream's event count, each solver's iteration count and every control
world's posts identical; the fitted parameters and log-likelihoods
within rtol 2e-5 (the ``tests/test_torch_learn.py`` solvers' float32
ulps, rtol 1e-5 over 20 iterations, compounded here over 80 and 150);
the recovery errors within rtol 2e-5; the control costs, each lane's
integral run against a fitted world that differs by those parameters,
and their spread over 4 lanes within rtol 5e-5; the cost gaps,
differences of two such costs, within 1e-5 absolute."""

import os
import subprocess
import sys

import numpy as np
import pytest

from redqueen_tpu_torch.runtime import integrity
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RTOL = 2e-5
COST_RTOL = 5e-5


@pytest.fixture(scope="module")
def closed_loop_quick(tmp_path_factory):
    from redqueen_tpu_torch.experiments import closed_loop

    out = str(tmp_path_factory.mktemp("cl") / "cl.json")
    assert closed_loop.main(["--quick", "--device", "cpu", "--out",
                             out]) == 0
    return integrity.read_json(out, schema="rq.learn.closed_loop/1")


def test_closed_loop_quick_inside_its_tolerances(closed_loop_quick):
    from experiments import closed_loop as jcl
    from redqueen_tpu_torch.experiments import closed_loop

    assert closed_loop.TOLERANCES == jcl.TOLERANCES
    p = closed_loop_quick
    assert p["passed"] and p["platform"] == "cpu"
    for s, e in p["solvers"].items():
        assert e["recovered_within_tol"], s
        for k in ("mu_rel_err", "branching_abs_err", "beta_rel_err"):
            assert e[k] <= jcl.TOLERANCES[k], (s, k)
        assert (p["control_costs"][s]["rel_gap_vs_true"]
                <= jcl.TOLERANCES["control_cost_rel_gap"])
        assert e["sick_dims"] == 0


def test_closed_loop_quick_equals_the_reference(closed_loop_quick):
    """The reference's ``run()`` at ``--quick``'s settings."""
    from experiments import closed_loop as jcl

    ref = jcl.run(T_fit=300.0, n_seeds=4, em_iters=80, fw_iters=150)
    p = closed_loop_quick
    assert p["n_events_fit"] == ref["n_events_fit"]
    assert p["passed"] == ref["passed"]
    assert set(p["solvers"]) == set(ref["solvers"])
    for s, e in p["solvers"].items():
        r = ref["solvers"][s]
        assert e["n_iter"] == r["n_iter"] and e["converged"] == \
            r["converged"] and e["sick_dims"] == r["sick_dims"], s
        for k in ("mu", "alpha_diag", "beta", "final_loglik", "mu_rel_err",
                  "branching_abs_err", "beta_rel_err"):
            np.testing.assert_allclose(e[k], r[k], rtol=RTOL,
                                       err_msg=f"{s} {k}")
    np.testing.assert_allclose(p["true"]["loglik_at_truth"],
                               ref["true"]["loglik_at_truth"], rtol=RTOL)
    for w, c in p["control_costs"].items():
        r = ref["control_costs"][w]
        assert c["mean_posts"] == r["mean_posts"], w
        assert c["sick_lanes"] == r["sick_lanes"] == 0, w
        for k in ("mean_cost", "std_cost", "mean_avg_rank"):
            np.testing.assert_allclose(c[k], r[k], rtol=COST_RTOL,
                                       err_msg=f"{w} {k}")
        if "rel_gap_vs_true" in r:
            assert abs(c["rel_gap_vs_true"] - r["rel_gap_vs_true"]) <= 1e-5


def test_live_swap_quick_passes(tmp_path):
    from experiments import live_swap as jls

    out = str(tmp_path / "ls.json")
    env = dict(os.environ)
    env.pop("RQ_FAULT", None)
    r = subprocess.run(
        [sys.executable, "-m", "redqueen_tpu_torch.experiments.live_swap",
         "--quick", "--device", "cpu", "--out", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    p = integrity.read_json(out, schema="rq.learn.live_swap/1")
    assert p["pass"] and p["platform"] == "cpu"
    assert p["bounds"] == jls.BOUNDS
    assert p["learner_kill"]["rc"] == -9
    assert p["learner_kill"]["journal_untouched"]
    assert p["recovery"]["canary_nll"]["pass"]
    assert p["audit"]["params_bit_identical"]
    lat = p["latency"]["journal_write_to_params_live_s"]
    assert 0.0 < lat <= p["latency"]["bound_s"]
