"""The port's sweeps (``redqueen_tpu_torch/sweep.py``) against the JAX
package's ``run_sweep`` and ``run_sweep_star`` on the CPU, at the same
seeds (``jax_threefry_partitionable`` pinned to True).

Tolerances: ``n_posts`` and ``health`` identical; ``time_in_top_k``,
``average_rank`` and ``int_rank2`` within rtol 1e-5 (sums in another
order)."""

import numpy as np
import pytest

import redqueen_tpu as J
from redqueen_tpu import sweep as jsweep
from redqueen_tpu.parallel import bigf as JB
import redqueen_tpu_torch as rt
from redqueen_tpu_torch import sweep
from redqueen_tpu_torch.parallel import bigf as TB
from redqueen_tpu_torch.runtime import faultinject, numerics
from torch_parity import partitionable  # noqa: F401  (autouse fixture)


def q_points(pkg, q_grid, F=5, T=12.0, capacity=128, start=0.0, **kw):
    pts = []
    for q in q_grid:
        gb = pkg.GraphBuilder(n_sinks=F, end_time=T, start_time=start)
        gb.add_opt(q=q)
        for i in range(F):
            gb.add_poisson(rate=1.0, sinks=[i])
        pts.append(gb.build(capacity=capacity, **kw))
    return pts


def star_points(pkg, q_grid, F=6, T=12.0, **kw):
    pts = []
    for q in q_grid:
        sb = pkg.StarBuilder(n_feeds=F, end_time=T)
        for f in range(F):
            sb.wall_poisson(f, 1.0 + 0.2 * f)
        sb.ctrl_opt(q=q)
        pts.append(sb.build(wall_cap=64, post_cap=256, **kw))
    return pts


def same_grid(rt_, rj):
    assert rt_.n_points == rj.n_points and rt_.n_seeds == rj.n_seeds
    np.testing.assert_array_equal(rt_.n_posts, np.asarray(rj.n_posts))
    np.testing.assert_array_equal(rt_.health, np.asarray(rj.health))
    for f in ("time_in_top_k", "average_rank", "int_rank2"):
        np.testing.assert_allclose(getattr(rt_, f), np.asarray(getattr(rj, f)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("start", [0.0, 3.0])
def test_run_sweep_matches_jax(start):
    grid = [0.3, 1.0, 4.0]
    rj = jsweep.run_sweep(q_points(J, grid, start=start), n_seeds=4, seed0=2)
    rt_ = sweep.run_sweep(q_points(rt, grid, start=start, device="cpu"),
                          n_seeds=4, seed0=2, device="cpu")
    same_grid(rt_, rj)
    posts = rt_.n_posts.mean(1)
    assert posts[0] > posts[1] > posts[2]
    assert rt_.n_posts.dtype == np.int32 and rt_.health.dtype == np.uint32


def test_run_sweep_star_matches_jax():
    grid = [0.25, 1.0, 4.0]
    rj = jsweep.run_sweep_star(star_points(JB, grid), n_seeds=3, seed0=5)
    rt_ = sweep.run_sweep_star(star_points(TB, grid, device="cpu"),
                               n_seeds=3, seed0=5, device="cpu")
    same_grid(rt_, rj)
    rd = sweep.run_sweep_star(star_points(TB, grid, device="cpu"),
                              n_seeds=3, seed0=5, fire_mode="doubling",
                              device="cpu")
    for a, b in zip(rt_, rd):
        np.testing.assert_array_equal(a, b)


def test_seed_layout_extends_without_reshuffle():
    small = sweep.run_sweep(q_points(rt, [1.0], device="cpu"), n_seeds=3,
                            device="cpu")
    both = sweep.run_sweep(q_points(rt, [1.0, 3.0], device="cpu"), n_seeds=3,
                           device="cpu")
    np.testing.assert_array_equal(small.n_posts[0], both.n_posts[0])
    np.testing.assert_array_equal(small.time_in_top_k[0],
                                  both.time_in_top_k[0])


def test_sick_lane_is_labelled_in_the_grid(monkeypatch):
    monkeypatch.setenv(faultinject.ENV_FAULT, "numeric:nan@lane3")
    res = sweep.run_sweep(q_points(rt, [1.0, 2.0], device="cpu"), n_seeds=2,
                          device="cpu")
    sick = np.argwhere(res.health != 0).tolist()
    assert sick == [[1, 1]]
    assert res.health[1, 1] & numerics.BIT_NONFINITE_TIME or \
        res.health[1, 1] & numerics.BIT_NONFINITE_STATE


def test_bad_sweeps_rejected(tmp_path):
    with pytest.raises(ValueError, match="empty sweep"):
        sweep.run_sweep([], n_seeds=2, device="cpu")
    with pytest.raises(ValueError, match="n_seeds"):
        sweep.run_sweep(q_points(rt, [1.0], device="cpu"), n_seeds=0,
                        device="cpu")
    a = q_points(rt, [1.0], F=4, device="cpu")
    b = q_points(rt, [1.0], F=5, device="cpu")
    with pytest.raises(ValueError, match="different static config"):
        sweep.run_sweep(a + b, n_seeds=2, device="cpu")
    # A mesh of one rank runs the sweep to the unsharded grid, and
    # refuses the event kernel as the JAX package does.
    from redqueen_tpu_torch.parallel import comm
    from torch_mesh_world import one_rank

    spts = star_points(TB, [1.0], device="cpu")
    with one_rank(tmp_path):
        mesh = comm.make_mesh({"data": 1})
        got = sweep.run_sweep_star(spts, 2, mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="scan engine only"):
            sweep.run_sweep(a, n_seeds=2, mesh=mesh, engine="fused",
                            device="cpu")
    for x, y in zip(got, sweep.run_sweep_star(spts, 2, device="cpu")):
        np.testing.assert_array_equal(x, y)


def test_new_entry_points_default_to_the_card():
    """Without ``device="cpu"`` every entry point asks for the card and
    raises where torch sees none (no quiet fall back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    cfg, wall, ctrl = star_points(TB, [1.0], device="cpu")[0]
    calls = [
        lambda: TB.simulate_star(cfg, wall, ctrl, seed=0),
        lambda: TB.simulate_star_batch(cfg, *TB.broadcast_star(wall, ctrl, 1),
                                       np.arange(1)),
        lambda: rt.simulate_ragged([2, 3], [0, 1], end_time=1.0),
        lambda: rt.run_preset(rt.build_preset("power_law", B=4), 0),
        lambda: rt.build_preset(1),
        lambda: sweep.run_sweep(q_points(rt, [1.0], device="cpu"), 1),
        lambda: sweep.run_sweep_star([(cfg, wall, ctrl)], 1),
        lambda: rt.offline_rates([[1.0]], [1.0], 1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
