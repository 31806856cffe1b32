"""The mesh through the port's sweeps and presets
(``redqueen_tpu_torch.sweep``, ``presets.run_preset``) in spawned gloo
worlds of 2 and 4 ranks on the CPU: the mesh cases of
``tests/test_sweep.py`` and ``tests/test_data_presets.py``, a sharded
checkpointed sweep killed after its first chunk and resumed, a sick lane
healed alone, and the repairs of the ragged preset's and the heal's mesh
handling.

Every rank returns the whole grid or dict.  Tolerances: grids and
per-seed values equal to the unsharded run bit for bit, but a mean over
a feed axis split across ranks within rtol 1e-6 (partial sums add in
another order); against the JAX package's sharded runs, post counts and
health identical and the means within rtol 1e-5
(``tests/test_torch_star.py``)."""

import numpy as np
import pytest

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu import sweep as jsweep
from redqueen_tpu.parallel import comm as jcomm
from redqueen_tpu.presets import build_preset as jbuild
from redqueen_tpu.presets import run_preset as jrun
from redqueen_tpu_torch import sweep
from redqueen_tpu_torch.parallel import comm
from torch_mesh_world import (PRESET_2, PRESET_3, SWEEP_Q, one_rank,
                              q_points, run_world, star_q_points)
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

RTOL = 1e-6
METRIC_RTOL = 1e-5
FIELDS = sweep.SweepResult._fields


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, ("sweeps", "presets"),
                         tmp_path_factory.mktemp(f"w{n}"))
            for n in (2, 4)}


def test_sharded_sweep_bit_identical(worlds):
    """``run_sweep`` over ``{"data": 2}`` and ``("dcn", "data")`` on
    ``{"dcn": 2, "data": 2}``: the unsharded grid on every rank, and the
    JAX package's ``{"dcn": 2, "data": 4}`` grid."""
    jres = jsweep.run_sweep(q_points(J, SWEEP_Q), n_seeds=8,
                            mesh=jcomm.make_mesh({"dcn": 2, "data": 4}),
                            axis=("dcn", "data"))
    for n in (2, 4):
        for got in worlds[n]["sweeps"]:
            for f in FIELDS:
                np.testing.assert_array_equal(got[f"sh_{f}"], got[f"ref_{f}"],
                                              err_msg=f)
            np.testing.assert_array_equal(got["sh_n_posts"], jres.n_posts)
            np.testing.assert_array_equal(got["sh_health"], jres.health)
            for f in ("time_in_top_k", "average_rank", "int_rank2"):
                np.testing.assert_allclose(got[f"sh_{f}"], getattr(jres, f),
                                           rtol=METRIC_RTOL, err_msg=f)
            assert "scan engine only" in str(got["engine_error"])


def test_sharded_star_sweep_bit_identical(worlds):
    """``run_sweep_star`` over ``{"data": n}`` (bit for bit) and over
    lanes x feeds (the feed means within rtol 1e-6), against the JAX
    package's ``{"data": 8}``."""
    jres = jsweep.run_sweep_star(star_q_points(J, SWEEP_Q), n_seeds=4,
                                 mesh=jcomm.make_mesh({"data": 8}))
    for n in (2, 4):
        for got in worlds[n]["sweeps"]:
            for f in FIELDS:
                np.testing.assert_array_equal(got[f"star0_{f}"],
                                              got[f"star_ref_{f}"])
                if f in ("n_posts", "health"):
                    np.testing.assert_array_equal(got[f"star1_{f}"],
                                                  got[f"star_ref_{f}"])
                else:
                    np.testing.assert_allclose(got[f"star1_{f}"],
                                               got[f"star_ref_{f}"],
                                               rtol=RTOL)
            np.testing.assert_array_equal(got["star0_n_posts"], jres.n_posts)
            np.testing.assert_allclose(got["star0_time_in_top_k"],
                                       jres.time_in_top_k, rtol=METRIC_RTOL)


def test_sharded_checkpointed_sweep_resumes_bit_for_bit(worlds):
    """Killed once its first chunk (2 points) landed, the sharded sweep
    resumes with the other 3 points only and returns the unsharded grid
    on every rank."""
    for n in (2, 4):
        for got in worlds[n]["sweeps"]:
            assert int(got["ckpt_killed_after"]) == 1
            assert got["ckpt_resumed_points"].tolist() == [2, 1]
            for f in FIELDS:
                np.testing.assert_array_equal(got[f"ckpt_got_{f}"],
                                              got[f"ckpt_want_{f}"])


def test_sharded_checkpointed_sweep_heals_a_sick_lane(worlds):
    """``numeric:nan`` at chunk 1's lane 5 (the sweep's lane 13) is
    recorded sick under the mesh, then re-run alone without it and
    healed to the unfaulted grid."""
    for n in (2, 4):
        for got in worlds[n]["sweeps"]:
            assert got["heal_sick"].tolist() == [13]
            for f in FIELDS:
                want = got[f"ckpt_want_{f}"][:4]
                np.testing.assert_array_equal(got[f"heal_{f}"], want)


def test_batch_preset_runs_sharded(worlds):
    jout = jrun(jbuild(3, **{k: v for k, v in PRESET_3.items()
                              if k != "capacity"}), np.arange(8),
                mesh=jcomm.make_mesh({"data": 8}))
    for n in (2, 4):
        for got in worlds[n]["presets"]:
            for k in ("per_seed_top_k", "per_seed_posts", "events",
                      "mean_time_in_top_k", "mean_posts"):
                np.testing.assert_array_equal(got[f"batch_{k}"],
                                              got[f"batch_ref_{k}"], k)
            assert np.isfinite(got["batch_per_seed_top_k"]).all()
            assert np.isfinite(jout["mean_time_in_top_k"])


def test_star_preset_sweep_with_data_mesh(worlds):
    jout = jrun(jbuild(2, **PRESET_2), np.arange(8),
                mesh=jcomm.make_mesh({"data": 8}))
    for n in (2, 4):
        for got in worlds[n]["presets"]:
            for k in ("per_seed_top_k", "per_seed_posts", "events",
                      "mean_time_in_top_k", "mean_posts"):
                np.testing.assert_array_equal(got[f"star_data_{k}"],
                                              got[f"star_data_ref_{k}"], k)
            np.testing.assert_array_equal(got["star_data_per_seed_posts"],
                                          jout["per_seed_posts"])
            assert int(got["star_data_events"]) == jout["events"]
            np.testing.assert_allclose(got["star_data_per_seed_top_k"],
                                       jout["per_seed_top_k"],
                                       rtol=METRIC_RTOL)


@pytest.mark.parametrize("layout", ["star_feed", "star_2d"])
def test_star_preset_over_the_feed_axis(layout, worlds):
    """A feed-only mesh (seed by seed through ``simulate_star``) and lanes
    x feeds: posts and events bit for bit, the global feed means within
    rtol 1e-6."""
    for n in (2, 4):
        for got in worlds[n]["presets"]:
            for k in ("per_seed_posts", "events", "mean_posts"):
                np.testing.assert_array_equal(got[f"{layout}_{k}"],
                                              got[f"{layout}_ref_{k}"], k)
            np.testing.assert_allclose(got[f"{layout}_per_seed_top_k"],
                                       got[f"{layout}_ref_per_seed_top_k"],
                                       rtol=RTOL)


def test_ragged_preset_with_mesh_raises_the_reference_error(tmp_path):
    """A ragged bundle with a mesh raises the JAX package's ValueError."""
    bundle = rt.build_preset("power_law", B=16, max_followers=4,
                             end_time=2.0)
    with one_rank(tmp_path):
        mesh = comm.make_mesh({"data": 1})
        with pytest.raises(ValueError, match="ragged presets dispatch "
                           "through parallel.lanes.simulate_ragged"):
            rt.run_preset(bundle, 0, mesh=mesh, device="cpu")
        # Batch and star bundles shard on the same mesh.
        b1 = rt.build_preset(1, scale=0.5, end_time=5.0, capacity=64,
                             device="cpu")
        assert rt.run_preset(b1, np.arange(2), mesh=mesh, device="cpu") == \
            rt.run_preset(b1, np.arange(2), device="cpu")
