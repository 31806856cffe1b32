"""The port's mesh layer (``redqueen_tpu_torch.parallel.comm``/``shard``
and the star engine's feed axis) in spawned gloo worlds of 2 and 4 ranks
on the CPU, against the port's own unsharded runs and the JAX package's
sharded runs on its 8 virtual CPU devices: the cases of
``tests/test_sharding.py`` and the mesh cases of ``tests/test_bigf.py``.

Tolerances: the port sharded against the port unsharded bit for bit
(logs, posts, wall streams, per-feed metrics), but a mean over a feed
axis split across ranks within rtol 1e-6 (partial sums add in another
order); the port against the JAX package: ``srcs``, ``n_events``,
health, post counts and ``wall_n`` identical, times within rtol 1e-6
and metrics within rtol 1e-5 (``tests/torch_parity.py`` and
``tests/test_torch_star.py`` say why)."""

import jax
import numpy as np
import pytest
import torch

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu.parallel import comm as jcomm
from redqueen_tpu.parallel.bigf import broadcast_star as jbroadcast
from redqueen_tpu.parallel.bigf import simulate_star as jstar
from redqueen_tpu.parallel.bigf import simulate_star_batch as jstar_batch
from redqueen_tpu.parallel.shard import simulate_sharded as jsharded
from redqueen_tpu.utils.metrics import feed_metrics_batch as jmetrics
from redqueen_tpu_torch.parallel import comm
from torch_mesh_world import (STAR_2D_SHAPES, component, one_rank,
                              run_world, star_poisson)
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

RTOL = 1e-6
METRIC_RTOL = 1e-5
CASES = ("summary", "shard_data", "shard_metrics", "errors", "collectives",
         "star")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, CASES, tmp_path_factory.mktemp(f"w{n}"))
            for n in (2, 4)}


def same_times(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=0)


def jax_log(mesh_axes, axis="data", B=16):
    cfg, params, adj, _ = component(J, B)
    mesh = jcomm.make_mesh(mesh_axes)
    return jsharded(cfg, params, adj, np.arange(B), mesh, axis=axis)


def test_worlds_form_with_their_ranks(worlds):
    """(``test_eight_devices_available``) each world has its ranks, on
    gloo, and a mesh names its axes and ranks only."""
    for n, w in worlds.items():
        for r, got in enumerate(w["summary"]):
            s = dict(eval(str(got["summary"])))
            assert s == {"backend": "gloo", "global_devices": n,
                         "local_devices": 1, "platform": "cpu",
                         "process_count": n, "process_index": r}
            assert str(got["mesh"]) == (f"Mesh({{'data': {n}}}, "
                                        f"ranks={list(range(n))})")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_matches_unsharded_bitwise(n, worlds, tmp_path):
    """``{"data": n}`` against the unsharded run bit for bit on every
    rank, and against the JAX package's ``{"data": 8}``."""
    if n == 1:
        with one_rank(tmp_path):
            cfg, params, adj, _ = component(rt, 16, device="cpu")
            log = rt.parallel.simulate_sharded(
                cfg, params, adj, np.arange(16), comm.make_mesh({"data": 1}),
                device="cpu")
            ref = rt.simulate_batch(cfg, params, adj, np.arange(16),
                                    device="cpu")
            got = rt.parallel.multihost.gather_global(
                {k: getattr(log, k)
                 for k in ("times", "srcs", "n_events", "health")})
        ranks = [{**{f"data_{k}": v for k, v in got.items()},
                  **{f"ref_{k}": np.asarray(getattr(ref, k))
                     for k in ("times", "srcs", "n_events", "health")},
                  "data_engine": np.array(log.engine)}]
    else:
        ranks = worlds[n]["shard_data"]
    want = jax_log({"data": 8})
    for got in ranks:
        assert str(got["data_engine"]) == "scan"
        for k in ("times", "srcs", "n_events", "health"):
            np.testing.assert_array_equal(got[f"data_{k}"], got[f"ref_{k}"])
        np.testing.assert_array_equal(got["data_srcs"], np.asarray(want.srcs))
        np.testing.assert_array_equal(got["data_n_events"],
                                      np.asarray(want.n_events))
        np.testing.assert_array_equal(got["data_health"],
                                      np.asarray(want.health))
        same_times(got["data_times"], want.times)
    if n > 1:
        assert int(ranks[0]["data_local_rows"]) == 16 // n


def test_sharded_metrics_aggregate(worlds):
    """Metrics on each rank's rows, gathered, equal the unsharded ones and
    the JAX package's sharded ones within rtol 1e-6."""
    cfg, params, adj, opt = component(J, 8)
    log = jsharded(cfg, params, adj, np.arange(8),
                   jcomm.make_mesh({"data": 8}))
    adj_b = np.broadcast_to(np.asarray(adj), np.asarray(adj).shape)
    m = jmetrics(log.times, log.srcs, adj_b, opt, cfg.end_time)
    want = np.asarray(m.mean_time_in_top_k())
    for n in (2, 4):
        for got in worlds[n]["shard_metrics"]:
            np.testing.assert_array_equal(got["top"], got["ref_top"])
            np.testing.assert_allclose(got["top"], want, rtol=RTOL)
            assert np.isfinite(got["top"].mean())


def test_indivisible_batch_rejected(worlds, tmp_path):
    for n in (2, 4):
        for got in worlds[n]["errors"]:
            assert "not divisible" in str(got["indivisible"])
            assert str(got["mesh_size"]) == \
                f"ValueError: mesh {{'data': 8}} != {n} devices"
    with one_rank(tmp_path):
        cfg, params, adj, _ = component(rt, 6, device="cpu")
        with pytest.raises(ValueError, match="batch dims disagree"):
            rt.parallel.simulate_sharded(cfg, params, adj, np.arange(5),
                                         comm.make_mesh({"data": 1}),
                                         device="cpu")


def test_collectives_noop_outside_mesh():
    x = torch.tensor([1.0, 2.0])
    np.testing.assert_array_equal(comm.psum(x).numpy(), x.numpy())
    np.testing.assert_array_equal(comm.pmin(x).numpy(), x.numpy())
    np.testing.assert_array_equal(comm.pmax(x).numpy(), x.numpy())
    assert bool(comm.pany(torch.tensor(True)))
    assert not comm.axis_present("data")
    assert comm.axis_size_or_1("data") == 1 and comm.axis_index("feed") == 0
    with pytest.raises(RuntimeError, match="needs a torch.distributed"):
        comm.make_mesh({"data": 1})


def test_collectives_inside_shard_map(worlds, tmp_path):
    """``psum``/``pmin``/``pmax``/``pany`` reduce over the bound axis in
    every world (a world of one rank runs the collective too); the fire
    loop under a sharded feed axis gives the unsharded fires, and
    pointer doubling is refused there."""
    x = np.arange(8.0)
    for n in (2, 4):
        for r, got in enumerate(worlds[n]["collectives"]):
            np.testing.assert_array_equal(got["noop_psum"], [1.0, 2.0])
            np.testing.assert_array_equal(got["noop_pmin"], [1.0, 2.0])
            assert bool(got["noop_pany"])
            np.testing.assert_allclose(got["psum_out"], np.full(8, x.sum()))
            np.testing.assert_array_equal(
                got["sizes"].reshape(n, 4),
                [[n, i, 1, 0] for i in range(n)])
            np.testing.assert_array_equal(got["minmax"], [0.0, 7.0])
            np.testing.assert_array_equal(got["any"], [True])
            np.testing.assert_array_equal(got["fires_sharded"],
                                          got["fires_plain"])
            assert "sharded feed axis" in str(got["doubling_sharded"])
    comm.reset_stats()
    with one_rank(tmp_path):
        mesh = comm.make_mesh({"data": 1})
        out = comm.shard_map(
            lambda b: comm.psum(b.sum(), "data") * torch.ones_like(b),
            mesh, comm.P("data"), comm.P("data"))(torch.arange(8.0))
        np.testing.assert_allclose(
            rt.parallel.multihost.gather_global(out), np.full(8, 28.0))
    assert comm.STATS["psum"][0] == 1


def test_multislice_dcn_axis_bitwise(worlds):
    """``("dcn", "data")`` on ``{"dcn": 2, "data": 2}`` against the
    unsharded run and the JAX package's ``{"dcn": 2, "data": 4}``."""
    want = jax_log({"dcn": 2, "data": 4}, axis=("dcn", "data"))
    for got in worlds[4]["shard_data"]:
        for k in ("times", "srcs", "n_events", "health"):
            np.testing.assert_array_equal(got[f"dcn_{k}"], got[f"ref_{k}"])
        np.testing.assert_array_equal(got["dcn_srcs"], np.asarray(want.srcs))
        same_times(got["dcn_times"], want.times)
        assert int(got["dcn_local_rows"]) == 4
    with pytest.raises(ValueError, match="mesh's order"):
        comm._check_order(type("M", (), {"axis_names": ("dcn", "data")})(),
                          ("data", "dcn"))


# --------------------------------------------------------------------------
# The star engine's follower axis (tests/test_bigf.py's mesh cases)
# --------------------------------------------------------------------------


def test_mesh_layout_invariance(worlds):
    """``simulate_star`` over ``{"feed": n}`` == unsharded bit for bit,
    and == the JAX package's ``{"feed": 8}`` run."""
    cfg, wall, ctrl = star_poisson(J, n_feeds=8)
    jb = jstar(cfg, wall, ctrl, seed=7,
                         mesh=jcomm.make_mesh({"feed": 8}))
    for n in (2, 4):
        for got in worlds[n]["star"]:
            assert int(got["feed_n_posts"]) == int(got["ref_n_posts"]) \
                == jb.n_posts
            for k in ("own_times", "wall_times", "wall_n"):
                np.testing.assert_array_equal(got[f"feed_{k}"],
                                              got[f"ref_{k}"])
            np.testing.assert_array_equal(got["feed_top"], got["ref_top"])
            np.testing.assert_allclose(got["feed_mean"], got["ref_mean"],
                                       rtol=RTOL)
            np.testing.assert_allclose(got["feed_mean_rank"],
                                       got["ref_mean_rank"], rtol=RTOL)
            assert int(got["feed_wall_local"]) == 8 // n
            np.testing.assert_array_equal(got["feed_wall_n"],
                                          np.asarray(jb.wall_n))
            same_times(got["feed_own_times"], jb.own_times)
            np.testing.assert_allclose(
                got["feed_top"], np.asarray(jb.metrics.time_in_top_k),
                rtol=METRIC_RTOL)


def test_sharded_over_data_axis_bit_identical(worlds):
    cfg, wall, ctrl = star_poisson(J, n_feeds=8, T=25.0)
    wb, cb = jbroadcast(wall, ctrl, 8)
    jr_ = jstar_batch(cfg, wb, cb, np.arange(8),
                                mesh=jcomm.make_mesh({"data": 8}))
    for n in (2, 4):
        for got in worlds[n]["star"]:
            assert "({'data': %d}, None)" % n in str(got["batch_layouts"])
            np.testing.assert_array_equal(got["batch0_own"],
                                          got["batch_ref_own"])
            np.testing.assert_array_equal(got["batch0_top"],
                                          got["batch_ref_top"])
            np.testing.assert_array_equal(got["batch0_posts"],
                                          np.asarray(jr_.n_posts))
            same_times(got["batch0_own"], jr_.own_times)
            np.testing.assert_allclose(
                got["batch0_top"], np.asarray(jr_.metrics.time_in_top_k),
                rtol=METRIC_RTOL)


def test_2d_mesh_layouts_bit_identical(worlds):
    """Lanes over ``"data"`` x feeds over ``"feed"``: every layout equals
    the unsharded batch (posts, ``wall_n`` and per-feed metrics bit for
    bit, the feed means within rtol 1e-6) and the JAX package's
    ``{"data": 2, "feed": 4}``."""
    cfg, wall, ctrl = star_poisson(J, n_feeds=8, T=25.0)
    wb, cb = jbroadcast(wall, ctrl, 8)
    jr_ = jstar_batch(cfg, wb, cb, np.arange(8),
                                mesh=jcomm.make_mesh({"data": 2, "feed": 4}),
                                feed_axis="feed")
    for n in (2, 4):
        for got in worlds[n]["star"]:
            for i in range(1, 1 + len(STAR_2D_SHAPES[n])):
                np.testing.assert_array_equal(got[f"batch{i}_own"],
                                              got["batch_ref_own"])
                np.testing.assert_array_equal(got[f"batch{i}_posts"],
                                              got["batch_ref_posts"])
                np.testing.assert_array_equal(got[f"batch{i}_wall_n"],
                                              got["batch_ref_wall_n"])
                np.testing.assert_array_equal(got[f"batch{i}_top"],
                                              got["batch_ref_top"])
                np.testing.assert_allclose(got[f"batch{i}_mean"],
                                           got["batch_ref_mean"], rtol=RTOL)
                np.testing.assert_array_equal(got[f"batch{i}_wall_n"],
                                              np.asarray(jr_.wall_n))
                np.testing.assert_array_equal(got[f"batch{i}_posts"],
                                              np.asarray(jr_.n_posts))


def test_feed_axis_name_is_enforced(worlds):
    for n in (2, 4):
        for got in worlds[n]["errors"]:
            assert "must be named 'feed'" in str(got["feed_axis_sp"])
            assert "must be named 'feed'" in str(got["axis_f"])


def test_sharded_doubling_rejected(worlds):
    for n in (2, 4):
        for got in worlds[n]["errors"]:
            assert "sharded feed axis" in str(got["doubling"])


def test_process_mesh_rejects_bad_local_axes_in_a_world(worlds):
    for n in (2, 4):
        for got in worlds[n]["errors"]:
            assert "!= 1 devices/process" in str(got["process_mesh_bad"])


def test_jax_side_has_eight_devices():
    assert len(jax.devices()) == 8
