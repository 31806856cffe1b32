"""The port's multi-process layer (``redqueen_tpu_torch.parallel.
multihost``) on the CPU: the cases of ``tests/test_multihost.py``.

A JAX process is a rank of the port (one device a process), so a
process mesh's local axes multiply to 1 and its leading axis counts the
ranks.  The two-process run is ``python -m redqueen_tpu_torch.parallel.
multihost_demo`` in two processes over gloo, held against the JAX
package's same computation on its 8 virtual devices in this process
(``{"dcn": 2, "data": 4}`` and a feed axis of 8).  Tolerances: event
counts, ``srcs``, posts and ``wall_n`` identical; sums of times within
rtol 1e-6 (``tests/torch_parity.py``: an ulp of ``log1p`` now and then),
time-in-top-1 within rtol 1e-5 (``tests/test_torch_star.py``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from redqueen_tpu.config import GraphBuilder, stack_components
from redqueen_tpu.parallel import comm as jcomm
from redqueen_tpu.parallel.bigf import StarBuilder, simulate_star
from redqueen_tpu.parallel.shard import simulate_sharded
from redqueen_tpu.utils.metrics import feed_metrics_batch
from redqueen_tpu_torch.parallel import multihost
from torch_mesh_world import REPO, WORLD_TIMEOUT_S, one_rank, run_world
from torch_parity import partitionable  # noqa: F401  (autouse fixture)


@pytest.fixture
def no_launcher_env(monkeypatch):
    for k in (multihost.ENV_COORD, multihost.ENV_NPROC,
              multihost.ENV_PROC_ID):
        monkeypatch.delenv(k, raising=False)


def test_initialize_is_noop_single_process(no_launcher_env):
    assert multihost.initialize(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    s = multihost.process_summary()
    assert (s["process_index"], s["process_count"], s["backend"]) == \
        (0, 1, None)
    with pytest.raises(ValueError, match="need a coordinator"):
        multihost.initialize(num_processes=2, device="cpu")


def test_process_mesh_single_process_shape(tmp_path):
    with one_rank(tmp_path):
        assert multihost.process_mesh({"data": -1}).shape == \
            {"dcn": 1, "data": 1}
        assert multihost.process_mesh({"feed": 1, "data": -1}).shape == \
            {"dcn": 1, "feed": 1, "data": 1}
        assert multihost.process_summary()["backend"] == "gloo"


def test_process_mesh_rejects_bad_local_axes(tmp_path):
    with one_rank(tmp_path):
        with pytest.raises(ValueError, match="devices/process"):
            multihost.process_mesh({"data": 3})
        with pytest.raises(ValueError, match="devices/process"):
            multihost.process_mesh({"feed": 2, "data": -1})


def test_gather_global_single_process_is_asarray():
    out = multihost.gather_global({"x": torch.arange(4)})
    np.testing.assert_array_equal(out["x"], np.arange(4))
    assert isinstance(out["x"], np.ndarray)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, ("gather_rule",), tmp_path_factory.mktemp("w2"))


class TestGatherGlobalReplicatedLeaves:
    """The per-leaf rule across two real ranks: only leaves marked as
    sharded are all-gathered; a replicated numpy leaf and a plain tensor
    riding in the same tree pass through with their own shapes."""

    def test_replicated_numpy_leaf_passes_through_unchanged(self, world2):
        for got in world2["gather_rule"]:
            np.testing.assert_array_equal(got["own_times"], [1.0, 2.0, 3.0])
            assert got["own_times"].shape == (3,)
            np.testing.assert_array_equal(got["dev"], np.arange(5))

    def test_process_sharded_leaf_is_allgathered_tiled(self, world2):
        for r, got in enumerate(world2["gather_rule"]):
            np.testing.assert_array_equal(got["sharded_local"],
                                          np.arange(4 * r, 4 * r + 4))
            np.testing.assert_array_equal(got["sharded"], np.arange(8))
            assert str(got["process_mesh"]) == "{'dcn': 2, 'data': 1}"
            assert str(got["process_mesh2"]) == \
                "{'dcn': 2, 'feed': 1, 'data': 1}"


def _reference_summary():
    """The demo's computation with the JAX package on this process's 8
    virtual devices, ``{"dcn": 2, "data": 4}`` and a feed axis of 8."""
    n, T, q = 4, 60.0, 1.0
    gb = GraphBuilder(n_sinks=n, end_time=T)
    opt = gb.add_opt(q=q)
    for i in range(n):
        gb.add_poisson(rate=1.0, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=1024)
    B = 16
    params, adj = stack_components([p0] * B, [a0] * B)
    mesh = jcomm.make_mesh({"dcn": 2, "data": 4})
    log = simulate_sharded(cfg, params, adj, np.arange(B), mesh,
                           axis=("dcn", "data"))
    adj_b = np.broadcast_to(np.asarray(a0), (B,) + np.asarray(a0).shape)
    with mesh:
        top1 = np.asarray(feed_metrics_batch(
            log.times, log.srcs, adj_b, opt, T).mean_time_in_top_k())
    sb = StarBuilder(n_feeds=8, end_time=T)
    for f in range(8):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_opt(q=q)
    scfg, swall, sctrl = sb.build(wall_cap=256, post_cap=512)
    star = simulate_star(scfg, swall, sctrl, seed=3,
                         mesh=jcomm.make_mesh({"feed": 8}), axis="feed")
    own = np.asarray(star.own_times, np.float64)
    t64 = np.asarray(log.times, np.float64)
    return {
        "times_sum": float(t64[np.isfinite(t64)].sum()),
        "srcs_sum": int(np.asarray(log.srcs, np.int64).sum()),
        "top1_mean": float(top1.mean()),
        "times_shape": list(np.asarray(log.times).shape),
        "star_n_posts": int(star.n_posts),
        "star_own_sum": float(own[np.isfinite(own)].sum()),
        "star_wall_n": [int(x) for x in np.asarray(star.wall_n)],
        "star_top1": [float(x)
                      for x in np.asarray(star.metrics.time_in_top_k)],
        "star_own_shape": list(np.asarray(star.own_times).shape),
    }


def _demo(tmp_path, n, env_launch=False):
    """``n`` demo processes over a file rendezvous; rank 0's summary."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    out = tmp_path / "rank0.json"
    init = f"file://{tmp_path}/pg"
    procs = []
    for i in range(n):
        env = dict(os.environ)
        cmd = [sys.executable, "-m", "redqueen_tpu_torch.parallel."
               "multihost_demo", "--out", str(out), "--device", "cpu"]
        if env_launch:
            env.update({multihost.ENV_COORD: init,
                        multihost.ENV_NPROC: str(n),
                        multihost.ENV_PROC_ID: str(i)})
        else:
            cmd += ["--coordinator", init, "--num-procs", str(n),
                    "--proc-id", str(i)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=WORLD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{o[-4000:]}"
    return json.loads(out.read_text())


def test_two_process_run_matches_single_process(tmp_path):
    """Two real processes (the RQ_* launcher environment) reproduce the
    single-process JAX run on the same global shapes, the star engine's
    feed axis across the process boundary included."""
    got = _demo(tmp_path, 2, env_launch=True)
    assert got["process_count"] == 2 and got["global_devices"] == 2
    assert got["local_devices"] == 1 and got["backend"] == "gloo"
    assert got["platform"] == "cpu"
    assert got["mesh_shape"] == {"dcn": 2, "data": 1}
    want = _reference_summary()
    assert got["times_shape"] == want["times_shape"]
    assert got["srcs_sum"] == want["srcs_sum"], (got, want)
    assert got["times_sum"] == pytest.approx(want["times_sum"], rel=1e-6)
    assert got["top1_mean"] == pytest.approx(want["top1_mean"], rel=1e-5)
    assert got["star_n_posts"] == want["star_n_posts"], (got, want)
    assert got["star_own_sum"] == pytest.approx(want["star_own_sum"],
                                                rel=1e-6)
    assert got["star_wall_n"] == want["star_wall_n"], (got, want)
    np.testing.assert_allclose(got["star_top1"], want["star_top1"],
                               rtol=1e-5, atol=1e-5)
    # The replicated leaf keeps its shape (not doubled by the gather).
    assert got["star_own_shape"] == want["star_own_shape"]


def test_one_process_demo_equals_two(tmp_path):
    """The demo in a world of one rank and in a world of two: the same
    summary bit for bit but for the topology."""
    one = _demo(tmp_path / "one", 1)
    two = _demo(tmp_path / "two", 2)
    topo = ("process_index", "process_count", "global_devices",
            "mesh_shape")
    assert {k: v for k, v in one.items() if k not in topo} == \
        {k: v for k, v in two.items() if k not in topo}


def test_a_group_that_cannot_form_raises(tmp_path, no_launcher_env):
    """Rank 0 of a world of two whose other rank never comes: the join
    raises within its timeout, and no world of one is left behind."""
    with pytest.raises(RuntimeError):
        multihost.initialize(f"file://{tmp_path}/pg", 2, 0, device="cpu",
                             timeout_s=3)
    assert not torch.distributed.is_initialized()
