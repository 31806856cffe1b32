"""Keyword parity with the JAX package's signatures: a call written for the
reference runs on the port, binding each argument to the same parameter.

Each repaired gap is called with the reference's keywords and positional
order, and ``inspect.signature`` checks that the reference's parameters
come first in the port's, in the same order (the port may add keywords
after them, such as ``device``).  ``dtype`` keywords take float32
(torch's, numpy's or ``jnp.float32``) and refuse any other dtype by
name: the port computes in float32."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu import learn as jlearn
from redqueen_tpu import sim as jsim
from redqueen_tpu.learn import ingest as jingest
from redqueen_tpu.models import rmtpp as jrmtpp
from redqueen_tpu.ops import sampling as jsampling
from redqueen_tpu.ops import scan_core as jscan
from redqueen_tpu.parallel import lanes as jlanes
from redqueen_tpu_torch import learn as tlearn
from redqueen_tpu_torch import sim as tsim
from redqueen_tpu_torch.learn import ingest as tingest
from redqueen_tpu_torch.models import rmtpp as trmtpp
from redqueen_tpu_torch.ops import prng
from redqueen_tpu_torch.ops import sampling as tsampling
from redqueen_tpu_torch.ops import scan_core as tscan
from redqueen_tpu_torch.parallel import lanes as tlanes
import torch_parity as tp
from torch_parity import autotune_cache, partitionable  # noqa: F401,E501  (autouse fixtures)

PAIRS = {
    "GraphBuilder.build": (J.GraphBuilder.build, rt.GraphBuilder.build),
    "sim.init_state": (jsim.init_state, tsim.init_state),
    "scan_core.init_state": (jscan.init_state, tscan.init_state),
    "exponential_delta": (jsampling.exponential_delta,
                          tsampling.exponential_delta),
    "exponential_from_uniform": (jsampling.exponential_from_uniform,
                                 tsampling.exponential_from_uniform),
    "dispatch_slabbed": (jlanes.dispatch_slabbed, tlanes.dispatch_slabbed),
    "simulate_slabbed": (jlanes.simulate_slabbed, tlanes.simulate_slabbed),
    "rmtpp_next_delta": (jsampling.rmtpp_next_delta,
                         tsampling.rmtpp_next_delta),
    "rmtpp.fit": (jrmtpp.fit, trmtpp.fit),
    "ingest.make_stream": (jingest.make_stream, tingest.make_stream),
}
# The learn package's public functions (the port adds ``device`` after
# the reference's parameters where a function runs passes).
PAIRS.update({f"learn.{n}": (getattr(jlearn, n), getattr(tlearn, n))
              for n in ("fit_hawkes", "hawkes_loglik", "holdout_nll",
                        "chunk_events", "from_event_log", "from_traces",
                        "from_journal", "builder_params",
                        "cross_excitation_mass", "add_fit_walls",
                        "control_component", "control_cost",
                        "stationary_rates", "fit_s_sink",
                        "simulate_cross_exciting")})


# The serving layer's public functions and the streaming learner (the
# port adds ``device`` after the reference's parameters).
from redqueen_tpu import serving as jserving  # noqa: E402
from redqueen_tpu.serving import stream as jstream  # noqa: E402
from redqueen_tpu_torch import serving as tserving  # noqa: E402
from redqueen_tpu_torch.serving import stream as tstream  # noqa: E402

PAIRS.update({f"serving.{n}": (getattr(jserving, n), getattr(tserving, n))
              for n in ("recover", "journal_decisions", "init_feed_state",
                        "poison_edge", "state_digest", "make_apply_fn",
                        "make_coalesced_apply_fn", "validate_batch",
                        "synthetic_stream", "write_candidate",
                        "read_candidate", "params_digest")})
PAIRS.update({f"ServingRuntime.{n}": (getattr(jserving.ServingRuntime, n),
                                      getattr(tserving.ServingRuntime, n))
              for n in ("__init__", "submit", "poll", "decide", "snapshot",
                        "install_params", "install_carry", "extract_range",
                        "install_range", "live_params", "gather",
                        "reset_metrics", "write_metrics")})
PAIRS.update({
    "serving.stream.drive": (jstream.drive, tstream.drive),
    "ParamSwapper.__init__": (jserving.ParamSwapper.__init__,
                              tserving.ParamSwapper.__init__),
    "StreamingEM.__init__": (jlearn.StreamingEM.__init__,
                             tlearn.StreamingEM.__init__),
    "StreamingEM.run_once": (jlearn.StreamingEM.run_once,
                             tlearn.StreamingEM.run_once),
    "learn.run_sidecar": (jlearn.run_sidecar, tlearn.run_sidecar),
})

# The cluster layer: the router, topology, workers, corpus replay and the
# RetryPolicy they back off with (the port adds ``device`` last).
from redqueen_tpu.data import traces as jtraces  # noqa: E402
from redqueen_tpu.runtime import supervisor as jsupervisor  # noqa: E402
from redqueen_tpu.serving import corpus as jcorpus  # noqa: E402
from redqueen_tpu.serving import worker as jworker  # noqa: E402
from redqueen_tpu_torch.data import traces as ttraces  # noqa: E402
from redqueen_tpu_torch.runtime import supervisor as tsupervisor  # noqa: E402,E501
from redqueen_tpu_torch.serving import corpus as tcorpus  # noqa: E402
from redqueen_tpu_torch.serving import worker as tworker  # noqa: E402

PAIRS.update({f"serving.{n}": (getattr(jserving, n), getattr(tserving, n))
              for n in ("partition", "shard_seed", "reshard",
                        "range_digest", "churn_assign", "plan_moves",
                        "read_topology_log")})
PAIRS.update({f"ServingCluster.{n}": (getattr(jserving.ServingCluster, n),
                                      getattr(tserving.ServingCluster, n))
              for n in ("__init__", "recover", "submit", "submit_many",
                        "poll", "decide", "kill_shard", "recover_shard",
                        "partition_shard", "adopt_external_worker",
                        "remote_worker_commands", "begin_reshard",
                        "resume_migration", "add_edges", "drop_edges",
                        "shard_digests", "cluster_digest", "edge_digest",
                        "snapshot_all", "write_metrics", "durability",
                        "reset_metrics", "close")})
PAIRS.update({f"worker.{c}.{n}": (getattr(getattr(jworker, c), n),
                                  getattr(getattr(tworker, c), n))
              for c, n in (("WorkerHandle", "spawn"),
                           ("SocketWorkerHandle", "worker_argv"),
                           ("SocketWorkerHandle", "remote_command"),
                           ("SocketWorkerHandle", "launch"),
                           ("SocketWorkerHandle", "from_child"),
                           ("SocketWorkerHandle", "spawn_socket"),
                           ("SocketWorkerHandle", "await_external"))})
PAIRS.update({
    "worker.main": (jworker.main, tworker.main),
    "serving.stream.cluster_final_payload": (jstream.cluster_final_payload,
                                             tstream.cluster_final_payload),
    "corpus.merge_traces": (jcorpus.merge_traces, tcorpus.merge_traces),
    "corpus.corpus_batches": (jcorpus.corpus_batches,
                              tcorpus.corpus_batches),
    "corpus.serve_corpus": (jcorpus.serve_corpus, tcorpus.serve_corpus),
    "corpus.main": (jcorpus.main, tcorpus.main),
    "traces.load_csv": (jtraces.load_csv, ttraces.load_csv),
    "traces.save_csv": (jtraces.save_csv, ttraces.save_csv),
    "RetryPolicy.__init__": (jsupervisor.RetryPolicy.__init__,
                             tsupervisor.RetryPolicy.__init__),
    "RetryPolicy.delay": (jsupervisor.RetryPolicy.delay,
                          tsupervisor.RetryPolicy.delay),
})
# The runtime and experiments slice: engine choice, sweeps, the
# supervisor and watchdog, the rest of the traces layer, and each
# experiment's ``run`` (the port adds its keywords, ``device`` last).
import os as _os  # noqa: E402
import sys as _sys  # noqa: E402

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))
from experiments import closed_loop as jx_closed_loop  # noqa: E402
from experiments import compare_policies as jx_compare  # noqa: E402
from experiments import live_swap as jx_live_swap  # noqa: E402
from experiments import rank_timeline as jx_rank  # noqa: E402
from experiments import tradeoff as jx_tradeoff  # noqa: E402
from redqueen_tpu import sweep as jsweep  # noqa: E402
from redqueen_tpu.runtime import watchdog as jwatchdog  # noqa: E402
from redqueen_tpu_torch import sweep as tsweep  # noqa: E402
from redqueen_tpu_torch.experiments import (  # noqa: E402
    closed_loop as tx_closed_loop, compare_policies as tx_compare,
    live_swap as tx_live_swap, rank_timeline as tx_rank,
    tradeoff as tx_tradeoff)
from redqueen_tpu_torch.runtime import watchdog as twatchdog  # noqa: E402

PAIRS.update({
    "sim.select_engine": (jsim.select_engine, tsim.select_engine),
    "sweep.run_sweep": (jsweep.run_sweep, tsweep.run_sweep),
    "sweep.run_sweep_star": (jsweep.run_sweep_star, tsweep.run_sweep_star),
    "sweep.run_sweep_checkpointed": (jsweep.run_sweep_checkpointed,
                                     tsweep.run_sweep_checkpointed),
    "Supervisor.__init__": (jsupervisor.Supervisor.__init__,
                            tsupervisor.Supervisor.__init__),
    "Supervisor.run": (jsupervisor.Supervisor.run,
                       tsupervisor.Supervisor.run),
    "run_resilient": (jsupervisor.run_resilient, tsupervisor.run_resilient),
    "supervised_run": (jsupervisor.supervised_run,
                       tsupervisor.supervised_run),
    "Watchdog.__init__": (jwatchdog.Watchdog.__init__,
                          twatchdog.Watchdog.__init__),
    "Lease.__init__": (jwatchdog.Lease.__init__, twatchdog.Lease.__init__),
    "experiments.tradeoff.run": (jx_tradeoff.run, tx_tradeoff.run),
    "experiments.compare_policies.run": (jx_compare.run, tx_compare.run),
    "experiments.rank_timeline.run": (jx_rank.run, tx_rank.run),
    "experiments.rank_timeline.rank_steps": (jx_rank.rank_steps,
                                             tx_rank.rank_steps),
    "experiments.closed_loop.run": (jx_closed_loop.run, tx_closed_loop.run),
    "experiments.live_swap.run": (jx_live_swap.run, tx_live_swap.run),
})
PAIRS.update({f"traces.{n}": (getattr(jtraces, n), getattr(ttraces, n))
              for n in ("save_npz", "load_npz", "normalize_traces",
                        "bucket_traces", "replay_buckets")})

# Where the port adds a parameter to a cluster entry point, it is
# ``device``, and it comes last.
_DEVICE_LAST = ("ServingCluster.__init__", "ServingCluster.recover",
                "serving.reshard", "corpus.serve_corpus",
                "worker.WorkerHandle.spawn",
                "worker.SocketWorkerHandle.worker_argv",
                "worker.SocketWorkerHandle.remote_command",
                "worker.SocketWorkerHandle.launch",
                "worker.SocketWorkerHandle.spawn_socket")


@pytest.mark.parametrize("name", _DEVICE_LAST)
def test_cluster_entry_points_add_device_last(name):
    jfn, tfn = PAIRS[name]
    jp = list(inspect.signature(jfn).parameters)
    tpar = list(inspect.signature(tfn).parameters)
    assert tpar == jp + ["device"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reference_parameters_lead_in_the_same_order(name):
    jfn, tfn = PAIRS[name]
    jp = list(inspect.signature(jfn).parameters.values())
    tpar = list(inspect.signature(tfn).parameters.values())
    assert [p.name for p in tpar[:len(jp)]] == [p.name for p in jp]
    for a, b in zip(jp, tpar):
        assert a.kind == b.kind, (name, a.name)


def _fill(gb):
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_poisson(rate=0.5, sinks=[1])


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, jnp.float32,
                                   "float32"], ids=str)
def test_build_takes_the_reference_positional_order(dtype):
    """``build(capacity, dtype, rmtpp_hidden)``: a positional float32 lands
    in ``dtype``, not in ``rmtpp_hidden``."""
    gbj = J.GraphBuilder(n_sinks=2, end_time=5.0)
    gbt = rt.GraphBuilder(n_sinks=2, end_time=5.0)
    _fill(gbj)
    _fill(gbt)
    cj, pj, aj = gbj.build(64, jnp.float32, 3)
    ct, pt, at = gbt.build(64, dtype, 3, "cpu")
    assert ct == rt.sim_config_from_fields(
        {f: getattr(cj, f) for f in cj.__dataclass_fields__})
    assert ct.capacity == 64 and ct.rmtpp_hidden == 3
    assert pt.rate.dtype == torch.float32
    np.testing.assert_array_equal(pt.rate.numpy(), np.asarray(pj.rate))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, jnp.bfloat16,
                                   torch.int32, "float16"], ids=str)
def test_every_dtype_keyword_refuses_other_dtypes_by_name(dtype):
    gb = rt.GraphBuilder(n_sinks=2, end_time=5.0)
    _fill(gb)
    with pytest.raises(TypeError, match="GraphBuilder.build: dtype=.*float32"):
        gb.build(64, dtype, device="cpu")
    cfg, p, a = gb.build(64, device="cpu")
    pb, ab = rt.stack_components([p], [a])
    key = prng.PRNGKey(torch.tensor([0]))
    with pytest.raises(TypeError, match="init_state"):
        tsim.init_state(cfg, pb, ab, key, dtype)
    with pytest.raises(TypeError, match="exponential_delta"):
        tsampling.exponential_delta(key, torch.ones(1), dtype)
    with pytest.raises(TypeError, match="exponential_from_uniform"):
        tsampling.exponential_from_uniform(torch.full((1,), 0.3),
                                           torch.ones(1), dtype)


def test_init_state_with_dtype_equals_the_reference_first_draws():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.every_kind, 5, 20.0, 32, 3)
    import jax
    from jax import random as jr

    keys_j = jax.vmap(jr.PRNGKey)(np.arange(3))
    sj = jax.vmap(lambda p, a, k: jscan.init_state(cj, p, a, k,
                                                   dtype=jnp.float32))(
        pj, aj, keys_j)
    st = tscan.init_state(ct, pt, at, prng.PRNGKey(torch.arange(3)),
                          dtype=jnp.float32)
    np.testing.assert_allclose(st.t_next.numpy(), np.asarray(sj.t_next),
                               rtol=1e-6)


def test_samplers_take_dtype_like_the_reference():
    import jax
    from jax import random as jr

    keys_j = jr.split(jr.PRNGKey(2), 50)
    rate = np.linspace(0.0, 3.0, 50).astype(np.float32)
    want = jax.vmap(lambda k, r: jsampling.exponential_delta(
        k, r, jnp.float32))(keys_j, rate)
    got = tsampling.exponential_delta(prng.split(prng.PRNGKey(2), 50),
                                      torch.from_numpy(rate), jnp.float32)
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin],
                               rtol=1e-6)
    u = np.linspace(0.0, 0.999, 50).astype(np.float32)
    np.testing.assert_allclose(
        tsampling.exponential_from_uniform(torch.from_numpy(u),
                                           torch.from_numpy(rate),
                                           dtype=np.float32).numpy()[1:],
        np.asarray(jsampling.exponential_from_uniform(
            u, rate, dtype=jnp.float32))[1:], rtol=1e-6)


@pytest.mark.parametrize("fn", ["dispatch_slabbed", "simulate_slabbed"])
def test_dispatch_hook_replaces_the_per_slab_dispatch(fn):
    """The ``dispatch=`` hook gets each slab's ``(cfg, params, adj,
    seeds)``, as the reference's does, and its logs are the slabs'."""
    _, (ct, pt, at) = tp.build_both(tp.golden, 4, 5.0, 16, 5)
    calls = []

    def dispatch(c, p, a, s):
        calls.append((p.kind.shape[0], a.shape[0], list(s)))
        return rt.simulate_batch(c, p, a, s, device="cpu")

    out = getattr(tlanes, fn)(ct, pt, at, np.arange(5), 2,
                              dispatch=dispatch, device="cpu")
    assert calls == [(2, 2, [0, 1]), (2, 2, [2, 3]), (1, 1, [4])]
    whole = rt.simulate_batch(ct, pt, at, np.arange(5), device="cpu")
    if fn == "dispatch_slabbed":
        assert len(out) == 3
        out = tlanes.concat_slab_logs(ct, out)
    w = out.srcs.shape[1]
    assert torch.equal(out.srcs, whole.srcs[:, :w])
    assert bool((whole.srcs[:, w:] == -1).all())


def test_experiment_runs_add_device_last():
    for name in ("experiments.tradeoff.run", "experiments.compare_policies.run",
                 "experiments.rank_timeline.run",
                 "experiments.closed_loop.run", "experiments.live_swap.run",
                 "traces.replay_buckets"):
        assert list(inspect.signature(PAIRS[name][1]).parameters)[-1] == \
            "device", name


def _fused_component():
    gb = rt.GraphBuilder(n_sinks=3, end_time=6.0)
    gb.add_opt(q=1.0)
    for i in range(3):
        gb.add_poisson(rate=1.0, sinks=[i])
    cfg, p, a = gb.build(capacity=32, device="cpu")
    return (cfg, *rt.stack_components([p] * 4, [a] * 4))


def test_engine_pallas_is_the_fused_engine():
    """The JAX package's name of the fused engine runs it: the same
    EventLog as ``engine="fused"`` (its plain version on the CPU)."""
    cfg, P, A = _fused_component()
    a = rt.simulate_batch(cfg, P, A, np.arange(4), engine="pallas",
                          device="cpu")
    b = rt.simulate_batch(cfg, P, A, np.arange(4), engine="fused",
                          device="cpu")
    assert a.engine == b.engine == "plain"
    for f in ("times", "srcs", "n_events", "health"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.dispatches == b.dispatches
    with pytest.raises(ValueError, match="engine='pallas' requested"):
        rt.simulate_batch(cfg, P, A, np.arange(4), engine="pallas",
                          max_events=3, device="cpu")


@pytest.mark.parametrize("platform,want", [("cuda", "fused"),
                                           ("cpu", "scan"), ("tpu", "scan")])
def test_select_engine_takes_platform(platform, want):
    cfg, P, _ = _fused_component()
    got, reason = rt.select_engine(cfg, P, engine="auto", platform=platform,
                                   device="cpu")
    assert got == want and (reason is None) == (want == "fused")
    assert rt.select_engine(cfg, P, engine="pallas",
                            platform=platform) == ("fused", None)


def test_sweep_axis_binds_in_the_reference_position():
    """``run_sweep(points, n, src, K, seed0, mesh, axis, max_chunks,
    engine)``: a positional ``max_chunks`` lands in ``max_chunks``."""
    gb = rt.GraphBuilder(n_sinks=2, end_time=30.0)
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_poisson(rate=1.0, sinks=[1])
    pts = [gb.build(capacity=8, device="cpu")]
    with pytest.raises(RuntimeError, match="still active after 1 chunks"):
        tsweep.run_sweep(pts, 1, 0, 1, 0, None, "data", 1, "scan",
                         device="cpu")
    ok = tsweep.run_sweep(pts, 1, 0, 1, 0, None, "data", 100, "pallas",
                          device="cpu")
    assert ok.n_posts.shape == (1, 1)
    sb = rt.StarBuilder(n_feeds=2, end_time=5.0)
    sb.wall_poisson(0, 1.0)
    sb.wall_poisson(1, 1.0)
    sb.ctrl_opt(q=1.0)
    star = [sb.build(wall_cap=32, post_cap=64, device="cpu")]
    got = tsweep.run_sweep_star(star, 2, 1, 0, None, "data", None,
                                "doubling", device="cpu")
    assert got.n_posts.shape == (1, 2)


# The mesh layer: collectives, placement, sharded runs and the run across
# processes (the port adds its keywords, such as ``device``, last).
from redqueen_tpu import presets as jpresets  # noqa: E402
from redqueen_tpu.parallel import bigf as jbigf  # noqa: E402
from redqueen_tpu.parallel import comm as jcomm  # noqa: E402
from redqueen_tpu.parallel import multihost as jmultihost  # noqa: E402
from redqueen_tpu.parallel import shard as jshard  # noqa: E402
from redqueen_tpu_torch import presets as tpresets  # noqa: E402
from redqueen_tpu_torch.parallel import bigf as tbigf  # noqa: E402
from redqueen_tpu_torch.parallel import comm as tcomm  # noqa: E402
from redqueen_tpu_torch.parallel import multihost as tmultihost  # noqa: E402,E501
from redqueen_tpu_torch.parallel import shard as tshard  # noqa: E402

PAIRS.update({f"comm.{n}": (getattr(jcomm, n), getattr(tcomm, n))
              for n in jcomm.__all__})
PAIRS.update({f"multihost.{n}": (getattr(jmultihost, n),
                                 getattr(tmultihost, n))
              for n in jmultihost.__all__})
PAIRS.update({
    "shard.simulate_sharded": (jshard.simulate_sharded,
                               tshard.simulate_sharded),
    "bigf.simulate_star": (jbigf.simulate_star, tbigf.simulate_star),
    "bigf.simulate_star_batch": (jbigf.simulate_star_batch,
                                 tbigf.simulate_star_batch),
    "presets.run_preset": (jpresets.run_preset, tpresets.run_preset),
})


def _star(F=4):
    sb = rt.StarBuilder(n_feeds=F, end_time=20.0)
    for f in range(F):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_opt(q=1.0)
    return sb.build(wall_cap=64, post_cap=256, device="cpu")


def test_star_axis_binds_in_the_reference_position():
    """``simulate_star(cfg, wall, ctrl, seed, mesh, axis, metric_K,
    fire_mode)``: a positional ``metric_K`` after ``axis`` lands in
    ``metric_K``, a positional ``fire_mode`` in ``fire_mode``."""
    cfg, wall, ctrl = _star()
    pos = tbigf.simulate_star(cfg, wall, ctrl, 3, None, "feed", 2, "loop",
                              device="cpu")
    kw = tbigf.simulate_star(cfg, wall, ctrl, 3, metric_K=2,
                             fire_mode="loop", device="cpu")
    k1 = tbigf.simulate_star(cfg, wall, ctrl, 3, device="cpu")
    np.testing.assert_array_equal(pos.metrics.time_in_top_k.numpy(),
                                  kw.metrics.time_in_top_k.numpy())
    assert not torch.equal(pos.metrics.time_in_top_k,
                           k1.metrics.time_in_top_k)
    with pytest.raises(ValueError, match="unknown fire_mode"):
        tbigf.simulate_star(cfg, wall, ctrl, 3, None, "feed", 1, "nope",
                            device="cpu")


def test_star_batch_axes_bind_in_the_reference_position():
    """``simulate_star_batch(cfg, wall, ctrl, seeds, mesh, axis,
    feed_axis, metric_K, fire_mode)``, and a follower axis not named
    ``"feed"`` refused as the reference refuses it."""
    cfg, wall, ctrl = _star()
    wb, cb = tbigf.broadcast_star(wall, ctrl, 2)
    pos = tbigf.simulate_star_batch(cfg, wb, cb, np.arange(2), None, "data",
                                    None, 2, "doubling", device="cpu")
    kw = tbigf.simulate_star_batch(cfg, wb, cb, np.arange(2), metric_K=2,
                                   fire_mode="doubling", device="cpu")
    np.testing.assert_array_equal(pos.metrics.time_in_top_k.numpy(),
                                  kw.metrics.time_in_top_k.numpy())
    with pytest.raises(ValueError, match="must be named 'feed'"):
        tbigf.simulate_star_batch(cfg, wb, cb, np.arange(2),
                                  feed_axis="sp", device="cpu")
