"""The port's star engine (``redqueen_tpu_torch/ops/streams.py`` and
``parallel/star_*.py``) against the JAX package's on the CPU, at the same
seeds, with ``jax_threefry_partitionable`` pinned to True.

Tolerances: stream counts, truncation flags and post counts identical;
event and fire times within rtol 1e-6 (torch's and XLA's CPU ``log1p``
differ by an ulp now and then, and so do the two ``cumsum`` orders); the
per-feed metrics within rtol 1e-5 (a sum over up to a thousand events in
another order).  The port against itself (fire modes, compressed against
uncompressed, the batch against its lanes) bit for bit."""

import jax
import numpy as np
import pytest
import torch
from jax import random as jr

from redqueen_tpu.ops import streams as jstreams
from redqueen_tpu.parallel import bigf as JB
from redqueen_tpu_torch.ops import prng
from redqueen_tpu_torch.ops import streams as tstreams
from redqueen_tpu_torch.parallel import bigf as TB
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

RTOL = 1e-6
METRIC_RTOL = 1e-5


def t32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def tkeys(seed, n):
    """The port's ``jr.split(jr.PRNGKey(seed), n)``."""
    return prng.split(prng.PRNGKey(seed), n)


def same_times(port, ref, rtol=RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=0)


def same_stream(ts, js):
    same_times(ts.times, js.times)
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(ts.truncated.numpy(),
                                  np.asarray(js.truncated))


# ---------------------------------------------------------------------------
# Streams of every kind, and their truncation flags
# ---------------------------------------------------------------------------

N = 12


@pytest.mark.parametrize("rate,cap", [(1.5, 64), (0.0, 16), (4.0, 16)],
                         ids=["fits", "rate0", "truncated"])
def test_poisson_stream(rate, cap):
    rates = np.full(N, rate, np.float32)
    rates[::3] *= 0.5
    js = jax.vmap(lambda k, r: jstreams.poisson_stream(k, r, 1.0, 9.0, cap))(
        jr.split(jr.PRNGKey(4), N), rates)
    ts = tstreams.poisson_stream(tkeys(4, N), t32(rates), 1.0, 9.0, cap)
    same_stream(ts, js)
    if cap == 16 and rate == 4.0:
        assert ts.truncated.any() and not ts.truncated.all()


@pytest.mark.parametrize("cap", [64, 8], ids=["fits", "truncated"])
def test_hawkes_stream(cap):
    l0 = np.linspace(0.3, 1.0, N).astype(np.float32)
    js = jax.vmap(lambda k, a: jstreams.hawkes_stream(
        k, a, 0.8, 2.0, 0.0, 20.0, cap))(jr.split(jr.PRNGKey(5), N), l0)
    ts = tstreams.hawkes_stream(tkeys(5, N), t32(l0), 0.8, 2.0, 0.0, 20.0,
                                cap)
    same_stream(ts, js)
    assert bool(ts.truncated.any()) == (cap == 8)


@pytest.mark.parametrize("cap", [64, 8], ids=["fits", "truncated"])
def test_piecewise_stream(cap):
    ct = np.array([0.0, 5.0, 9.0], np.float32)
    rr = np.array([1.0, 0.0, 2.5], np.float32)
    js = jax.vmap(lambda k: jstreams.piecewise_stream(
        k, ct, rr, 0.5, 15.0, cap))(jr.split(jr.PRNGKey(6), N))
    ts = tstreams.piecewise_stream(tkeys(6, N), t32(ct).expand(N, 3),
                                   t32(rr).expand(N, 3), 0.5, 15.0, cap)
    same_stream(ts, js)
    assert bool(ts.truncated.any()) == (cap == 8)


def test_realdata_stream_clips_and_sorts():
    rows = np.array([[5.0, 1.0, 30.0, 12.0, np.inf],
                     [2.0, 2.0, 3.0, np.inf, np.inf]], np.float32)
    js = jax.vmap(lambda r: jstreams.realdata_stream(r, 2.0, 20.0))(rows)
    ts = tstreams.realdata_stream(t32(rows), 2.0, 20.0)
    same_stream(ts, js)


def test_rmtpp_stream_names_its_item():
    """The RMTPP stream is ported (ROADMAP Queue 1 item 5; its parity
    with the JAX stream is in ``test_torch_rmtpp.py``): a batch of streams
    is each stream on its own, and a star controller without weights is
    refused by name."""
    from redqueen_tpu_torch.models import rmtpp

    w = rmtpp.init_weights(2, hidden=4, device="cpu")
    keys = tkeys(0, 3)
    whole = tstreams.rmtpp_stream(w, keys, 0.0, 8.0, 16, 4)
    for i in range(3):
        one = tstreams.rmtpp_stream(w, keys[i], 0.0, 8.0, 16, 4)
        assert torch.equal(one.times, whole.times[i])
        assert int(one.n) == int(whole.n[i])
    sb = TB.StarBuilder(n_feeds=2, end_time=5.0)
    sb.wall_poisson(0, 1.0)
    sb.wall_poisson(1, 1.0)
    sb.ctrl_rmtpp(None, hidden=4)
    with pytest.raises(ValueError, match="rmtpp weights"):
        TB.simulate_star(*sb.build(device="cpu"), seed=0, device="cpu")


# ---------------------------------------------------------------------------
# The fires: both modes, with and without compression
# ---------------------------------------------------------------------------


def _fires_inputs(F=6, E=128, rate=2.0, T=40.0, seed=3):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.exponential(1.0 / rate, (F, E)).cumsum(axis=1),
                    axis=1).astype(np.float32)
    times[times > T] = np.inf
    return times


FIRE_CASES = {
    # name: (F, E, T, post_cap, rate_f)
    "normal": (6, 128, 40.0, 256, 0.5),
    "small_E": (4, 32, 40.0, 128, 0.5),
    "truncated": (6, 128, 40.0, 8, 50.0),
    "absorbing": (6, 128, 0.5, 256, 0.01),
}


@pytest.mark.parametrize("case", sorted(FIRE_CASES))
@pytest.mark.parametrize("compress", [True, False])
def test_opt_fires_both_modes(case, compress):
    F, E, T, post_cap, rf = FIRE_CASES[case]
    times = _fires_inputs(F=F, E=E, T=T)
    jcfg = JB.StarConfig(n_feeds=F, walls_per_feed=1, end_time=T,
                         wall_cap=E, post_cap=post_cap)
    tcfg = TB.StarConfig(n_feeds=F, walls_per_feed=1, end_time=T,
                         wall_cap=E, post_cap=post_cap)
    rate_f = np.full(F, rf, np.float32)
    own_j, tr_j, rec_j = JB._opt_fires(
        jcfg, times, rate_f, jr.PRNGKey(4), np.zeros((), np.int32),
        compress=compress, fire_mode="loop")
    out = {mode: TB._opt_fires(tcfg, t32(times)[None], t32(rate_f)[None],
                               prng.PRNGKey(torch.tensor([4])), 0,
                               compress=compress, fire_mode=mode)
           for mode in ("loop", "doubling")}
    for own, tr, rec in out.values():
        same_times(own[0], own_j)
        assert bool(tr[0]) == bool(tr_j) and bool(rec[0]) == bool(rec_j)
    # the two modes bit for bit
    assert torch.equal(out["loop"][0], out["doubling"][0])
    assert torch.equal(out["loop"][1], out["doubling"][1])
    if case == "truncated":
        assert bool(out["loop"][1][0])
    if case == "absorbing":
        assert not bool(out["doubling"][1][0])


def test_compressed_equals_uncompressed_bitwise():
    times = t32(_fires_inputs())[None].repeat(3, 1, 1)
    cfg = TB.StarConfig(n_feeds=6, walls_per_feed=1, end_time=40.0,
                        wall_cap=128, post_cap=256)
    keys = prng.PRNGKey(torch.tensor([4, 5, 6]))
    rate_f = torch.full((3, 6), 0.5)
    c = TB._opt_fires(cfg, times, rate_f, keys, compress=True)
    u = TB._opt_fires(cfg, times, rate_f, keys, compress=False)
    assert torch.equal(c[0], u[0]) and not c[2].any()
    assert (torch.isfinite(c[0]).sum(-1) > 3).all()


def test_ties_in_wall_times_do_not_change_the_fires():
    """Duplicate wall times across and within feeds: the stable sort's
    order inside a tie group differs from XLA's, the fires do not."""
    rng = np.random.default_rng(9)
    grid = np.round(rng.uniform(0, 20, (5, 40)) * 4) / 4   # many ties
    times = np.sort(grid, axis=1).astype(np.float32)
    cfg_j = JB.StarConfig(n_feeds=5, walls_per_feed=1, end_time=20.0,
                          wall_cap=40, post_cap=128)
    cfg_t = TB.StarConfig(n_feeds=5, walls_per_feed=1, end_time=20.0,
                          wall_cap=40, post_cap=128)
    rate_f = np.full(5, 2.0, np.float32)
    own_j = JB._opt_fires(cfg_j, times, rate_f, jr.PRNGKey(2), 0,
                          compress=False, fire_mode="loop")[0]
    for mode in ("loop", "doubling"):
        own_t = TB._opt_fires(cfg_t, t32(times)[None], t32(rate_f)[None],
                              prng.PRNGKey(torch.tensor([2])), 0,
                              compress=False, fire_mode=mode)[0]
        same_times(own_t[0], own_j)
    # and through a whole run: replay walls with duplicate times
    def build(pkg, **kw):
        sb = pkg.StarBuilder(n_feeds=5, end_time=20.0)
        for f in range(5):
            sb.wall_replay(f, grid[f])
        sb.ctrl_opt(q=0.2)
        return sb.build(wall_cap=40, post_cap=256, **kw)

    rj = JB.simulate_star(*build(JB), seed=1)
    rt_ = TB.simulate_star(*build(TB, device="cpu"), seed=1, device="cpu")
    same_times(rt_.own_times, rj.own_times)
    rd = TB.simulate_star(*build(TB, device="cpu"), seed=1, device="cpu",
                          fire_mode="doubling")
    assert torch.equal(rd.own_times, rt_.own_times)


def test_fire_mode_validated_and_auto_resolves_per_device():
    with pytest.raises(ValueError, match="unknown fire_mode"):
        TB._check_fire_mode("fast")
    assert TB._resolve_fire_mode("auto", device="cpu") == "loop"
    assert TB._resolve_fire_mode("auto", device="cuda") == "doubling"
    assert TB._resolve_fire_mode("loop", device="cuda") == "loop"


# ---------------------------------------------------------------------------
# Metrics: the closed form against its scan twin and against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2])
def test_closed_form_metrics_match_scan_twin_and_jax(K):
    rng = np.random.default_rng(K)
    F, E, Kp, T, start = 7, 30, 20, 25.0, 2.0
    walls = np.sort(rng.uniform(0, T + 3, (F, E)), axis=1)
    walls[walls > T] = np.inf
    walls[:, -3:] = np.inf
    own = np.sort(rng.uniform(0, T, Kp))
    own[-4:] = np.inf
    walls[0, 5] = own[3]      # an own post at a wall's time
    walls = np.sort(walls, axis=1).astype(np.float32)
    own = own.astype(np.float32)
    cfg = TB.StarConfig(n_feeds=F, walls_per_feed=1, end_time=T,
                        start_time=start, wall_cap=E, post_cap=Kp)
    jcfg = JB.StarConfig(n_feeds=F, walls_per_feed=1, end_time=T,
                         start_time=start, wall_cap=E, post_cap=Kp)
    closed = TB._feed_metrics_star(cfg, t32(walls)[None], t32(own)[None], K)
    scan = TB._feed_metrics_star_scan(cfg, t32(walls)[None], t32(own)[None],
                                      K)
    jm = JB._feed_metrics_star(jcfg, walls, own, K)
    for f in ("time_in_top_k", "int_rank", "int_rank2"):
        np.testing.assert_allclose(getattr(closed, f)[0].numpy(),
                                   getattr(scan, f)[0].numpy(),
                                   rtol=METRIC_RTOL, atol=1e-4)
        np.testing.assert_allclose(getattr(closed, f)[0].numpy(),
                                   np.asarray(getattr(jm, f)),
                                   rtol=METRIC_RTOL, atol=1e-5)


def test_metric_feed_blocks_are_exact(monkeypatch):
    from redqueen_tpu_torch.parallel import star_metrics

    rng = np.random.default_rng(0)
    walls = t32(np.sort(rng.uniform(0, 10, (2, 9, 12)), axis=-1))
    own = t32(np.sort(rng.uniform(0, 10, (2, 6)), axis=-1))
    cfg = TB.StarConfig(n_feeds=9, walls_per_feed=1, end_time=10.0)
    whole = star_metrics._feed_metrics_star(cfg, walls, own, 1)
    monkeypatch.setattr(star_metrics, "_METRIC_FEED_BLOCK", 4)
    blocked = star_metrics._feed_metrics_star(cfg, walls, own, 1)
    for a, b in zip(whole[:3], blocked[:3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# simulate_star / simulate_star_batch against the JAX engine
# ---------------------------------------------------------------------------


def build(pkg, F=10, T=25.0, walls="poisson", ctrl="opt", s_sink=None,
          wall_cap=128, post_cap=512, **kw):
    rng = np.random.RandomState(0)
    sb = pkg.StarBuilder(n_feeds=F, end_time=T, s_sink=s_sink)
    for f in range(F):
        if walls in ("poisson", "mix"):
            sb.wall_poisson(f, 1.0 + 0.1 * f)
        if walls == "hawkes" or (walls == "mix" and f % 2):
            sb.wall_hawkes(f, 0.5, 0.8, 2.0)
        if walls == "mix" and f % 3 == 0:
            sb.wall_piecewise(f, [0.0, 10.0], [1.0, 0.4])
        if walls == "replay" or (walls == "mix" and f % 4 == 1):
            sb.wall_replay(f, np.sort(rng.uniform(0, T, 9)))
    if ctrl == "opt":
        sb.ctrl_opt(q=0.5)
    elif ctrl == "poisson":
        sb.ctrl_poisson(2.0)
    elif ctrl == "hawkes":
        sb.ctrl_hawkes(0.5, 0.3, 1.0)
    elif ctrl == "replay":
        sb.ctrl_replay(np.sort(rng.uniform(0, T, 40)))
    elif ctrl == "piecewise":
        sb.ctrl_piecewise([0.0, 10.0], [1.0, 3.0])
    return sb.build(wall_cap=wall_cap, post_cap=post_cap, **kw)


def same_result(rt_, rj):
    same_times(rt_.own_times, rj.own_times)
    assert rt_.n_posts == int(rj.n_posts)
    same_times(rt_.wall_times, rj.wall_times)
    np.testing.assert_array_equal(rt_.wall_n.numpy(), np.asarray(rj.wall_n))
    for f in ("time_in_top_k", "int_rank", "int_rank2"):
        np.testing.assert_allclose(
            getattr(rt_.metrics, f).numpy(),
            np.asarray(getattr(rj.metrics, f)), rtol=METRIC_RTOL, atol=1e-4)


@pytest.mark.parametrize("walls,ctrl", [
    ("poisson", "opt"), ("hawkes", "opt"), ("mix", "opt"),
    ("replay", "opt"), ("poisson", "poisson"), ("poisson", "hawkes"),
    ("poisson", "replay"), ("poisson", "piecewise")])
def test_simulate_star_matches_jax(walls, ctrl):
    rj = JB.simulate_star(*build(JB, walls=walls, ctrl=ctrl), seed=3)
    rt_ = TB.simulate_star(*build(TB, walls=walls, ctrl=ctrl, device="cpu"),
                           seed=3, device="cpu")
    same_result(rt_, rj)
    if ctrl == "opt":
        rd = TB.simulate_star(*build(TB, walls=walls, ctrl=ctrl,
                                     device="cpu"),
                              seed=3, device="cpu", fire_mode="doubling")
        assert torch.equal(rd.own_times, rt_.own_times)


def test_simulate_star_batch_matches_jax_and_its_lanes():
    seeds = np.array([2, 9, 4])
    jc, jw, jk = build(JB, walls="mix")
    tc, tw, tk = build(TB, walls="mix", device="cpu")
    rj = JB.simulate_star_batch(jc, *JB.broadcast_star(jw, jk, 3), seeds)
    rb = TB.simulate_star_batch(tc, *TB.broadcast_star(tw, tk, 3), seeds,
                                device="cpu")
    same_times(rb.own_times, rj.own_times)
    np.testing.assert_array_equal(rb.n_posts.numpy(), np.asarray(rj.n_posts))
    np.testing.assert_array_equal(rb.wall_n.numpy(), np.asarray(rj.wall_n))
    np.testing.assert_allclose(rb.metrics.mean_time_in_top_k().numpy(),
                               np.asarray(rj.metrics.mean_time_in_top_k()),
                               rtol=METRIC_RTOL)
    for i, s in enumerate(seeds):
        one = TB.simulate_star(tc, tw, tk, seed=int(s), device="cpu")
        assert torch.equal(one.own_times, rb.own_times[i])
        assert torch.equal(one.metrics.time_in_top_k,
                           rb.metrics.time_in_top_k[i])


def test_stack_star_heterogeneous_params_match_jax():
    pts_j = [build(JB, F=6, s_sink=[s] * 6) for s in (0.5, 2.0)]
    pts_t = [build(TB, F=6, s_sink=[s] * 6, device="cpu") for s in (0.5, 2.0)]
    wj, kj = JB.stack_star([p[1] for p in pts_j], [p[2] for p in pts_j])
    wt, kt = TB.stack_star([p[1] for p in pts_t], [p[2] for p in pts_t])
    rj = JB.simulate_star_batch(pts_j[0][0], wj, kj, np.array([1, 1]))
    rt_ = TB.simulate_star_batch(pts_t[0][0], wt, kt, np.array([1, 1]),
                                 device="cpu")
    same_times(rt_.own_times, rj.own_times)
    assert rt_.n_posts[1] > rt_.n_posts[0]


def test_key_array_seeds_and_jax_carried_params():
    """A JAX-built component carried across by ``convert`` runs the same
    stream, and a key-array seed equals its integer seed."""
    import dataclasses

    from redqueen_tpu_torch import convert

    jc, jw, jk = build(JB, walls="mix")
    tc = convert.star_config_from_fields(dataclasses.asdict(jc))
    tw = convert.wall_params_from_numpy(
        {f: np.asarray(getattr(jw, f)) for f in
         TB.WallParams.__dataclass_fields__}, device="cpu")
    tk = convert.ctrl_params_from_numpy(
        {f: (None if getattr(jk, f) is None else np.asarray(getattr(jk, f)))
         for f in ("q", "rate", "pw_times", "pw_rates", "rd_times", "l0",
                   "alpha", "beta")}, device="cpu")
    rj = JB.simulate_star(jc, jw, jk, seed=5)
    same_result(TB.simulate_star(tc, tw, tk, seed=5, device="cpu"), rj)
    key = prng.PRNGKey(torch.tensor(5)).numpy()
    rk = TB.simulate_star(tc, tw, tk, seed=key, device="cpu")
    assert torch.equal(rk.own_times,
                       TB.simulate_star(tc, tw, tk, seed=5,
                                        device="cpu").own_times)


# ---------------------------------------------------------------------------
# The short-clock fallback and the overflow raises
# ---------------------------------------------------------------------------


def _short_clock(pkg, s, **kw):
    sb = pkg.StarBuilder(n_feeds=4, end_time=25.0, s_sink=[s] * 4)
    for f in range(4):
        sb.wall_poisson(f, 5.0)
    sb.ctrl_opt(q=1.0)
    return sb.build(wall_cap=256, post_cap=2048, **kw)


def test_short_clock_fallback_end_to_end():
    TB._COMPRESS_BLOCKLIST.clear()
    cfg, wall, ctrl = _short_clock(TB, 1e6, device="cpu")
    res = TB.simulate_star(cfg, wall, ctrl, seed=11, device="cpu")
    key_short = (cfg, 1, TB._regime_key(ctrl.map(lambda x: x[None]),
                                        wall.map(lambda x: x[None])))
    assert key_short in TB._COMPRESS_BLOCKLIST
    rj = JB.simulate_star(*_short_clock(JB, 1e6), seed=11)
    same_times(res.own_times, rj.own_times)
    assert res.n_posts > 50
    cfg2, wall2, ctrl2 = _short_clock(TB, 1.0, device="cpu")
    TB.simulate_star(cfg2, wall2, ctrl2, seed=11, device="cpu")
    key_long = (cfg2, 1, TB._regime_key(ctrl2, wall2))
    assert key_long != key_short and key_long not in TB._COMPRESS_BLOCKLIST
    # the uncompressed path forced by hand gives the same fires
    with pytest.raises(TB.RecordBudgetOverflow):
        out = TB._get_fn(cfg, 1, True, "loop", torch.device("cpu"))(
            wall.map(lambda x: x[None]), ctrl.map(lambda x: x[None]),
            prng.PRNGKey(torch.tensor([11])))
        TB._check_overflow(cfg, out[5], out[6], out[7])


def test_overflow_raises(tmp_path):
    with pytest.raises(RuntimeError, match="wall stream overflow"):
        TB.simulate_star(*build(TB, wall_cap=8, device="cpu"), seed=0,
                         device="cpu")
    with pytest.raises(RuntimeError, match="posting buffer overflow"):
        TB.simulate_star(*build(TB, post_cap=4, device="cpu"), seed=0,
                         device="cpu")
    tc, tw, tk = build(TB, device="cpu")
    with pytest.raises(ValueError, match="batch dims disagree"):
        TB.simulate_star_batch(tc, *TB.broadcast_star(tw, tk, 2),
                               np.arange(3), device="cpu")
    # A mesh of one rank (the feed axis whole) equals the unsharded run.
    from redqueen_tpu_torch.parallel import comm, multihost
    from torch_mesh_world import one_rank

    with one_rank(tmp_path):
        sh = TB.simulate_star(tc, tw, tk, seed=0,
                              mesh=comm.make_mesh({"feed": 1}), device="cpu")
        got = multihost.gather_global({
            "own_times": sh.own_times, "wall_times": sh.wall_times,
            "wall_n": sh.wall_n, "top": sh.metrics.time_in_top_k})
    ref = TB.simulate_star(tc, tw, tk, seed=0, device="cpu")
    assert sh.n_posts == ref.n_posts
    for k in ("own_times", "wall_times", "wall_n"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy())
    np.testing.assert_array_equal(got["top"],
                                  ref.metrics.time_in_top_k.numpy())


def test_ctrl_replay_longer_than_post_cap_truncates_loudly():
    with pytest.raises(RuntimeError, match="posting buffer overflow"):
        TB.simulate_star(*build(TB, ctrl="replay", post_cap=16,
                                device="cpu"), seed=0, device="cpu")


def test_star_to_dataframe_metrics_match_pandas():
    from redqueen_tpu_torch.utils import metrics_pandas as mp

    cfg, wall, ctrl = build(TB, F=4, T=15.0, device="cpu")
    res = TB.simulate_star(cfg, wall, ctrl, seed=7, device="cpu")
    df = TB.star_to_dataframe(res)
    top = mp.time_in_top_k(df, 1, 15.0, 0)
    np.testing.assert_allclose(top, float(res.metrics.mean_time_in_top_k()),
                               rtol=1e-4)


def test_port_imports_and_runs_with_jax_blocked():
    """In a process where importing jax, flax or the JAX package fails,
    every module of the port imports and a star run goes through."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "redqueen_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import redqueen_tpu_torch as rt
for m in pkgutil.walk_packages(rt.__path__, "redqueen_tpu_torch."):
    importlib.import_module(m.name)
sb = rt.StarBuilder(n_feeds=3, end_time=5.0)
for f in range(3):
    sb.wall_poisson(f, 1.0)
sb.ctrl_opt(q=1.0)
res = rt.simulate_star(*sb.build(wall_cap=64, post_cap=64, device="cpu"),
                       seed=0, device="cpu")
assert "jax" not in sys.modules and "redqueen_tpu" not in sys.modules
print("ok", res.n_posts)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
