"""The port's star engine on BASELINE config 2's model (one ``Opt``
against self-exciting Hawkes walls) held to the benchmark's plain
reference, ``portbench/reference/star.py`` (float64 PyTorch on the CPU,
importing nothing of the port), at small sizes with seeded random
per-feed ``l0``, ``alpha`` and ``beta`` (alpha < beta): both fire modes,
compressed and uncompressed fires, and a (lanes x feeds) mesh of one.

Tolerances, in units of time (T = 20, where a float32 time's ulp is
1.9e-6): ``WALL_TOL`` 1e-4 on how far a wall event lies from the
reference's thinning anchored at the program's previous event (a chain
of proposals adds a few float32 roundings of ``t + e / bound``; sound
readings ~1e-5); ``POST_TOL`` 1e-4 on a post against the least candidate
after the previous one (one float32 rounding of ``t + e / rate``; ~1e-6);
``METRIC_TOL`` 1e-4 on each feed's time on top and its mean (float32
sums of up to a hundred spans; ~1e-6).  The same comparison with the
reference run in bfloat16 reads ~1, ~0.06 and ~0.06: each fails."""

import numpy as np
import pytest
import torch

from portbench.reference import star as ref
from redqueen_tpu_torch.parallel import bigf as TB
from redqueen_tpu_torch.parallel import star_fire, star_run

WALL_TOL = 1e-4
POST_TOL = 1e-4
METRIC_TOL = 1e-4
F, T, L = 24, 20.0, 3
SEEDS = np.array([5, 2 ** 31 + 17, 123456789])


def _params(seed=0):
    rng = np.random.RandomState(seed)
    l0 = rng.uniform(0.3, 1.0, F).astype(np.float32)
    beta = rng.uniform(1.0, 3.0, F).astype(np.float32)
    alpha = (beta * rng.uniform(0.2, 0.8, F)).astype(np.float32)
    return l0, alpha, beta


def _component(wall_cap=128):
    l0, alpha, beta = _params()
    sb = TB.StarBuilder(n_feeds=F, end_time=T)
    for f in range(F):
        sb.wall_hawkes(f, float(l0[f]), float(alpha[f]), float(beta[f]))
    sb.ctrl_opt(q=1.0)
    cfg, wall, ctrl = sb.build(wall_cap=wall_cap, post_cap=1024,
                               device="cpu")
    star = ref.Star(*(torch.tensor(x, dtype=torch.float64)
                      for x in (l0, alpha, beta, np.ones(F))),
                    end_time=T, post_cap=1024, wall_cap=wall_cap)
    return cfg, wall, ctrl, star


def _gaps(star, times, n, own, n_p, top, mean):
    w, _, _ = ref.check_walls(star, SEEDS, times, n)
    p = ref.check_posts(star, SEEDS, times, n, own, n_p)
    rt, rm = ref.top1(star, times, n, own, n_p)
    m = max(float((torch.as_tensor(top, dtype=torch.float64) - rt).abs()
                  .max()),
            float((torch.as_tensor(mean, dtype=torch.float64) - rm).abs()
                  .max()))
    return float(w.max()), float(p.max()), m


def _check(star, times, n, own, n_p, top, mean):
    w, p, m = _gaps(star, times, n, own, n_p, top, mean)
    assert w <= WALL_TOL and p <= POST_TOL and m <= METRIC_TOL, (w, p, m)


@pytest.mark.parametrize("fire_mode", ["loop", "doubling"])
@pytest.mark.parametrize("compress", [True, False])
def test_port_matches_the_reference(fire_mode, compress, monkeypatch):
    cfg, wall, ctrl, star = _component()
    wb, cb = TB.broadcast_star(wall, ctrl, L)
    assert 128 > star_fire._rec_cap(128)      # compression applies
    block = {(cfg, 1, star_run._regime_key(cb, wb))} if not compress \
        else set()
    monkeypatch.setattr(star_run, "_COMPRESS_BLOCKLIST", block)
    calls = []
    real = star_run._get_fn
    monkeypatch.setattr(star_run, "_get_fn", lambda *a, **k: calls.append(
        a[2]) or real(*a, **k))
    res = TB.simulate_star_batch(cfg, wb, cb, SEEDS, fire_mode=fire_mode,
                                 device="cpu")
    assert calls == [compress]
    assert int(res.wall_n.sum()) > 500 and int(res.n_posts.min()) > 20
    _check(star, res.wall_times, res.wall_n, res.own_times, res.n_posts,
           res.metrics.time_in_top_k, res.metrics.mean_time_in_top_k())
    for b, seed in enumerate(SEEDS):
        one = TB.simulate_star(cfg, wall, ctrl, seed=int(seed),
                               fire_mode=fire_mode, device="cpu")
        assert torch.equal(res.wall_times[b], one.wall_times)
        assert torch.equal(res.own_times[b], one.own_times)


def test_mesh_of_one_matches_the_reference(tmp_path):
    from redqueen_tpu_torch.parallel import comm, multihost
    from torch_mesh_world import one_rank

    cfg, wall, ctrl, star = _component()
    wb, cb = TB.broadcast_star(wall, ctrl, L)
    plain = TB.simulate_star_batch(cfg, wb, cb, SEEDS, device="cpu")
    with one_rank(tmp_path):
        sh = TB.simulate_star_batch(
            cfg, wb, cb, SEEDS, mesh=comm.make_mesh({"data": 1, "feed": 1}),
            axis="data", feed_axis="feed", device="cpu")
        assert comm.is_sharded(sh.wall_times)
        g = multihost.gather_global({
            "wall_times": sh.wall_times, "wall_n": sh.wall_n,
            "own": sh.own_times, "n_posts": sh.n_posts,
            "top": sh.metrics.time_in_top_k,
            "mean": sh.metrics.mean_time_in_top_k()})
    _check(star, g["wall_times"], g["wall_n"], g["own"], g["n_posts"],
           g["top"], g["mean"])
    np.testing.assert_array_equal(g["wall_times"], plain.wall_times.numpy())


def test_the_comparison_fails_in_bfloat16():
    """The reference run free in bfloat16 in the port's place fails each
    tolerance; in float32 it passes them."""
    _, _, _, star = _component()
    out = ref.simulate(star, SEEDS, "float32")
    _check(star, *out)
    w, p, m = _gaps(star, *ref.simulate(star, SEEDS, "bfloat16"))
    assert w > WALL_TOL and p > POST_TOL and m > METRIC_TOL, (w, p, m)


@pytest.mark.parametrize("what", ["wall", "post", "top"])
def test_the_comparison_catches_a_moved_event(what):
    cfg, wall, ctrl, star = _component()
    res = TB.simulate_star_batch(cfg, *TB.broadcast_star(wall, ctrl, L),
                                 SEEDS, device="cpu")
    times, own = res.wall_times.clone(), res.own_times.clone()
    top = res.metrics.time_in_top_k.clone()
    if what == "wall":
        times[1, 3, 4] += 1e-3
    elif what == "post":
        own[2, 7] += 1e-3
    else:
        top[0, 5] += 1e-3
    gaps = _gaps(star, times, res.wall_n, own, res.n_posts, top,
                 res.metrics.mean_time_in_top_k())
    tol = dict(wall=WALL_TOL, post=POST_TOL, top=METRIC_TOL)[what]
    assert gaps[["wall", "post", "top"].index(what)] > tol


@pytest.mark.parametrize("bias", [1.005, 1.009])
def test_the_comparison_catches_a_biased_acceptance(bias, monkeypatch):
    """Thinning that accepts up to ``bias`` times the intensity samples
    another law, though every decision it flips lies within 1% of a tie:
    the walls' comparison fails it."""
    from redqueen_tpu_torch.ops import prng, streams

    real = streams.thinning_proposal

    def biased(key, t, lbd, *rest):
        nxt, t_new, lbd_new, _ = real(key, t, lbd, *rest)
        u = prng.uniform_from_bits23(
            prng.random_bits(prng.split(key, 3)[..., 2, :]))
        return nxt, t_new, lbd_new, u * lbd <= bias * lbd_new

    monkeypatch.setattr(streams, "thinning_proposal", biased)
    cfg, wall, ctrl, star = _component()
    res = TB.simulate_star_batch(cfg, *TB.broadcast_star(wall, ctrl, L),
                                 SEEDS, device="cpu")
    w, _, flip = ref.check_walls(star, SEEDS, res.wall_times, res.wall_n)
    assert float(w.max()) > WALL_TOL and flip > 0
