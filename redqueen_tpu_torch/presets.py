"""The BASELINE benchmark configurations as named presets, the
counterpart of ``redqueen_tpu.presets``.

Each preset returns a ready-to-run bundle:

- batch presets (1, 3, 5) -> ``("batch", cfg, params, adj, row)`` for
  ``sim.simulate_batch``, ``row`` the controlled broadcaster's source;
- star presets (2, 4) -> ``("star", cfg, wall, ctrl)`` for
  ``parallel.bigf.simulate_star``;
- ``power_law`` -> ``("ragged", counts, opts)`` for
  ``parallel.lanes.simulate_ragged``.

:func:`run_preset` runs any of them and reports one metrics dict.  Every
preset takes a ``scale`` in (0, 1] that shrinks it, and a ``device``
(the card by default)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import device as _device
from .device import DeviceLike, resolve_device

__all__ = ["PRESETS", "build_preset", "run_preset", "power_law_graph",
           "config5_data", "batch_lanes", "batch_metrics"]

def _scaled(n: int, scale: float, lo: int = 1) -> int:
    return max(int(round(n * scale)), lo)


def config1_toy(scale: float = 1.0, end_time: float = 100.0, q: float = 1.0,
                wall_rate: float = 1.0, n_components: int = 1,
                capacity: int = 2048, device: DeviceLike = "cuda"):
    """1 Opt broadcaster against 10 Poisson-feed followers — the paper's
    toy and the NumPy-parity anchor (BASELINE config 1)."""
    from .config import GraphBuilder, stack_components

    n_followers = _scaled(10, scale)
    gb = GraphBuilder(n_sinks=n_followers, end_time=end_time)
    opt = gb.add_opt(q=q)
    for i in range(n_followers):
        gb.add_poisson(rate=wall_rate, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=capacity, device=device)
    if n_components > 1:
        params, adj = stack_components([p0] * n_components,
                                       [a0] * n_components)
        return ("batch", cfg, params, adj, opt)
    return ("batch", cfg, p0, a0, opt)


def config2_hawkes(scale: float = 1.0, end_time: float = 100.0,
                   q: float = 1.0, l0: float = 0.5, alpha: float = 0.8,
                   beta: float = 2.0, wall_cap: int = 512,
                   post_cap: int = 4096, device: DeviceLike = "cuda"):
    """1 broadcaster against 1k self-exciting Hawkes feeds, on the star
    engine (BASELINE config 2)."""
    from .parallel.bigf import StarBuilder

    n_feeds = _scaled(1000, scale)
    sb = StarBuilder(n_feeds=n_feeds, end_time=end_time)
    for f in range(n_feeds):
        sb.wall_hawkes(f, l0=l0, alpha=alpha, beta=beta)
    sb.ctrl_opt(q=q)
    cfg, wall, ctrl = sb.build(wall_cap=wall_cap, post_cap=post_cap,
                               device=device)
    return ("star", cfg, wall, ctrl)


def config3_bipartite(scale: float = 1.0, end_time: float = 100.0,
                      q: float = 1.0, wall_rate: float = 1.0,
                      followers_per: int = 10, capacity: int = 2048,
                      device: DeviceLike = "cuda"):
    """1k broadcasters x 10 followers each (BASELINE config 3): RedQueen
    broadcasters do not couple, so the graph is independent components
    run as one batch."""
    from .config import GraphBuilder, stack_components

    B = _scaled(1000, scale)
    gb = GraphBuilder(n_sinks=followers_per, end_time=end_time)
    opt = gb.add_opt(q=q)
    for i in range(followers_per):
        gb.add_poisson(rate=wall_rate, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=capacity, device=device)
    params, adj = stack_components([p0] * B, [a0] * B)
    return ("batch", cfg, params, adj, opt)


def config4_replay(scale: float = 1.0, end_time: float = 100.0,
                   q: float = 1.0, seed: int = 7, mean_rate: float = 1.0,
                   traces=None, post_cap: int = 4096,
                   trace_max_len: Optional[int] = 256,
                   device: DeviceLike = "cuda"):
    """Replay walls, 100k followers (BASELINE config 4), from the
    synthetic heavy-tailed corpus when no trace is given;
    ``trace_max_len`` bounds a user's trace, since the replay tensor pads
    to the longest."""
    from .data import star_from_traces, synthetic_twitter

    n_feeds = _scaled(100_000, scale)
    if traces is None:
        traces = synthetic_twitter(seed, n_feeds, end_time,
                                   mean_rate=mean_rate,
                                   max_len=trace_max_len)
    cfg, wall, ctrl = star_from_traces(traces, end_time, ctrl="opt", q=q,
                                       post_cap=post_cap, device=device)
    return ("star", cfg, wall, ctrl)


def config5_data(seed: int = 0):
    """Config 5's fit data ``(taus, mask)``: 32 sequences of 24 Exp(mean
    0.7) gaps from ``RandomState(seed)``, all valid."""
    taus = np.random.RandomState(seed).exponential(0.7, (32, 24))
    return taus.astype(np.float32), np.ones(taus.shape, bool)


def config5_rmtpp(scale: float = 1.0, end_time: float = 100.0,
                  wall_rate: float = 1.0, hidden: int = 8,
                  train_steps: int = 120, seed: int = 0,
                  capacity: int = 2048, weights=None,
                  device: DeviceLike = "cuda"):
    """The RMTPP neural intensity as the controlled broadcaster against 10
    Poisson-feed followers (BASELINE config 5), behind the same policy
    seam as Opt.  Unless ``weights`` is given it trains a small model
    (``models.rmtpp.fit``, ``train_steps`` steps of Adam on ``device``)
    on 32 gap sequences of 24 Exp(mean 0.7) gaps from
    ``RandomState(seed)`` (:func:`config5_data`)."""
    from .config import GraphBuilder
    from .models import rmtpp

    n_followers = _scaled(10, scale)
    if weights is None:
        taus, mask = config5_data(seed)
        weights, _, _ = rmtpp.fit(seed, taus, mask, hidden=hidden,
                                  steps=train_steps, device=device)
    gb = GraphBuilder(n_sinks=n_followers, end_time=end_time)
    row = gb.add_rmtpp()
    for i in range(n_followers):
        gb.add_poisson(rate=wall_rate, sinks=[i])
    cfg, params, adj = gb.build(capacity=capacity, rmtpp_hidden=hidden,
                                device=device)
    params = rmtpp.attach(params, weights).to(device)
    return ("batch", cfg, params, adj, row)


def power_law_graph(B, alpha: float = 2.2, seed: int = 0,
                    min_followers: int = 1, max_followers: int = 1024,
                    end_time: float = 100.0, q: float = 1.0,
                    wall_rate: float = 1.0, scale: float = 1.0):
    """``B`` independent broadcaster components whose follower counts
    follow a truncated power law P(F = k) ∝ k^-alpha on [min_followers,
    max_followers], as a ragged bundle ``("ragged", counts, opts)``
    (the same numpy draw as the JAX package's).  ``B`` must be a true
    integer, ``alpha`` finite and > 0, ``max_followers >= 2``."""
    from .config import ConfigValidationError

    if isinstance(B, bool) or not isinstance(B, (int, np.integer)):
        raise ConfigValidationError(
            f"B must be an integer broadcaster count, got {B!r} "
            f"({type(B).__name__}) — a float would silently truncate "
            f"the lane count")
    if B < 1:
        raise ConfigValidationError(f"B must be >= 1, got {B}")
    alpha = float(alpha)
    if not (np.isfinite(alpha) and alpha > 0):
        raise ConfigValidationError(
            f"alpha must be finite and > 0, got {alpha!r} (the tail "
            f"exponent of P(F=k) ∝ k^-alpha)")
    min_f, max_f = int(min_followers), int(max_followers)
    if min_f < 1:
        raise ConfigValidationError(
            f"min_followers must be >= 1, got {min_followers!r}")
    if max_f < min_f:
        raise ConfigValidationError(
            f"max_followers ({max_followers!r}) must be >= min_followers "
            f"({min_followers!r})")
    if max_f < 2:
        raise ConfigValidationError(
            "max_followers < 2 makes every broadcaster a single-follower "
            "component — a degenerate star with no raggedness to bucket; "
            "use config1_toy/config3_bipartite for fixed-width graphs")
    B_s = _scaled(B, scale)
    max_f = max(_scaled(max_f, scale), 2)
    min_f = min(min_f, max_f)
    ks = np.arange(min_f, max_f + 1, dtype=np.float64)
    p = ks ** -alpha
    p /= p.sum()
    rng = np.random.RandomState(seed)
    counts = rng.choice(np.arange(min_f, max_f + 1), size=B_s, p=p)
    return ("ragged", counts.astype(np.int64),
            dict(end_time=float(end_time), q=float(q),
                 wall_rate=float(wall_rate)))


PRESETS = {
    1: config1_toy,
    2: config2_hawkes,
    3: config3_bipartite,
    4: config4_replay,
    5: config5_rmtpp,
    "toy": config1_toy,
    "hawkes": config2_hawkes,
    "bipartite": config3_bipartite,
    "replay": config4_replay,
    "rmtpp": config5_rmtpp,
    "power_law": power_law_graph,
}


def build_preset(which, **kw):
    """Build BASELINE preset ``which`` (1-5 or a name); keyword arguments
    override the preset's defaults."""
    if which not in PRESETS:
        raise KeyError(
            f"unknown preset {which!r}; have {sorted(PRESETS, key=str)}")
    return PRESETS[which](**kw)


def _host(*xs):
    """Reduced per-lane vectors to the host in one read."""
    red = _device.host_read(torch.stack([x.double() for x in xs]))
    return [np.asarray(r) for r in red]


def batch_lanes(bundle, seeds, device: DeviceLike = "cuda"):
    """A batch bundle's lanes on ``device``: ``(cfg, params, adj, row,
    seeds)`` with one seed per lane.  A stacked bundle takes one seed per
    component or a scalar base seed; a single component is stacked once
    per seed."""
    from .config import stack_components

    _, cfg, params, adj, row = bundle
    dev = resolve_device(device)
    seeds = np.asarray(seeds)
    if params.kind.dim() == 2:
        B = params.kind.shape[0]
        if seeds.ndim == 0:
            seeds = np.arange(B) + int(seeds)
        elif len(seeds) != B:
            raise ValueError(
                f"batched preset needs {B} seeds (one per component) or "
                f"a scalar base seed; got {len(seeds)}")
    else:
        seeds = np.atleast_1d(seeds)
        n = len(seeds)
        params, adj = stack_components([params] * n, [adj] * n)
    return cfg, params.to(dev), adj.to(dev), row, seeds


def batch_metrics(log, adj, row, end_time: float, metric_K: int = 1):
    """Per-lane time-in-top-K of ``row``, its posts and the lane's events,
    as tensors on the log's device (nothing is read to the host)."""
    from .utils.metrics import feed_metrics_batch, num_posts

    m = feed_metrics_batch(log.times, log.srcs, adj, row, end_time,
                           K=metric_K)
    return m.mean_time_in_top_k(), num_posts(log.srcs, row), log.n_events


def _run_star(bundle, seeds, mesh, metric_K: int, dev):
    """A star bundle over ``seeds`` -> host ``(tops, posts, events)``."""
    from .parallel import comm
    from .parallel.bigf import (
        broadcast_star,
        simulate_star,
        simulate_star_batch,
    )

    _, cfg, wall, ctrl = bundle
    seeds_arr = np.asarray(seeds).ravel()
    axes = mesh.shape if mesh is not None else {}
    if len(seeds_arr) == 1 or (mesh is not None and "data" not in axes):
        # One seed, or a feed-only mesh: one component at a time.
        rows = []
        for s in seeds_arr:
            res = simulate_star(cfg, wall, ctrl, seed=int(s), mesh=mesh,
                                metric_K=metric_K, device=dev)
            rows.append(torch.stack([
                comm.local(res.metrics.mean_time_in_top_k()).double(),
                torch.tensor(res.n_posts, dtype=torch.float64, device=dev),
                comm.total(res.wall_n).double()]))
        tops, posts, wn = _host(*torch.stack(rows, 1))
    else:
        wb, cb = broadcast_star(wall.to(dev), ctrl.to(dev), len(seeds_arr))
        res = simulate_star_batch(
            cfg, wb, cb, seeds_arr, mesh=mesh,
            feed_axis="feed" if "feed" in axes else None,
            metric_K=metric_K, device=dev)
        tops, posts = _lanes_host(mesh, res.metrics.mean_time_in_top_k(),
                                  res.n_posts)
        wn = _host(comm.total(res.wall_n)[None])[0]
    return tops, posts, int(wn.sum()) + int(posts.sum())


def _lanes_host(mesh, *xs):
    """Per-lane vectors (marked as sharded over the lanes with ``mesh``)
    whole on the host, float64, in one read or one gather."""
    if mesh is None:
        return _host(*xs)
    from .parallel.multihost import gather_global

    return [np.asarray(x, np.float64) for x in gather_global(xs)]


def run_preset(bundle, seeds, mesh=None, max_chunks: int = 256,
               metric_K: int = 1, device: DeviceLike = "cuda"):
    """Run a preset bundle over ``seeds`` on ``device`` (the card by
    default) and return a metrics dict: events (total), mean time-in-top-K,
    mean posts per broadcaster, and the per-seed values.

    Batch and ragged bundles take one seed per lane or a scalar base
    seed; a single batch component is stacked once per seed.  Star
    bundles run one component per seed: one seed through
    ``simulate_star``, several as one ``simulate_star_batch``.

    With ``mesh`` (every rank calls it, and every rank gets the whole
    dict): batch lanes split over its ``"data"`` axis through
    ``simulate_sharded``; a star bundle with one seed, or on a mesh
    without a ``"data"`` axis, splits its feeds over ``"feed"`` seed by
    seed, otherwise its seeds split over ``"data"`` (and its feeds over
    ``"feed"`` where the mesh has one).  Ragged bundles do not shard."""
    dev = resolve_device(device)
    kind = bundle[0]
    if kind == "batch":
        from .sim import simulate_batch

        cfg, params_b, adj_b, opt_row, seeds = batch_lanes(bundle, seeds, dev)
        if mesh is None:
            log = simulate_batch(cfg, params_b, adj_b, seeds,
                                 max_chunks=max_chunks, device=dev)
            tops, posts, nev = _host(*batch_metrics(log, adj_b, opt_row,
                                                    cfg.end_time, metric_K))
        else:
            from .parallel import comm
            from .parallel.shard import simulate_sharded
            from .sim import EventLog

            log = simulate_sharded(cfg, params_b, adj_b, seeds, mesh,
                                   max_chunks=max_chunks, device=dev)
            local = EventLog(*comm.local((log.times, log.srcs,
                                          log.n_events)), cfg)
            per_lane = batch_metrics(local, comm.block(adj_b, mesh,
                                                       comm.P("data")),
                                     opt_row, cfg.end_time, metric_K)
            tops, posts, nev = _lanes_host(mesh, *(
                comm.mark(x, mesh, comm.P("data")) for x in per_lane))
        events = int(nev.sum())
        end_time = cfg.end_time
    elif kind == "ragged":
        if mesh is not None:
            raise ValueError(
                "ragged presets dispatch through parallel.lanes."
                "simulate_ragged, which does not shard over a mesh yet "
                "(the ROADMAP item 3 remainder) — drop mesh or use a "
                "batch/star preset")
        _, counts, opts = bundle
        from .parallel.lanes import simulate_ragged

        B = len(counts)
        seeds = np.asarray(seeds)
        if seeds.ndim == 0:
            seeds = np.arange(B) + int(seeds)
        elif len(seeds) != B:
            raise ValueError(
                f"ragged preset needs {B} seeds (one per lane) or a "
                f"scalar base seed; got {len(seeds)}")
        rr = simulate_ragged(counts, seeds, metric_K=metric_K, device=dev,
                             **opts)
        tops, posts, events = rr.top_k, rr.posts, rr.events
        end_time = opts["end_time"]
    elif kind == "star":
        tops, posts, events = _run_star(bundle, seeds, mesh, metric_K, dev)
        end_time = bundle[1].end_time
    else:
        raise ValueError(f"unknown bundle kind {kind!r}")
    return {
        "events": events,
        "mean_time_in_top_k": float(tops.mean()),
        "mean_posts": float(posts.mean()),
        "per_seed_top_k": tops.tolist(),
        "per_seed_posts": posts.tolist(),
        "end_time": end_time,
    }
