"""Parameter sweeps as one dispatch, the counterpart of
``redqueen_tpu.sweep``: the reference's nested ``for seed: for q:`` host
loops become one batch of (point x seed) lanes, and the feed-rank
metrics reduce on the device, so the host reads one [4 + 1, lanes]
tensor per sweep and nothing of the size of the event logs.

A sweep point is one component; all points share one static config
(shapes, kinds, horizon), while the parameters vary freely.
:func:`run_sweep` runs ``GraphBuilder`` components on the batch engines,
:func:`run_sweep_star` runs ``StarBuilder`` components on the star
engine.  The checkpointed sweep and its healing of sick lanes wait for
the runtime layer (ROADMAP.md Queue 1 item 7)."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import device as _device
from .config import stack_components
from .device import DeviceLike, resolve_device
from .parallel.bigf import simulate_star_batch, stack_star
from .runtime import numerics as _numerics
from .sim import simulate_batch
from .utils.metrics import feed_metrics_batch, num_posts

__all__ = ["SweepResult", "run_sweep", "run_sweep_star"]

_MESH_ITEM = "ROADMAP.md Queue 1 item 6 (mesh -> torch.distributed)"


class SweepResult(NamedTuple):
    """Per-(point, seed) scalars, numpy [n_points, n_seeds] on the host.
    ``health`` is the lane-health grid (uint32, ``runtime.numerics``
    BIT_*): 0 = trustworthy; any lane whose reduced values are not finite
    also carries BIT_NONFINITE_RESULT."""

    time_in_top_k: np.ndarray   # mean over followed feeds, absolute time
    average_rank: np.ndarray    # time-averaged rank, mean over feeds
    n_posts: np.ndarray         # tracked source's posts (int32)
    int_rank2: np.ndarray       # int r^2 dt, mean over feeds
    health: np.ndarray          # u32 lane-health grid

    @property
    def n_points(self) -> int:
        return self.time_in_top_k.shape[0]

    @property
    def n_seeds(self) -> int:
        return self.time_in_top_k.shape[1]


def _validate_points(points, n_seeds, vary_hint: str):
    """Shared sweep-grid validation; returns (points list, shared cfg)."""
    if n_seeds < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
    points = list(points)
    if not points:
        raise ValueError("empty sweep: no points given")
    cfg0 = points[0][0]
    for i, (cfg, _, _) in enumerate(points):
        if cfg != cfg0:
            raise ValueError(
                f"sweep point {i} has a different static config than point "
                f"0 — all points must share shapes/kinds/horizon (vary "
                f"{vary_hint} instead, or run separate sweeps)")
    return points, cfg0


def _grid_host(rows: torch.Tensor, P: int, n_seeds: int) -> np.ndarray:
    """The sweep's one device -> host read: ``rows`` [k, P * n_seeds]
    (float64, exact for float32 values, int32 counts and uint32 words)
    -> numpy [k, P, n_seeds]."""
    return np.asarray(_device.host_read(rows)).reshape(-1, P, n_seeds)


def _reduce_to_grid(m, n_posts, P: int, n_seeds: int,
                    kernel_health=None) -> SweepResult:
    """``FeedMetrics`` [B, F] + per-lane posts (+ the engine's per-lane
    health words, None for the star engine) -> [P, n_seeds] grids, read
    once.  The window comes from the metrics themselves."""
    follows_n = torch.clamp(m.follows.sum(-1), min=1)
    ir2 = (m.int_rank2 * m.follows).sum(-1) / follows_n
    health = (torch.zeros_like(n_posts) if kernel_health is None
              else kernel_health)
    g = _grid_host(torch.stack([
        m.mean_time_in_top_k().double(), m.mean_average_rank().double(),
        n_posts.double(), ir2.double(), health.double()]), P, n_seeds)
    values = dict(time_in_top_k=g[0].astype(np.float32),
                  average_rank=g[1].astype(np.float32),
                  n_posts=g[2].astype(np.int32),
                  int_rank2=g[3].astype(np.float32))
    bad = np.zeros((P, n_seeds), bool)
    for v in values.values():
        bad |= ~np.isfinite(np.asarray(v, np.float64))
    health = g[4].astype(np.uint32) | np.where(
        bad, np.uint32(_numerics.BIT_NONFINITE_RESULT), np.uint32(0))
    return SweepResult(health=health, **values)


def run_sweep(points: Sequence, n_seeds: int, src_index: int = 0,
              metric_K: int = 1, seed0: int = 0, mesh=None,
              max_chunks: int = 100, engine: str = "scan",
              device: DeviceLike = "cuda") -> SweepResult:
    """Run every sweep point across ``n_seeds`` Monte-Carlo seeds in one
    batch on ``device`` (the card by default).

    ``points``: ``(cfg, params, adj)`` triples from ``GraphBuilder.build``
    with EQUAL ``cfg``; ``src_index`` is the tracked broadcaster's row.
    Seeds are ``seed0 + arange(n_points * n_seeds)``, point-major, so
    appending points keeps the earlier points' streams.  ``engine`` goes
    to ``simulate_batch`` (``"scan"``, ``"fused"`` or ``"auto"``)."""
    if mesh is not None:
        raise NotImplementedError(
            f"sharded sweeps (mesh=) are not ported yet — {_MESH_ITEM}")
    dev = resolve_device(device)
    points, cfg0 = _validate_points(points, n_seeds, "SourceParams")
    P = len(points)
    params, adj = stack_components(
        [p.to(dev) for _, p, _ in points for _ in range(n_seeds)],
        [torch.as_tensor(a).to(dev) for _, _, a in points
         for _ in range(n_seeds)])
    seeds = np.arange(P * n_seeds) + seed0
    log = simulate_batch(cfg0, params, adj, seeds, max_chunks=max_chunks,
                         engine=engine, device=dev)
    m = feed_metrics_batch(log.times, log.srcs, adj, src_index,
                           cfg0.end_time, K=metric_K,
                           start_time=cfg0.start_time)
    return _reduce_to_grid(m, num_posts(log.srcs, src_index), P, n_seeds,
                           kernel_health=log.health)


def run_sweep_star(points: Sequence, n_seeds: int, metric_K: int = 1,
                   seed0: int = 0, mesh=None, fire_mode: str = "auto",
                   device: DeviceLike = "cuda") -> SweepResult:
    """The star-engine twin of :func:`run_sweep`: points are ``(cfg, wall,
    ctrl)`` triples from ``StarBuilder``, crossed with ``n_seeds`` into one
    ``simulate_star_batch``, with the same grid layout and seed rule."""
    if mesh is not None:
        raise NotImplementedError(
            f"sharded sweeps (mesh=) are not ported yet — {_MESH_ITEM}")
    dev = resolve_device(device)
    points, cfg0 = _validate_points(points, n_seeds, "Wall/CtrlParams")
    P = len(points)
    wall_b, ctrl_b = stack_star(
        [w.to(dev) for _, w, _ in points for _ in range(n_seeds)],
        [c.to(dev) for _, _, c in points for _ in range(n_seeds)])
    seeds = np.arange(P * n_seeds) + seed0
    res = simulate_star_batch(cfg0, wall_b, ctrl_b, seeds,
                              metric_K=metric_K, fire_mode=fire_mode,
                              device=dev)
    return _reduce_to_grid(res.metrics, res.n_posts, P, n_seeds)

