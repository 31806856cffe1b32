"""Parameter sweeps as one dispatch, the counterpart of
``redqueen_tpu.sweep``: the reference's nested ``for seed: for q:`` host
loops become one batch of (point x seed) lanes, and the feed-rank
metrics reduce on the device, so the host reads one [4 + 1, lanes]
tensor per sweep and nothing of the size of the event logs.

A sweep point is one component; all points share one static config
(shapes, kinds, horizon), while the parameters vary freely.
:func:`run_sweep` runs ``GraphBuilder`` components on the batch engines,
:func:`run_sweep_star` runs ``StarBuilder`` components on the star
engine.  :func:`run_sweep_checkpointed` runs either in chunks of points,
each landing as a checksummed artifact, so that a killed sweep resumes
bit-identically and a numerically sick lane re-runs alone."""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import device as _device
from .config import stack_components
from .device import DeviceLike, resolve_device
from .parallel.bigf import simulate_star_batch, stack_star
from .runtime import faultinject as _faultinject
from .runtime import integrity as _integrity
from .runtime import numerics as _numerics
from .runtime import preempt as _preempt
from .runtime.supervisor import heartbeat as _heartbeat
from .sim import simulate_batch
from .utils.metrics import feed_metrics_batch, num_posts

__all__ = ["SweepResult", "run_sweep", "run_sweep_star",
           "run_sweep_checkpointed"]

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
              metric_K: int = 1, seed0: int = 0, mesh=None, axis="data",
              max_chunks: int = 100, engine: str = "scan",
              device: DeviceLike = "cuda") -> SweepResult:
    """Run every sweep point across ``n_seeds`` Monte-Carlo seeds in one
    batch on ``device`` (the card by default).

    ``points``: ``(cfg, params, adj)`` triples from ``GraphBuilder.build``
    with EQUAL ``cfg``; ``src_index`` is the tracked broadcaster's row.
    Seeds are ``seed0 + arange(n_points * n_seeds)``, point-major, so
    appending points keeps the earlier points' streams.  ``engine`` goes
    to ``simulate_batch`` (``"scan"``, ``"fused"``/``"pallas"`` or
    ``"auto"``).  ``mesh`` and ``axis`` keep the JAX package's positions;
    a mesh raises until the mesh layer is ported."""
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
                   seed0: int = 0, mesh=None, axis: str = "data",
                   feed_axis=None, fire_mode: str = "auto",
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



# Envelope schema tag of chunk artifacts (the JAX package's): bump on a
# layout change, so that a resume after an upgrade recomputes instead of
# misreading.
_CHUNK_SCHEMA = "rq.sweep.chunk/2"


def _heal_sick_lanes(chunk: SweepResult, pts, n_seeds: int,
                     seed0_chunk: int, runner, ci: int, kwargs: dict):
    """Re-run exactly the sick (point, seed) lanes of one chunk grid, each
    as its own one-lane dispatch with the seed the point-major layout gave
    it (``seed0_chunk + p * n_seeds + s``), and patch the healed values
    in: a healed lane is bit-identical to an unfaulted run.  The re-run
    runs inside a ``numeric_scope`` whose ``lane_base`` maps an
    ``RQ_FAULT`` numeric spec onto the same logical lane, so a fault still
    active keeps the lane sick, and its recorded bits stay.  Returns
    ``(chunk, n_healed)``."""
    sick = np.argwhere(np.asarray(chunk.health) != 0)
    if sick.size == 0:
        return chunk, 0
    fields = {f: np.array(getattr(chunk, f)) for f in SweepResult._fields}
    healed = 0
    for p, s in sick:
        p, s = int(p), int(s)
        lane = p * n_seeds + s
        try:
            with _faultinject.numeric_scope(chunk=ci, lane_base=lane):
                solo = runner([pts[p]], 1, seed0=seed0_chunk + lane,
                              **kwargs)
        except _numerics.NumericalHealthError:
            continue  # the lane died again: its bits stay recorded
        if int(np.asarray(solo.health)[0, 0]) != 0:
            continue
        for f in fields:
            fields[f][p, s] = np.asarray(getattr(solo, f))[0, 0]
        healed += 1
    return SweepResult(**fields), healed


def _leaf_arrays(x):
    """Every tensor of a component's params (a dataclass of tensors, a
    dict of RMTPP weights, or one tensor), in a fixed order."""
    if isinstance(x, torch.Tensor):
        yield x.detach().cpu().numpy()
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaf_arrays(x[k])
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            v = getattr(x, f)
            if v is not None:
                yield from _leaf_arrays(v)
    elif x is not None:
        yield np.asarray(x)


def _chunk_fingerprint(chunk_idx: int, pts, n_seeds: int, seed0_chunk: int,
                       star: bool, kwargs: dict) -> str:
    """Content hash of everything that decides a chunk's result: the
    static config, every parameter byte, the seed layout and the sweep's
    options.  A resumed sweep reuses a stored chunk only when its inputs
    are bit-identical.  The hash covers ``repr(cfg)`` and the keyword
    arguments (``device`` among them), so it differs from the JAX
    package's: a chunk that package wrote is recomputed, never trusted."""
    h = hashlib.sha256()
    h.update(repr((chunk_idx, n_seeds, seed0_chunk, star,
                   sorted((k, str(v)) for k, v in kwargs.items()),
                   pts[0][0])).encode())
    for _, a, b in pts:
        for arr in (*_leaf_arrays(a), *_leaf_arrays(b)):
            h.update(str((arr.dtype, arr.shape)).encode())
            h.update(arr.tobytes())
    return h.hexdigest()[:16]


def run_sweep_checkpointed(points: Sequence, n_seeds: int, ckpt_dir: str,
                           chunk_points: int = 8, star: bool = False,
                           seed0: int = 0, **kwargs) -> SweepResult:
    """A restartable sweep: the points run in chunks of ``chunk_points``,
    each chunk's [p, n_seeds] grids landing in ``ckpt_dir`` as one
    atomically renamed, checksummed ``.npz`` (``runtime.integrity``)
    keyed by a fingerprint of the chunk's inputs.  Run again with the same
    arguments, it recomputes only the missing chunks; a chunk whose
    inputs changed recomputes and is overwritten; a chunk that fails
    verification (truncated, bit-flipped, forged checksum) is quarantined
    (``*.corrupt-<ts>`` and a report) and recomputes.

    A lane that went numerically sick (its health word non-zero) is
    recorded in the chunk's ``health`` grid and re-run alone with its own
    seed (:func:`_heal_sick_lanes`); a lane still sick keeps its bits for
    the next resume.

    The grids are bit-identical to one ``run_sweep``/``run_sweep_star``
    call: the chunk starting at point p0 uses ``seed0 + p0 * n_seeds``,
    the point-major seeds the whole sweep gives those lanes.  ``star``
    selects the star engine; ``kwargs`` go to the sweep (``device``,
    ``engine`` ...).  After each chunk lands the sweep heartbeats to a
    supervisor and honours a pending SIGTERM/SIGINT
    (``runtime.preempt``): a preempted sweep resumes from its chunks."""
    points, _ = _validate_points(
        points, n_seeds, "Wall/CtrlParams" if star else "SourceParams")
    if chunk_points < 1:
        raise ValueError(f"chunk_points must be >= 1, got {chunk_points}")
    os.makedirs(ckpt_dir, exist_ok=True)
    runner = run_sweep_star if star else run_sweep
    grids = []
    for ci, p0 in enumerate(range(0, len(points), chunk_points)):
        pts = points[p0:p0 + chunk_points]
        seed0_chunk = seed0 + p0 * n_seeds
        fp = _chunk_fingerprint(ci, pts, n_seeds, seed0_chunk, star, kwargs)
        path = os.path.join(ckpt_dir, f"chunk_{ci:05d}.npz")
        chunk = None
        if os.path.exists(path):
            try:
                z = _integrity.load_npz(path, schema=_CHUNK_SCHEMA,
                                        quarantine_schema_mismatch=False)
            except _integrity.CorruptArtifactError:
                # Quarantined by load_npz (a valid archive of an older
                # schema is not: stale is not corrupt); it recomputes.
                pass
            except OSError:
                pass  # unreadable for another reason: recompute
            else:
                if (str(z.get("fingerprint")) == fp
                        and all(f in z for f in SweepResult._fields)):
                    chunk = SweepResult(*(z[f] for f in SweepResult._fields))
        fresh = chunk is None
        if fresh:
            # RQ_FAULT=numeric:mode@laneN,chunkM addresses lanes per chunk;
            # the scope is a no-op without a numeric fault.
            with _faultinject.numeric_scope(chunk=ci):
                chunk = runner(pts, n_seeds, seed0=seed0_chunk, **kwargs)
        chunk, healed = _heal_sick_lanes(
            chunk, pts, n_seeds, seed0_chunk, runner, ci, kwargs)
        if fresh or healed:
            _integrity.savez(
                path, schema=_CHUNK_SCHEMA, fingerprint=fp,
                **{f: getattr(chunk, f) for f in SweepResult._fields})
        grids.append(chunk)
        # The chunk boundary is the durable safe point.
        _heartbeat()
        _preempt.check_preempt(f"run_sweep_checkpointed chunk {ci}")
    return SweepResult(*(
        np.concatenate([getattr(g, f) for g in grids], axis=0)
        for f in SweepResult._fields))
