"""Star-engine execution: the kernel (streams -> fires -> metrics), its
cache, the overflow checks with the compressed -> uncompressed retry,
and the entry points ``simulate_star``/``simulate_star_batch`` — the
counterpart of ``redqueen_tpu.parallel.star_run``.

The kernel is written batched over lanes ``[B]`` (the JAX engine's
``vmap`` of its one-component kernel); ``simulate_star`` runs it on one
lane.  With a mesh, each rank runs the kernel on its block: lanes split
over the batch axis, feeds over the ``"feed"`` axis.  The kernel's
collectives over ``"feed"`` (``comm.pany``, ``comm.pmin``, the global
feed offset) are identities unless that axis is bound, and the outputs
that split are marked as sharded (``comm.mark``)."""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.base import KIND_OPT, map_weights
from ..ops import prng
from ..runtime import telemetry as _telemetry
from ..sim import _as_keys
from ..utils.metrics import FeedMetrics
from . import comm
from .star_fire import _check_fire_mode, _opt_fires, _resolve_fire_mode
from .star_metrics import _feed_metrics_star
from .star_streams import _check_wall_kinds, _ctrl_stream, _wall_streams
from .star_types import (
    CtrlParams,
    RecordBudgetOverflow,
    ShardedFeedMetrics,
    StarBatchResult,
    StarConfig,
    StarResult,
    WallParams,
)

__all__ = ["simulate_star", "simulate_star_batch", "stack_star",
           "broadcast_star"]

def _make_kernel(cfg: StarConfig, metric_K: int, compress: bool = True,
                 fire_mode: str = "auto"):
    """The star kernel for ``[B]`` lanes: ``kernel(wall, ctrl, keys) ->
    (own, n_posts, feed_times, wall_n, metrics, wall_trunc, post_trunc,
    rec_trunc)``, every output with a leading ``[B]``.  Its two stages
    are ``kernel.walls(wall, keys)`` (step 1) and ``kernel.rest(walls,
    wall, ctrl)`` (steps 2 and 3), so that a retry after a record-budget
    overflow reruns only the fires and the metrics."""

    def walls(wall: WallParams, keys: torch.Tensor):
        B, Fl, M = wall.kind.shape
        dev = keys.device
        feed_offset = comm.axis_index("feed") * Fl
        key_wall = prng.fold_in(keys, 101)

        # 1) independent wall streams, one key per global slot f*M + m.
        with _telemetry.span("star.streams"):
            slot = (feed_offset * M
                    + torch.arange(Fl * M, device=dev).reshape(Fl, M))
            slot_keys = prng.fold_in(key_wall[:, None, None, :], slot[None])
            st = _wall_streams(cfg, wall, slot_keys)
            feed_times = torch.sort(st.times.reshape(B, Fl, -1),
                                    dim=-1).values
            wall_n = st.n.sum(-1).to(torch.int32)
            wall_trunc = comm.pany(st.truncated.reshape(B, -1).any(-1),
                                   "feed")
        return feed_times, wall_n, wall_trunc, keys

    def rest(walls_out, wall: WallParams, ctrl: CtrlParams):
        feed_times, wall_n, wall_trunc, keys = walls_out
        B, Fl, _ = wall.kind.shape
        dev = keys.device
        feed_offset = comm.axis_index("feed") * Fl
        key_tau = prng.fold_in(keys, 202)
        key_own = prng.fold_in(keys, 303)

        # 2) the controlled broadcaster's posting times.
        if cfg.ctrl_kind == KIND_OPT:
            with _telemetry.span("star.fires", mode=fire_mode,
                                 compress=compress):
                rate_f = torch.sqrt(wall.s_sink / torch.clamp(
                    ctrl.q, min=1e-30)[:, None])
                own, post_trunc, rec_trunc = _opt_fires(
                    cfg, feed_times, rate_f.to(feed_times.dtype), key_tau,
                    feed_offset,
                    compress=compress, fire_mode=fire_mode)
        else:
            s = _ctrl_stream(cfg, ctrl, key_own)
            own, post_trunc = s.times, s.truncated
            rec_trunc = torch.zeros(B, dtype=torch.bool, device=dev)
        n_posts = torch.isfinite(own).sum(-1).to(torch.int32)

        # 3) per-feed metrics and the flags.
        with _telemetry.span("star.metrics"):
            metrics = _feed_metrics_star(cfg, feed_times, own, metric_K)
        return (own, n_posts, feed_times, wall_n, metrics, wall_trunc,
                post_trunc, rec_trunc)

    def kernel(wall: WallParams, ctrl: CtrlParams, keys: torch.Tensor):
        return rest(walls(wall, keys), wall, ctrl)

    kernel.walls, kernel.rest = walls, rest
    return kernel


_FN_CACHE: dict = {}


def _get_fn(cfg: StarConfig, metric_K: int, compress: bool, fire_mode: str,
            device: torch.device, feed_sharded: bool = False):
    """The kernel cache, keyed on everything the kernel closes over, with
    ``"auto"`` resolved for the device and the feed layout first."""
    fire_mode = _resolve_fire_mode(fire_mode, feed_sharded, device)
    key = (cfg, metric_K, compress, fire_mode)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = _FN_CACHE[key] = _make_kernel(cfg, metric_K, compress,
                                           fire_mode)
    return fn


# Configs whose candidates overflowed the record budget once skip straight
# to the uncompressed path for the rest of the process.
_COMPRESS_BLOCKLIST: set = set()


def _regime_key(ctrl: CtrlParams, wall: WallParams):
    """Coarse clock-regime signature for the blocklist: the mean clock
    rate sqrt(s_sink / q) to 3 significant figures."""
    q = ctrl.q.double()
    s = wall.s_sink.double()
    if q.numel() == 0 or s.numel() == 0:
        return None
    m = float(torch.sqrt(s.mean() / torch.clamp(q.mean(), min=1e-30)))
    return float(f"{m:.3g}") if np.isfinite(m) else None


def _run_with_fallback(cfg: StarConfig, metric_K: int, ctrl: CtrlParams,
                       wall: WallParams, run, lane_sum=None):
    """Run compressed first, then uncompressed on ``RecordBudgetOverflow``
    (and remember the regime).  ``run(compress) -> kernel outputs``;
    ``lane_sum`` totals the flag counts over the ranks that split the
    lanes, so that every rank takes the same branch."""
    key = (cfg, metric_K, _regime_key(ctrl, wall))
    if key not in _COMPRESS_BLOCKLIST:
        try:
            out = run(True)
            _check_overflow(cfg, out[5], out[6], out[7], lane_sum)
            return out
        except RecordBudgetOverflow:
            _COMPRESS_BLOCKLIST.add(key)
            _telemetry.counter("star.fires.uncompressed")
    out = run(False)
    _check_overflow(cfg, out[5], out[6], lane_sum=lane_sum)
    return out


def _check_overflow(cfg: StarConfig, wall_trunc, post_trunc, rec_trunc=None,
                    lane_sum=None):
    """Raise, never truncate, when a lane's buffers filled.  ``rec_trunc``
    first: a record-budget overflow corrupts the compressed path's last
    slot and can fill the post buffer spuriously.  One host read.  The
    flags are the same on every rank of a feed axis (reduced in the
    kernel); ``lane_sum`` adds them up over a lane axis."""
    flags = [wall_trunc, post_trunc] + ([rec_trunc] if rec_trunc is not None
                                        else [])
    with _telemetry.span("star.checks"):
        counts = torch.stack([f.reshape(-1).sum() for f in flags])
        if lane_sum is not None:
            counts = lane_sum(counts)
        counts = counts.tolist()
    n_wall, n_post = counts[0], counts[1]
    if rec_trunc is not None and counts[2]:
        raise RecordBudgetOverflow(
            "suffix-record budget overflow (a feed produced more "
            "right-to-left candidate minima than star_fire._rec_cap "
            "allows — the short-clock regime); retrying with compression "
            "off")
    if n_wall:
        raise RuntimeError(
            f"wall stream overflow ({n_wall} lane(s) hit wall_cap="
            f"{cfg.wall_cap} before the horizon) — raise StarConfig.wall_cap "
            f"(refusing to truncate silently)")
    if n_post:
        raise RuntimeError(
            f"posting buffer overflow ({n_post} lane(s) hit post_cap="
            f"{cfg.post_cap} before the horizon) — raise StarConfig.post_cap "
            f"(refusing to truncate silently)")


def _feed_axis_name(axis):
    """The kernel's collectives bind to the axis NAME ``"feed"``; any other
    name would skip the reduction and corrupt the results."""
    if axis != "feed":
        raise ValueError(f"the follower mesh axis must be named 'feed', got "
                         f"{axis!r} (kernel collectives bind to the name)")


def _check_divides(n: int, what: str, mesh, axis):
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{what}={n} not divisible by mesh axis "
                         f"{axis}={size}")


def _sharded_metrics(m: FeedMetrics, mesh, lane_axis, feed_axis, lane=None):
    """The kernel's per-feed metrics marked over the mesh: per-feed fields
    by ``(lane_axis, feed_axis)``, the window by ``lane_axis``; ``lane``
    picks one lane (the unbatched result)."""
    pick = (lambda x: x[lane]) if lane is not None else (lambda x: x)
    lead = () if lane is not None else (lane_axis,)
    per_feed = comm.P(*lead, feed_axis)
    window = comm.P(*lead)
    return ShardedFeedMetrics(
        *(comm.mark(pick(x), mesh, per_feed) for x in m[:4]),
        *(comm.mark(pick(x), mesh, window) for x in m[4:]))


def simulate_star(cfg: StarConfig, wall: WallParams, ctrl: CtrlParams,
                  seed, mesh: Optional[comm.Mesh] = None, axis: str = "feed",
                  metric_K: int = 1, fire_mode: str = "auto",
                  device: DeviceLike = "cuda") -> StarResult:
    """Simulate one star component to its horizon on ``device`` (the card
    by default).  ``seed`` is an integer or a key [2].  Raises on a
    wall-buffer or post-buffer overflow instead of truncating.

    With ``mesh``, the feeds split over the mesh axis ``axis`` (which must
    be named ``"feed"``; ``n_feeds`` must divide by its size): each rank
    samples and ranks its own feeds, and every post is the ``pmin`` of the
    ranks' candidates, so the result is bit-identical to the unsharded
    run (the streams key off GLOBAL feed indices).  ``own_times`` and
    ``n_posts`` are whole on every rank; ``wall_times``, ``wall_n`` and
    the per-feed metrics are marked as sharded, and
    ``metrics.mean_time_in_top_k()`` is the mean over every feed.  Every
    rank of the axis calls it.

    ``fire_mode``: ``"loop"``, ``"doubling"`` (unsharded only) or
    ``"auto"`` (doubling on the card, the loop on the CPU or on a sharded
    feed axis); the fires are the same bit for bit."""
    dev = resolve_device(device)
    _check_fire_mode(fire_mode, feed_sharded=mesh is not None)
    _check_wall_kinds(cfg, wall)
    wall, ctrl = wall.to(dev), ctrl.to(dev)
    wall_l = wall
    if mesh is not None:
        _feed_axis_name(axis)
        _check_divides(cfg.n_feeds, "n_feeds", mesh, axis)
        wall_l = comm.block(wall, mesh, comm.P(axis))
    wall_b = wall_l.map(lambda x: x[None])
    ctrl_b = ctrl.map(lambda x: x[None])
    seed = np.asarray(seed.detach().cpu() if isinstance(seed, torch.Tensor)
                      else seed)
    keys = _as_keys(seed[None], dev)

    streams = []   # sampled once: a retry reruns the fires and metrics

    def run(compress):
        fn = _get_fn(cfg, metric_K, compress, fire_mode, dev,
                     feed_sharded=mesh is not None)
        with (comm.bind(mesh) if mesh is not None
              else contextlib.nullcontext()):
            if not streams:
                streams.append(fn.walls(wall_b, keys))
            return fn.rest(streams[0], wall_b, ctrl_b)

    own, n_posts, feed_times, wall_n, metrics, *_ = _run_with_fallback(
        cfg, metric_K, ctrl_b, wall, run)
    if mesh is None:
        return StarResult(
            own_times=own[0], n_posts=int(n_posts[0]),
            wall_times=feed_times[0], wall_n=wall_n[0],
            metrics=FeedMetrics(*(x[0] for x in metrics)), cfg=cfg)
    return StarResult(
        own_times=own[0], n_posts=int(n_posts[0]),
        wall_times=comm.mark(feed_times[0], mesh, comm.P(axis, None)),
        wall_n=comm.mark(wall_n[0], mesh, comm.P(axis)),
        metrics=_sharded_metrics(metrics, mesh, None, axis, lane=0),
        cfg=cfg)


def stack_star(wall_list: Sequence[WallParams],
               ctrl_list: Sequence[CtrlParams]):
    """Stack same-shape star components along a leading batch axis; the
    parameters may differ, the shapes and the controlled kind may not."""
    w0, c0 = wall_list[0], ctrl_list[0]
    wall = WallParams(**{f: torch.stack([getattr(w, f) for w in wall_list])
                         for f in w0.__dataclass_fields__})
    ctrl = CtrlParams(**{
        f: (torch.stack([getattr(c, f) for c in ctrl_list])
            if isinstance(getattr(c0, f), torch.Tensor) else getattr(c0, f))
        for f in c0.__dataclass_fields__ if f != "rmtpp"},
        rmtpp=map_weights(lambda *ws: torch.stack(ws),
                          *(c.rmtpp for c in ctrl_list)))
    return wall, ctrl


def broadcast_star(wall: WallParams, ctrl: CtrlParams, B: int):
    """Tile ONE component to a [B]-lane batch without copies (lanes differ
    only by seed)."""
    return (wall.map(lambda x: x.expand((B,) + tuple(x.shape))),
            ctrl.map(lambda x: x.expand((B,) + tuple(x.shape))))


def simulate_star_batch(cfg: StarConfig, wall: WallParams, ctrl: CtrlParams,
                        seeds, mesh: Optional[comm.Mesh] = None,
                        axis: str = "data", feed_axis: Optional[str] = None,
                        metric_K: int = 1, fire_mode: str = "auto",
                        device: DeviceLike = "cuda") -> StarBatchResult:
    """Run B star components in lockstep on ``device`` (the card by
    default): ``wall``/``ctrl`` leaves carry a leading [B] (see
    :func:`stack_star` / :func:`broadcast_star`), ``seeds`` is an integer
    array [B] or a key array [B, 2].  Every lane's result equals its
    :func:`simulate_star` at the same seed.  Raises on any lane's buffer
    overflow, never truncates.

    With ``mesh``, the lanes split over ``axis``; with ``feed_axis`` (named
    ``"feed"``) as well, each lane's feeds split over it, the 2-D layout
    (lanes x followers) with the clock reduction riding ``pmin`` over the
    feed axis.  Every layout is bit-identical to the unsharded run.  The
    outputs are marked as sharded: ``own_times``/``n_posts`` over
    ``axis``, ``wall_n`` and the per-feed metrics over both."""
    dev = resolve_device(device)
    # The call's stages under names of the port's own (the JAX package's
    # star has no telemetry): the input checks and the overflow read
    # (``star.checks``), then the kernel's ``star.streams``,
    # ``star.fires`` and ``star.metrics``.
    with _telemetry.span("star.simulate_batch") as root:
        with _telemetry.span("star.checks"):
            keys = _as_keys(seeds, dev)
            B = keys.shape[0]
            if wall.kind.shape[0] != B:
                raise ValueError(
                    f"batch dims disagree: seeds={B}, "
                    f"wall={wall.kind.shape[0]}")
            if ctrl.q.dim() != 1 or ctrl.q.shape[0] != B:
                raise ValueError(
                    f"batch dims disagree: seeds={B}, ctrl="
                    f"{ctrl.q.shape[0] if ctrl.q.dim() else 'unbatched'} "
                    f"— build the batch with stack_star/broadcast_star")
            feed_sharded = mesh is not None and feed_axis is not None
            _check_fire_mode(fire_mode, feed_sharded=feed_sharded)
            _check_wall_kinds(cfg, wall)
            if feed_axis is not None:
                _feed_axis_name(feed_axis)
            wall, ctrl = wall.to(dev), ctrl.to(dev)
            wall_l, ctrl_l, keys_l, lane_sum = wall, ctrl, keys, None
            if mesh is not None:
                _check_divides(B, "batch", mesh, axis)
                if feed_sharded:
                    _check_divides(cfg.n_feeds, "n_feeds", mesh, feed_axis)
                wall_l = comm.block(wall, mesh, comm.P(axis, feed_axis))
                ctrl_l, keys_l = comm.block((ctrl, keys), mesh, comm.P(axis))

                def lane_sum(counts):
                    return comm.mesh_reduce(counts, mesh, "SUM", axis)
        root.set(lanes=B, feeds=cfg.n_feeds, fire_mode=_resolve_fire_mode(
            fire_mode, feed_sharded, dev))

        streams = []   # sampled once: a retry reruns the fires, metrics

        def run(compress):
            fn = _get_fn(cfg, metric_K, compress, fire_mode, dev,
                         feed_sharded=feed_sharded)
            with (comm.bind(mesh) if feed_sharded
                  else contextlib.nullcontext()):
                if not streams:
                    streams.append(fn.walls(wall_l, keys_l))
                return fn.rest(streams[0], wall_l, ctrl_l)

        own, n_posts, feed_times, wall_n, metrics, *_ = _run_with_fallback(
            cfg, metric_K, ctrl, wall, run, lane_sum)
    if mesh is None:
        return StarBatchResult(own_times=own, n_posts=n_posts,
                               wall_n=wall_n, metrics=metrics, cfg=cfg,
                               wall_times=feed_times)
    return StarBatchResult(
        own_times=comm.mark(own, mesh, comm.P(axis, None)),
        n_posts=comm.mark(n_posts, mesh, comm.P(axis)),
        wall_n=comm.mark(wall_n, mesh, comm.P(axis, feed_axis)),
        metrics=_sharded_metrics(metrics, mesh, axis, feed_axis), cfg=cfg,
        wall_times=comm.mark(feed_times, mesh, comm.P(axis, feed_axis,
                                                      None)))
