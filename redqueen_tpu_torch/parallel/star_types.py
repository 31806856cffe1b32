"""Shared types of the star engine (``parallel/bigf.py`` has the engine's
design): the static config, the parameter dataclasses of tensors, the
result containers and the overflow exception — the counterpart of
``redqueen_tpu.parallel.star_types``."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.base import KIND_OPT, map_weights
from ..utils.metrics import FeedMetrics

__all__ = ["StarConfig", "WallParams", "CtrlParams", "StarResult",
           "StarBatchResult", "RecordBudgetOverflow", "ShardedFeedMetrics",
           "_EMPTY",
           "WALL_FIELDS", "CTRL_FIELDS"]

_EMPTY = -1  # wall-slot kind code for "no source in this slot"


@dataclasses.dataclass(frozen=True)
class StarConfig:
    """Static shape of a star component (frozen and hashable: it keys the
    kernel cache and the compression blocklist)."""

    n_feeds: int
    walls_per_feed: int
    end_time: float
    start_time: float = 0.0
    wall_cap: int = 256    # events per wall source
    post_cap: int = 1024   # controlled-broadcaster posts
    ctrl_kind: int = KIND_OPT
    rmtpp_hidden: int = 1
    wall_kinds: tuple = ()  # kinds present in wall slots


#: WallParams tensor fields, in declaration order.
WALL_FIELDS = ("kind", "rate", "l0", "alpha", "beta", "pw_times",
               "pw_rates", "rd_times", "s_sink")
#: CtrlParams tensor fields that are always present.
CTRL_FIELDS = ("q", "rate", "pw_times", "pw_rates", "rd_times")
_CTRL_OPTIONAL = ("l0", "alpha", "beta")


@dataclasses.dataclass(frozen=True)
class WallParams:
    """Wall-source parameters on ``[F, M]`` grids (a leading ``[B]`` when
    batched); slot kind ``_EMPTY`` marks unused slots."""

    kind: torch.Tensor      # i32[F, M]
    rate: torch.Tensor      # f[F, M]
    l0: torch.Tensor        # f[F, M]
    alpha: torch.Tensor     # f[F, M]
    beta: torch.Tensor      # f[F, M]
    pw_times: torch.Tensor  # f[F, M, Kp]
    pw_rates: torch.Tensor  # f[F, M, Kp]
    rd_times: torch.Tensor  # f[F, M, Kr]
    s_sink: torch.Tensor    # f[F] follower significance

    def to(self, device: DeviceLike) -> "WallParams":
        dev = resolve_device(device)
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dev) for f in WALL_FIELDS})

    def map(self, fn) -> "WallParams":
        return WallParams(**{f: fn(getattr(self, f)) for f in WALL_FIELDS})


@dataclasses.dataclass(frozen=True)
class CtrlParams:
    """Controlled-broadcaster parameters: scalars and rows (a leading
    ``[B]`` when batched)."""

    q: torch.Tensor          # f[] Opt posting cost
    rate: torch.Tensor       # f[] Poisson rate
    pw_times: torch.Tensor   # f[Kp] piecewise knots
    pw_rates: torch.Tensor   # f[Kp]
    rd_times: torch.Tensor   # f[Kr] replay timestamps
    l0: Optional[torch.Tensor] = None     # f[] Hawkes base rate
    alpha: Optional[torch.Tensor] = None  # f[] Hawkes jump
    beta: Optional[torch.Tensor] = None   # f[] Hawkes decay
    rmtpp: Optional[dict] = None          # RMTPP weight tree

    def _fields(self):
        return CTRL_FIELDS + tuple(f for f in _CTRL_OPTIONAL
                                   if getattr(self, f) is not None)

    def to(self, device: DeviceLike) -> "CtrlParams":
        dev = resolve_device(device)
        return self.map(lambda x: x.to(dev))

    def map(self, fn) -> "CtrlParams":
        """``fn`` over every tensor, the RMTPP weights' leaves too."""
        return dataclasses.replace(
            self, rmtpp=map_weights(fn, self.rmtpp),
            **{f: fn(getattr(self, f)) for f in self._fields()})


class StarResult(NamedTuple):
    """Result of one star simulation, tensors on the run's device:
    ``own_times`` [post_cap] ascending +inf-padded; ``wall_times``
    [F, M*wall_cap] per-feed merged ascending +inf-padded; ``wall_n`` [F]
    valid wall events per feed; ``metrics`` per-feed ``FeedMetrics`` over
    [start, T]."""

    own_times: torch.Tensor
    n_posts: int
    wall_times: torch.Tensor
    wall_n: torch.Tensor
    metrics: FeedMetrics
    cfg: StarConfig


class StarBatchResult(NamedTuple):
    """Result of a batched star run: tensors with a leading [B] axis
    (``metrics`` holds [B, F] tensors).  ``wall_times`` [B, F,
    M*wall_cap], each lane's per-feed merged ascending +inf-padded wall
    events as ``StarResult`` has them, is the port's addition (last, so
    that the reference's fields keep their places)."""

    own_times: torch.Tensor   # [B, post_cap]
    n_posts: torch.Tensor     # [B]
    wall_n: torch.Tensor      # [B, F]
    metrics: FeedMetrics
    cfg: StarConfig
    wall_times: Optional[torch.Tensor] = None   # [B, F, M*wall_cap]


class RecordBudgetOverflow(RuntimeError):
    """The compressed fire path's per-feed suffix-record budget overflowed
    (the short-clock regime; see ``star_fire._rec_cap``).
    ``simulate_star``/``_batch`` catch it and retry with compression off:
    the results are exact either way."""


class ShardedFeedMetrics(FeedMetrics):
    """``FeedMetrics`` of a sharded star run: the per-feed fields are
    marked as sharded (``comm.mark``) over the lane and feed axes, and the
    means reduce across ranks.  A mean over feeds is the GLOBAL mean over
    every feed, summed and counted across the ranks that split the feed
    dimension (never a mean of the ranks' means); a lane-sharded result
    stays marked over the lane axis."""

    __slots__ = ()

    def _feed_mean(self, x):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from . import comm

        follows = comm.local(self.follows)
        num = (comm.local(x) * follows).sum(-1)
        n = follows.sum(-1)
        if not comm.is_sharded(x):
            return num / torch.clamp(n, min=1)
        last = x.dim() - 1
        placements = list(x.placements)
        for mdim, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == last:
                group = x.device_mesh.get_group(mesh_dim=mdim)
                num = comm._all_reduce(num, "SUM", group, "psum")
                n = comm._all_reduce(n, "SUM", group, "psum")
                placements[mdim] = Replicate()
        out = num / torch.clamp(n, min=1)
        if all(isinstance(p, Replicate) for p in placements):
            return out
        return DTensor.from_local(out, x.device_mesh, placements,
                                  run_check=False)

    def mean_time_in_top_k(self):
        return self._feed_mean(self.time_in_top_k)

    def mean_average_rank(self):
        from . import comm

        m = self._feed_mean(self.int_rank)
        span = comm.local(self.end_time) - comm.local(self.start_time)
        if not comm.is_sharded(m):
            return m / span
        return type(m).from_local(m.to_local() / span, m.device_mesh,
                                  m.placements, run_check=False)

    def mean_int_rank2(self):
        """int r^2 dt, mean over the followed feeds."""
        return self._feed_mean(self.int_rank2)
