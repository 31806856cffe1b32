"""The star engine: ONE controlled broadcaster against a large follower
set (BASELINE configs 2 and 4: one broadcaster against 1k Hawkes feeds
or 100k replay feeds), the counterpart of ``redqueen_tpu.parallel.bigf``.

The batch engines replay the global event loop one event per step; at
F = 100k followers that loop is hopeless.  The star engine has no event
loop, and is exact by construction:

1. Wall sources never react to anything, so every feed's wall stream
   samples on its own (``star_streams``, ``ops/streams.py``).
2. Each wall event m at t_m in feed f starts one RedQueen clock
   c_m = t_m + Exp(sqrt(s_f / q)), alive until the broadcaster's next
   post.  Every clock has c_m > t_m, so the k+1-th post is
   min{c_m : t_m > post_k}: a suffix-minimum query over the candidates
   sorted by wall time.  One exponential per wall event (the reference's
   draw count), one sort, one reverse running minimum, then a loop of
   ``searchsorted`` lookups or pointer doubling (``star_fire``).
3. The feed-rank metrics come in closed form from the sorted walls and
   posts (``star_metrics``).

A controlled broadcaster other than Opt (Poisson, piecewise, Hawkes,
replay) depends only on its own history, so its stream samples directly
and step 2 is skipped.  Overflow of a wall or post buffer raises.

This module is the import surface; the code lives in ``star_types``,
``star_streams``, ``star_fire``, ``star_metrics``, ``star_run`` and
``star_builder``.  Every tensor is PyTorch on the run's device.  With a
mesh (``parallel.comm``), the lanes split over a batch axis and each
lane's feeds over the ``"feed"`` axis: every rank samples and ranks its
own feeds, and each post is the ``pmin`` of the ranks' candidates."""

from __future__ import annotations

# ruff: noqa: F401  — re-export surface
from .star_builder import StarBuilder, star_to_dataframe
from .star_fire import (
    _FIRE_MODES,
    _check_fire_mode,
    _fires_by_doubling,
    _fires_by_loop,
    _opt_fires,
    _rec_cap,
    _resolve_fire_mode,
)
from .star_metrics import (
    _METRIC_FEED_BLOCK,
    _feed_metrics_star,
    _feed_metrics_star_scan,
)
from .star_run import (
    _COMPRESS_BLOCKLIST,
    _FN_CACHE,
    _check_overflow,
    _get_fn,
    _make_kernel,
    _regime_key,
    _run_with_fallback,
    broadcast_star,
    simulate_star,
    simulate_star_batch,
    stack_star,
)
from .star_streams import (
    _check_wall_kinds,
    _ctrl_stream,
    _wall_branches,
    _wall_streams,
)
from .star_types import (
    _EMPTY,
    CtrlParams,
    RecordBudgetOverflow,
    ShardedFeedMetrics,
    StarBatchResult,
    StarConfig,
    StarResult,
    WallParams,
)

__all__ = [
    "StarConfig",
    "WallParams",
    "CtrlParams",
    "StarBuilder",
    "StarResult",
    "StarBatchResult",
    "simulate_star",
    "simulate_star_batch",
    "stack_star",
    "broadcast_star",
    "star_to_dataframe",
]
