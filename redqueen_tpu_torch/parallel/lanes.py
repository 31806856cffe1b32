"""The lane layer: how a set of simulation lanes becomes dense dispatches,
the counterpart of ``redqueen_tpu.parallel.lanes``.

- **Bucketed ragged batching.**  A power-law follower graph has lane
  widths from 1 to thousands; padding every lane to the hub's width
  wastes almost the whole batch.  :func:`plan_buckets` groups lanes into
  a bounded number of power-of-two width buckets and
  :func:`simulate_ragged` dispatches each bucket densely, bit-identical
  per lane to the dense-padded plan (``max_buckets=1``) at the same
  seeds: every random stream depends only on (lane seed, source index,
  draw counter), never on the padded shape.
- **Measured slab auto-tuning.**  :func:`measured_slab` times candidate
  slab sizes once per (backend, shape) and keeps the winner in an
  ``rq.lanes.autotune/1`` JSON artifact; :func:`simulate_slabbed`
  (``sim.simulate_batch(..., slab=...)``) applies a slab with
  bit-identical results.  The port keys its entries by its own backend
  names (``torch.cuda``, ``torch.cpu``) and keeps its cache in its own
  file, so it never reads an entry the JAX package measured.
- **Pad-waste telemetry**: ``lanes.pad.*`` counters, ``lanes.*`` spans
  and ``lanes.bucket_plan`` events (``runtime.telemetry``).

``RQ_FAULT=numeric:mode@laneN`` addresses lane N of the caller's lane
order: :func:`simulate_ragged` translates it through its bucket
reordering (``runtime.faultinject.numeric_scope``), and health words
come back at the original positions."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..device import DeviceLike, resolve_device
from ..runtime import faultinject as _faultinject
from ..runtime import telemetry as _telemetry
from ..runtime.artifacts import atomic_write_json
from ..runtime.numerics import NumericalHealthError as _NumericalHealthError

__all__ = [
    "BucketPlan", "plan_buckets", "bucket_width", "pad_to_tile",
    "SlabChoice", "measured_slab", "slab_size", "iter_slabs",
    "simulate_slabbed", "dispatch_slabbed", "concat_slab_logs",
    "probe_slab_cost", "shape_budget", "ragged_bucket_component",
    "RaggedResult", "simulate_ragged", "AUTOTUNE_SCHEMA", "SLAB_CANDIDATES",
    "autotune_cache_path", "load_autotune_cache", "backend_name",
    "MIN_BUCKET_WIDTH",
]


# ---------------------------------------------------------------------------
# Width rounding & tile padding
# ---------------------------------------------------------------------------


def bucket_width(n: int, floor: int = 1, cap: Optional[int] = None) -> int:
    """Padded width for a group of true width ``n``: the next power of
    two at or above ``max(n, floor)``, clamped to ``cap``."""
    n = int(n)
    if n < 0:
        raise ValueError(f"width must be >= 0, got {n}")
    m = max(n, int(floor), 1)
    w = 1 << (m - 1).bit_length()
    if cap is not None:
        if n > int(cap):
            raise ValueError(
                f"true width {n} exceeds the cap {cap} — the caller's "
                f"fixed dispatch budget cannot hold this group")
        w = min(w, int(cap))
    return w


def pad_to_tile(n: int, tile: int) -> int:
    """Lanes padded to a whole number of tiles, with the occupancy
    counters."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    padded = -(-int(n) // int(tile)) * int(tile)
    _telemetry.counter("lanes.pad.real_lanes", int(n))
    _telemetry.counter("lanes.pad.padded_lanes", padded - int(n))
    if padded != n:
        _telemetry.event("lanes.tile_pad", lanes=int(n), padded=padded,
                         tile=int(tile),
                         occupancy=round(int(n) / padded, 4))
    return padded


# ---------------------------------------------------------------------------
# Bucket planning
# ---------------------------------------------------------------------------


class BucketPlan(NamedTuple):
    """A bounded bucketing of ragged lane widths: ``widths`` the padded
    bucket widths (ascending), ``lane_bucket`` each original lane's bucket
    (the smallest width that holds it), ``counts`` the true widths and
    ``dense_width`` the one-bucket plan's width."""

    widths: Tuple[int, ...]
    lane_bucket: np.ndarray      # i64[B]
    counts: np.ndarray           # i64[B]
    dense_width: int

    def lanes_of(self, b: int) -> np.ndarray:
        """Original lane indices of bucket ``b``, in original order."""
        return np.flatnonzero(self.lane_bucket == b)

    @property
    def n_buckets(self) -> int:
        return len(self.widths)

    @property
    def real_elems(self) -> int:
        return int(self.counts.sum())

    @property
    def bucketed_elems(self) -> int:
        w = np.asarray(self.widths, np.int64)
        return int(w[self.lane_bucket].sum())

    @property
    def dense_elems(self) -> int:
        return int(self.dense_width) * len(self.counts)

    @property
    def pad_frac_bucketed(self) -> float:
        b = self.bucketed_elems
        return (b - self.real_elems) / b if b else 0.0

    @property
    def pad_frac_dense(self) -> float:
        d = self.dense_elems
        return (d - self.real_elems) / d if d else 0.0

    @property
    def padded_elem_reduction(self) -> float:
        """Fraction of the dense plan's wasted elements this plan saves."""
        dw = self.dense_elems - self.real_elems
        bw = self.bucketed_elems - self.real_elems
        return (dw - bw) / dw if dw else 0.0


#: Smallest bucket width the planner emits: the JAX package floors it at
#: 2 because XLA's width-1 shapes take a scalar math path whose rounding
#: differs by an ulp; the port keeps the same plan so that both packages
#: bucket lanes alike.
MIN_BUCKET_WIDTH = 2


def plan_buckets(counts: Sequence[int], max_buckets: int = 8) -> BucketPlan:
    """Group ragged lane widths into at most ``max_buckets`` power-of-two
    width buckets (floored at :data:`MIN_BUCKET_WIDTH`), merging the
    adjacent pair that adds the least padding until the bound holds.
    ``max_buckets=1`` is the dense-padded plan."""
    counts = np.asarray(counts, np.int64)
    if counts.ndim != 1 or counts.size == 0:
        raise ValueError(
            f"counts must be a non-empty 1-D array, got shape "
            f"{counts.shape}")
    if (counts < 1).any():
        i = int(np.flatnonzero(counts < 1)[0])
        raise ValueError(
            f"lane widths must be >= 1, got {counts[i]} at lane {i}")
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    m = np.maximum(counts, MIN_BUCKET_WIDTH)
    mant, e = np.frexp(m.astype(np.float64))
    ceil = np.where(mant == 0.5, m,
                    np.int64(1) << e.astype(np.int64)).astype(np.int64)
    widths, n_lanes = np.unique(ceil, return_counts=True)
    widths = [int(w) for w in widths]
    n_lanes = [int(n) for n in n_lanes]
    while len(widths) > max_buckets:
        costs = [n_lanes[i] * (widths[i + 1] - widths[i])
                 for i in range(len(widths) - 1)]
        i = int(np.argmin(costs))
        n_lanes[i + 1] += n_lanes[i]
        del widths[i], n_lanes[i]
    dense = int(max(widths))
    lane_bucket = np.searchsorted(np.asarray(widths, np.int64), ceil,
                                  side="left")
    plan = BucketPlan(widths=tuple(widths), lane_bucket=lane_bucket,
                      counts=counts, dense_width=dense)
    _telemetry.event("lanes.bucket_plan", n_buckets=plan.n_buckets,
                     lanes=len(counts), dense_width=dense,
                     pad_frac_bucketed=round(plan.pad_frac_bucketed, 4),
                     pad_frac_dense=round(plan.pad_frac_dense, 4))
    return plan


# ---------------------------------------------------------------------------
# Measured slab auto-tuning
# ---------------------------------------------------------------------------

#: Envelope schema of the autotune cache artifact.
AUTOTUNE_SCHEMA = "rq.lanes.autotune/1"

#: Candidate slab targets the first-use measurement times.
SLAB_CANDIDATES = (1250, 2500, 5000)

ENV_AUTOTUNE_PATH = "RQ_LANES_AUTOTUNE"


def backend_name(device: DeviceLike) -> str:
    """The port's autotune backend name for ``device``: ``torch.cuda`` or
    ``torch.cpu``, never a name the JAX package writes."""
    return f"torch.{torch.device(device).type}"


def autotune_cache_path() -> str:
    """``$RQ_LANES_AUTOTUNE`` when set, else the port's per-user cache
    file ``~/.cache/redqueen_tpu_torch/lanes_autotune.json``."""
    env = os.environ.get(ENV_AUTOTUNE_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "redqueen_tpu_torch", "lanes_autotune.json")


def load_autotune_cache(path: Optional[str] = None) -> Dict[str, dict]:
    """The cache's ``entries`` (``"backend|shape_key" -> entry``); a
    missing, torn or foreign-schema file reads as empty."""
    path = path or autotune_cache_path()
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(obj, dict) or obj.get("schema") != AUTOTUNE_SCHEMA:
        return {}
    entries = obj.get("entries")
    return entries if isinstance(entries, dict) else {}


def _store_autotune(path: str, key: str, entry: dict) -> None:
    entries = load_autotune_cache(path)
    entries[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write_json(path, {"schema": AUTOTUNE_SCHEMA, "entries": entries})


def slab_size(B: int, target: int) -> int:
    """Largest divisor of ``B`` in (target/2, target]; ``B`` itself when no
    divisor lands there (equal slabs only)."""
    B, target = int(B), int(target)
    if target >= B:
        return B
    for s in range(target, target // 2, -1):
        if B % s == 0:
            return s
    return B


def iter_slabs(B: int, slab: int):
    """``(start, stop)`` lane ranges covering ``[0, B)`` in ``slab``-sized
    pieces (the last may be short)."""
    B, slab = int(B), int(slab)
    if slab < 1:
        raise ValueError(f"slab must be >= 1, got {slab}")
    for s0 in range(0, B, slab):
        yield s0, min(s0 + slab, B)


class SlabChoice(NamedTuple):
    """A slab decision and where it came from: ``"measured"``,
    ``"cache"``, ``"fallback"`` (the median candidate), ``"unslabbed"`` or
    ``"caller"``; ``measurements`` maps target -> per-lane cost when
    measured now."""

    slab: int
    target: int
    source: str
    measurements: Dict[int, float]


def _choice_from_entries(entries: Dict[str, dict], B: int, *,
                         backend: str, shape_key: str):
    entry = entries.get(f"{backend}|{shape_key}")
    if entry and isinstance(entry.get("target"), int):
        target = int(entry["target"])
        return SlabChoice(slab_size(int(B), target), target, "cache", {})
    return None


def measured_slab(B: int, *, backend: str, shape_key: str,
                  time_fn: Optional[Callable[[int], float]] = None,
                  candidates: Sequence[int] = SLAB_CANDIDATES,
                  cache_path: Optional[str] = None,
                  force: bool = False) -> SlabChoice:
    """The slab size for a ``B``-lane batch on ``backend``, measured.

    First use per ``(backend, shape_key)``: ``time_fn(slab)`` for each
    distinct candidate slab, the cheapest kept and recorded in the cache
    at ``cache_path``.  Later calls reuse it (``force=True`` re-measures).
    Without ``time_fn`` and without an entry: the median candidate,
    ``source="fallback"``."""
    B = int(B)
    cands = sorted({int(c) for c in candidates})
    if not cands or any(c < 1 for c in cands):
        raise ValueError(f"candidates must be positive, got {candidates}")
    if B <= cands[0]:
        return SlabChoice(B, B, "unslabbed", {})
    key = f"{backend}|{shape_key}"
    path = cache_path or autotune_cache_path()
    if not force:
        choice = _choice_from_entries(load_autotune_cache(path), B,
                                      backend=backend, shape_key=shape_key)
        if choice is not None:
            return choice
    if time_fn is None:
        target = cands[len(cands) // 2]
        return SlabChoice(slab_size(B, target), target, "fallback", {})
    with _telemetry.span("lanes.autotune", backend=backend,
                         shape_key=shape_key, lanes=B) as sp:
        measurements: Dict[int, float] = {}
        by_slab: Dict[int, int] = {}
        for target in cands:
            by_slab.setdefault(slab_size(B, target), target)
        for slab, target in by_slab.items():
            measurements[target] = float(time_fn(slab))
        best_target = min(measurements, key=measurements.get)
        sp.set(winner=best_target, measurements=measurements)
    _store_autotune(path, key, {
        "target": int(best_target),
        "per_lane_cost": {str(t): measurements[t] for t in measurements},
        "lanes": B,
        "candidates": cands,
    })
    return SlabChoice(slab_size(B, best_target), int(best_target),
                      "measured", dict(measurements))


# ---------------------------------------------------------------------------
# Slab dispatch
# ---------------------------------------------------------------------------


def _pad_log_width(times, srcs, width: int):
    pad = width - times.shape[-1]
    if pad == 0:
        return times, srcs
    return (torch.nn.functional.pad(times, (0, pad), value=float("inf")),
            torch.nn.functional.pad(srcs, (0, pad), value=-1))


def _slice_params(params, s0: int, s1: int):
    import dataclasses

    from ..config import PARAM_FIELDS
    from ..models.base import map_weights

    return dataclasses.replace(
        params, rmtpp=map_weights(lambda w: w[s0:s1], params.rmtpp),
        **{f: getattr(params, f)[s0:s1] for f in PARAM_FIELDS})


def dispatch_slabbed(cfg, params, adj, seeds, slab: int, *,
                     max_chunks: int = 100, sync_every: int = 8,
                     max_events=None, engine: str = "scan",
                     dispatch: Optional[Callable] = None,
                     device: DeviceLike = "cuda"):
    """Run the [B]-lane batch as consecutive ``slab``-lane dispatches and
    return the per-slab ``EventLog`` list, not yet concatenated.

    ``dispatch(cfg, params, adj, seeds) -> EventLog`` replaces the
    per-slab dispatch (a bench closes its own options over it); the
    default is ``sim.simulate_batch`` with the keyword options here."""
    if dispatch is None:
        from ..sim import simulate_batch

        def dispatch(c, p, a, s):
            return simulate_batch(c, p, a, s, max_chunks=max_chunks,
                                  sync_every=sync_every,
                                  max_events=max_events, engine=engine,
                                  device=device)

    seeds_np = np.asarray(seeds.detach().cpu()
                          if isinstance(seeds, torch.Tensor) else seeds)
    B = int(seeds_np.shape[0])
    slab = int(slab)
    logs = []
    with _telemetry.span("lanes.slab", lanes=B, slab=slab) as sp:
        for s0, s1 in iter_slabs(B, slab):
            logs.append(dispatch(cfg, _slice_params(params, s0, s1),
                                 adj[s0:s1], seeds_np[s0:s1]))
        sp.set(dispatches=sum(lg.dispatches or 0 for lg in logs))
    _telemetry.counter("lanes.slab.dispatches", len(logs))
    return logs


def concat_slab_logs(cfg, logs):
    """Merge per-slab ``EventLog``s into one batch log; shorter slabs are
    padded with (+inf, -1), and ``chunk_steps`` keeps the summed step
    count."""
    if len(logs) == 1:
        out = logs[0]
        out.chunk_steps = out.times.shape[-1]
        return out
    from ..sim import EventLog

    width = max(lg.times.shape[-1] for lg in logs)
    padded = [_pad_log_width(lg.times, lg.srcs, width) for lg in logs]
    out = EventLog(
        torch.cat([t for t, _ in padded], 0),
        torch.cat([s for _, s in padded], 0),
        torch.cat([torch.atleast_1d(lg.n_events) for lg in logs]),
        cfg,
        health=torch.cat([torch.atleast_1d(lg.health) for lg in logs])
        if logs[0].health is not None else None,
        dispatches=sum(lg.dispatches or 0 for lg in logs),
        engine=logs[0].engine,
        engine_reason=next(
            (lg.engine_reason for lg in logs if lg.engine_reason), None))
    out.chunk_steps = sum(lg.times.shape[-1] for lg in logs)
    return out


def simulate_slabbed(cfg, params, adj, seeds, slab: int, *,
                     max_chunks: int = 100, sync_every: int = 8,
                     max_events=None, engine: str = "scan",
                     dispatch: Optional[Callable] = None,
                     device: DeviceLike = "cuda"):
    """Dispatch a [B]-lane batch as consecutive ``slab``-lane dispatches
    with bit-identical per-lane results, as one concatenated
    ``EventLog``; ``dispatch`` as in :func:`dispatch_slabbed`.  A fully
    sick slab raises ``NumericalHealthError`` even if another slab is
    healthy."""
    return concat_slab_logs(cfg, dispatch_slabbed(
        cfg, params, adj, seeds, slab, max_chunks=max_chunks,
        sync_every=sync_every, max_events=max_events, engine=engine,
        dispatch=dispatch, device=device))


def probe_slab_cost(run: Callable[[], object], n: int) -> float:
    """The ``time_fn`` body for :func:`measured_slab`: one warm call of
    ``run()`` (an ``n``-lane dispatch returning an ``EventLog``), one
    timed call ending in a device sync; seconds per lane."""
    lg = run()
    _device.host_read(lg.n_events.sum())
    t0 = time.perf_counter()
    lg = run()
    _device.host_read(lg.n_events.sum())
    return (time.perf_counter() - t0) / int(n)


# ---------------------------------------------------------------------------
# Bucketed ragged dispatch
# ---------------------------------------------------------------------------


def ragged_bucket_component(counts, width: int, *, end_time: float,
                            q: float = 1.0, wall_rate: float = 1.0,
                            capacity: int = 256, start_time: float = 0.0,
                            device: DeviceLike = "cuda"):
    """One bucket's dense batch, built vectorised: per lane, source 0 is
    the Opt broadcaster and sources 1..width Poisson walls on sinks
    0..width-1; wall j runs at ``wall_rate`` when j < counts[i] and at
    rate 0 (never fires) otherwise, as ``GraphBuilder`` pads.  The Opt row
    follows only the lane's real feeds.  Returns ``(cfg, params [B_b],
    adj [B_b])`` on ``device``."""
    from ..config import SimConfig, SourceParams
    from ..models.base import KIND_OPT, KIND_POISSON

    dev = resolve_device(device)
    counts = np.asarray(counts, np.int64)
    width = int(width)
    if (counts < 1).any() or (counts > width).any():
        raise ValueError(
            f"bucket of width {width} holds counts in "
            f"[{counts.min()}, {counts.max()}] — every lane must satisfy "
            f"1 <= count <= width")
    Bb, S, F = len(counts), width + 1, width
    kind = np.zeros((Bb, S), np.int32)
    kind[:, 0] = KIND_OPT
    kind[:, 1:] = KIND_POISSON
    real = np.arange(F)[None, :] < counts[:, None]       # [Bb, F]
    rate = np.ones((Bb, S), np.float64)
    rate[:, 1:] = np.where(real, float(wall_rate), 0.0)
    q_arr = np.ones((Bb, S), np.float64)
    q_arr[:, 0] = float(q)
    adj = np.zeros((Bb, S, F), bool)
    adj[:, 0, :] = real
    adj[:, 1:, :] = np.eye(F, dtype=bool)[None]
    pw_t = np.full((Bb, S, 1), np.inf)
    pw_t[:, :, 0] = 0.0
    cfg = SimConfig(
        n_sources=S, n_sinks=F, end_time=float(end_time),
        start_time=float(start_time), capacity=int(capacity),
        rmtpp_hidden=1,
        present_kinds=tuple(sorted({KIND_POISSON, KIND_OPT})),
        opt_rows=(0,))

    def t(x, dt=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(dev, dt)

    params = SourceParams(
        kind=t(kind, torch.int32), rate=t(rate),
        l0=torch.ones((Bb, S), device=dev),
        alpha=torch.zeros((Bb, S), device=dev),
        beta=torch.ones((Bb, S), device=dev),
        pw_times=t(pw_t), pw_rates=torch.zeros((Bb, S, 1), device=dev),
        rd_times=torch.full((Bb, S, 1), float("inf"), device=dev),
        q=t(q_arr), s_sink=torch.ones((Bb, F), device=dev))
    return cfg, params, t(adj, torch.bool)


def shape_budget(width: int, end_time: float, wall_rate: float,
                 capacity: Optional[int] = None):
    """``(capacity, max_chunks)`` for a broadcaster component of ``width``
    Poisson-feed followers: chunk capacity ~mean_events/16 (a power of
    two clamped to [64, 2048]) unless the caller pins one, and a ~4x
    event-count chunk allowance floored at 64."""
    mean_ev = end_time * wall_rate * width * 1.25
    if capacity is None:
        capacity = int(min(2048, max(
            64, 1 << int(np.log2(max(mean_ev / 16, 1)) + 0.5))))
    max_chunks = max(64, int(4 * mean_ev / capacity) + 1)
    return int(capacity), int(max_chunks)


class RaggedResult(NamedTuple):
    """Per-lane summaries of a bucketed ragged dispatch, host numpy in the
    caller's lane order; ``logs`` (with ``return_logs=True``) holds each
    lane's ``(times, srcs)`` trimmed to its valid events."""

    n_events: np.ndarray       # i64[B]
    top_k: np.ndarray          # f64[B] mean time-in-top-K over real feeds
    #                            (summed in float64)
    posts: np.ndarray          # f64[B] broadcaster posts
    health: np.ndarray         # u32[B] lane-health word
    plan: BucketPlan
    dispatches: int
    engine: str
    logs: Optional[List[Tuple[np.ndarray, np.ndarray]]]

    @property
    def events(self) -> int:
        return int(self.n_events.sum())


def simulate_ragged(counts, seeds, *, end_time: float, q: float = 1.0,
                    wall_rate: float = 1.0, engine: str = "scan",
                    max_buckets: int = 8, capacity: Optional[int] = None,
                    sync_every: int = 8, slab_target: Optional[int] = None,
                    max_lane_elems: int = 32_000_000, metric_K: int = 1,
                    cache_path: Optional[str] = None,
                    return_logs: bool = False,
                    device: DeviceLike = "cuda") -> RaggedResult:
    """Simulate ``B`` ragged broadcaster components (1 Opt against
    ``counts[i]`` Poisson-feed followers) as at most ``max_buckets`` dense
    bucket dispatches on ``device`` (the card by default), each bucket in
    slabs (the autotune cache's target for the backend and width, or
    ``slab_target``; ``max_lane_elems`` bounds a slab's lanes x width²).

    Per-lane results are bit-identical to the dense-padded plan
    (``max_buckets=1``) at the same seeds.  ``engine`` goes to
    ``sim.simulate_batch`` (``"scan"``, ``"fused"`` or ``"auto"``).
    ``RQ_FAULT=numeric:*@laneN`` addresses lane N of the caller's order."""
    from ..sim import simulate_batch
    from ..utils.metrics import feed_metrics_batch, num_posts

    dev = resolve_device(device)
    counts = np.asarray(counts, np.int64)
    seeds = np.asarray(seeds)
    if seeds.ndim != 1 or len(seeds) != len(counts):
        raise ValueError(
            f"seeds must be 1-D with one entry per lane, got "
            f"{seeds.shape} for {len(counts)} lanes")
    plan = plan_buckets(counts, max_buckets=max_buckets)
    B = len(counts)
    # The numeric fault is resolved once against the original lane order.
    fault_site = _faultinject.active_numeric_lane(B)
    fault_chunk = _faultinject.numeric_scope_ctx()[0]
    fault_lane = fault_site[0] if fault_site is not None else None
    abs_lane = (_faultinject.numeric_fault().lane
                if fault_site is not None else None)

    n_events = np.zeros(B, np.int64)
    top_k = np.zeros(B, np.float64)
    posts = np.zeros(B, np.float64)
    health = np.zeros(B, np.uint32)
    logs: Optional[list] = [None] * B if return_logs else None
    dispatches = 0
    engine_used = engine
    if slab_target is None:
        backend = backend_name(dev)
        at_entries = load_autotune_cache(cache_path)
    else:
        backend, at_entries = None, {}

    with _telemetry.span("lanes.ragged", lanes=B, n_buckets=plan.n_buckets,
                         pad_frac=round(plan.pad_frac_bucketed, 4)):
        for b, width in enumerate(plan.widths):
            idx = plan.lanes_of(b)
            if idx.size == 0:
                continue
            cap_b, max_chunks = shape_budget(width, end_time, wall_rate,
                                             capacity)
            real_e = int(counts[idx].sum())
            _telemetry.counter("lanes.pad.real_elems", real_e)
            _telemetry.counter("lanes.pad.padded_elems",
                               width * idx.size - real_e)
            if slab_target is None:
                choice = _choice_from_entries(
                    at_entries, int(idx.size), backend=backend,
                    shape_key=f"ragged/W{width}")
                if choice is None and dev.type == "cpu":
                    target = sorted(SLAB_CANDIDATES)[
                        len(SLAB_CANDIDATES) // 2]
                    choice = SlabChoice(slab_size(int(idx.size), target),
                                        target, "fallback", {})
                elif choice is None:
                    # The fallback candidates are CPU cache-locality
                    # numbers: on the card, with no measured entry, the
                    # bucket runs whole (the memory ceiling still holds).
                    choice = SlabChoice(int(idx.size), int(idx.size),
                                        "unslabbed", {})
            else:
                choice = SlabChoice(slab_size(int(idx.size), int(slab_target)),
                                    int(slab_target), "caller", {})
            slab = max(1, min(choice.slab,
                              max_lane_elems // max(width * width, 1)))
            # Equal slabs where a divisor allows, never above the ceiling.
            eq = slab_size(int(idx.size), slab)
            slab = eq if eq <= slab else slab
            with _telemetry.span("lanes.ragged.bucket", width=width,
                                 lanes=int(idx.size), slab=slab) as bsp:
                for s0, s1 in iter_slabs(idx.size, slab):
                    oi = idx[s0:s1]
                    cfg, params, adj = ragged_bucket_component(
                        counts[oi], width, end_time=end_time, q=q,
                        wall_rate=wall_rate, capacity=cap_b, device=dev)
                    kwargs = dict(max_chunks=max_chunks,
                                  sync_every=sync_every, engine=engine,
                                  device=dev)
                    try:
                        with _fault_scope(oi, fault_lane, abs_lane,
                                          fault_chunk):
                            log = simulate_batch(cfg, params, adj, seeds[oi],
                                                 **kwargs)
                    except _NumericalHealthError as e:
                        # Every lane of this slab died: keep the words at
                        # their original positions (metrics stay zero) and
                        # the other slabs' results.
                        health[oi] = np.asarray(e.health).astype(np.uint32)
                        dispatches += 1
                        continue
                    dispatches += log.dispatches or 1
                    engine_used = log.engine
                    m = feed_metrics_batch(log.times, log.srcs, adj, 0,
                                           end_time, K=metric_K)
                    # The mean over a lane's real feeds in float64: a
                    # float32 sum over the padded width would associate by
                    # the bucket's width on the card.
                    top = ((m.time_in_top_k.double() * m.follows).sum(-1)
                           / torch.clamp(m.follows.sum(-1), min=1))
                    # The slab's one results boundary: reduced per-lane
                    # vectors cross to the host here, never events.
                    red = torch.stack([
                        log.n_events.double(), top,
                        num_posts(log.srcs, 0).double(),
                        (log.health if log.health is not None
                         else torch.zeros_like(log.n_events)).double()])
                    red = np.asarray(_device.host_read(red))
                    n_events[oi] = red[0].astype(np.int64)
                    top_k[oi] = red[1]
                    posts[oi] = red[2]
                    health[oi] = red[3].astype(np.uint32)
                    if logs is not None:
                        t_np = log.times.cpu().numpy()
                        s_np = log.srcs.cpu().numpy()
                        for j, lane in enumerate(oi):
                            ne = int(n_events[lane])
                            logs[lane] = (t_np[j, :ne].copy(),
                                          s_np[j, :ne].copy())
                bsp.set(dispatches=dispatches)
    return RaggedResult(n_events=n_events, top_k=top_k, posts=posts,
                        health=health, plan=plan, dispatches=dispatches,
                        engine=engine_used, logs=logs)


def _fault_scope(oi, fault_lane, abs_lane, fault_chunk):
    """The numeric-fault scope of one bucket slab: ``lane_base`` maps the
    spec's absolute lane onto the slab's local position of the addressed
    original lane, or out of range for a slab without it."""
    if fault_lane is None:
        return contextlib.nullcontext()
    pos = np.flatnonzero(oi == fault_lane)
    base = (int(abs_lane) - int(pos[0]) if pos.size
            else int(abs_lane) + len(oi) + 1)
    return _faultinject.numeric_scope(chunk=fault_chunk, lane_base=base)
