"""Event-log adapters: every event source the port produces → one fit
format (the counterpart of the JAX package's ``learn.ingest``; the same
streams, chunking and bucketing, so a stream chunks to byte-identical
arrays in both packages).

The estimator (``learn.hawkes_mle``) consumes a single canonical shape —
:class:`EventStream`, one globally time-ordered multivariate event stream
``(times f64[n], dims i32[n])`` over ``n_dims`` dimensions — chunked into
fixed-size padded arrays (:class:`ChunkedEvents`) so corpus-scale traces
stream through the ``hawkes_pass`` kernel on a bounded set of shapes
(pad + mask; the chunk count is bucketed).

Adapters:

- :func:`from_event_log` — the simulator's own output
  (:class:`~redqueen_tpu_torch.sim.EventLog`): the simulate→fit→recover
  loop.
- :func:`from_traces` — per-user trace lists (``data.traces``).  A
  100k-user corpus cannot be a 100k-dimensional Hawkes (the alpha matrix
  alone would be 10^10 entries): ``n_dims`` groups users into
  hash-assigned dimensions, so the fit learns the group-level excitation
  structure at any corpus size.
- :func:`from_journal` — a serving runtime's journal (``serving.journal``,
  JSONL and binary records alike), or every shard's of a cluster
  directory.

Host-side code: times stay float64 here; the kernel consumes per-event
DIFFERENCES (``dt``, ``tail``) computed in f64 and cast to f32 — absolute
corpus timestamps would quantize consecutive-event gaps at f32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

__all__ = [
    "EventStream",
    "ChunkedEvents",
    "chunk_events",
    "from_event_log",
    "from_traces",
    "from_journal",
    "StreamValidationError",
]


class StreamValidationError(ValueError):
    """An event stream failed host-side domain validation (non-finite or
    decreasing times, out-of-range dimension ids, a horizon before the
    last event) — the validated boundary of the fit, mirroring
    ``config.ConfigValidationError`` for simulation specs."""


class EventStream(NamedTuple):
    """One multivariate point-process realization on ``[t_start, t_end]``.

    ``times`` f64[n] non-decreasing, ``dims`` i32[n] in ``[0, n_dims)``.
    The stream is the *sufficient statistic* the estimator sees — every
    adapter below reduces to this."""

    times: np.ndarray
    dims: np.ndarray
    n_dims: int
    t_end: float
    t_start: float = 0.0

    @property
    def n_events(self) -> int:
        return int(len(self.times))

    def counts(self) -> np.ndarray:
        """Events per dimension, f64[n_dims]."""
        return np.bincount(self.dims, minlength=self.n_dims).astype(
            np.float64)


def _validate_stream(times: np.ndarray, dims: np.ndarray, n_dims: int,
                     t_end: float, t_start: float) -> None:
    if n_dims < 1:
        raise StreamValidationError(f"n_dims must be >= 1, got {n_dims}")
    if not (np.isfinite(t_end) and np.isfinite(t_start)
            and t_end > t_start):
        raise StreamValidationError(
            f"need finite t_end > t_start, got [{t_start!r}, {t_end!r}]")
    if times.shape != dims.shape or times.ndim != 1:
        raise StreamValidationError(
            f"times/dims must be equal-length 1-D, got {times.shape} vs "
            f"{dims.shape}")
    if len(times):
        if not np.isfinite(times).all():
            i = int(np.flatnonzero(~np.isfinite(times))[0])
            raise StreamValidationError(
                f"times must be finite, got {times[i]!r} at event {i}")
        if not np.all(np.diff(times) >= 0):
            i = int(np.flatnonzero(np.diff(times) < 0)[0])
            raise StreamValidationError(
                f"times must be non-decreasing, but times[{i + 1}] = "
                f"{times[i + 1]!r} < times[{i}] = {times[i]!r} — merge/"
                f"sort the stream before fitting")
        if float(times[0]) < t_start or float(times[-1]) > t_end:
            raise StreamValidationError(
                f"events [{times[0]!r}, {times[-1]!r}] fall outside the "
                f"window [{t_start!r}, {t_end!r}] — pass the window the "
                f"stream was observed on (the compensator integrates it)")
        bad = (dims < 0) | (dims >= n_dims)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise StreamValidationError(
                f"dims must lie in [0, {n_dims}), got {int(dims[i])} at "
                f"event {i}")


def make_stream(times, dims, n_dims: int, t_end: float,
                t_start: float = 0.0) -> EventStream:
    """Validated :class:`EventStream` constructor (every adapter funnels
    through here; fit code may assume a stream is well-formed)."""
    times = np.asarray(times, np.float64)
    dims = np.asarray(dims, np.int32)
    _validate_stream(times, dims, int(n_dims), float(t_end),
                     float(t_start))
    return EventStream(times=times, dims=dims, n_dims=int(n_dims),
                       t_end=float(t_end), t_start=float(t_start))


class ChunkedEvents(NamedTuple):
    """Device-ready fit format: the stream reshaped to ``[C, K]`` padded
    chunks of ``K`` events (pad rides at the tail: ``dt = tail = 0``,
    ``mask = False`` — an exact no-op in the decay recursion).

    ``dt`` is the f32 gap since the previous event (``dt[0]`` from
    ``t_start``) and ``tail`` the f32 time to the horizon (``t_end - t``)
    — both differenced in f64 on host first, so corpus-scale absolute
    timestamps never meet f32.  ``C`` is bucketed (pow2 below 256
    chunks, multiples of 256 above): unequal corpora land on a bounded
    set of compiled shapes with <~10% pad waste at corpus scale."""

    dt: np.ndarray      # f32[C, K]
    dims: np.ndarray    # i32[C, K]
    mask: np.ndarray    # bool[C, K]
    tail: np.ndarray    # f32[C, K]
    counts: np.ndarray  # f64[D] events per dimension
    n_dims: int
    n_events: int
    t_end: float
    t_start: float

    @property
    def span(self) -> float:
        """Observation-window length T the compensator integrates."""
        return self.t_end - self.t_start


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


# Chunk-count bucketing: pow2 below the knee (few shapes for small
# streams), multiples of the knee above it (a corpus at C=2095 pads to
# 2304, ~10% waste — pow2 there would pad to 4096 and DOUBLE every
# iteration's scan work).  Compile count stays bounded either way.
_CHUNK_BUCKET = 256


def _pad_chunks(c: int) -> int:
    if c <= _CHUNK_BUCKET:
        return _next_pow2(c)
    return _CHUNK_BUCKET * ((c + _CHUNK_BUCKET - 1) // _CHUNK_BUCKET)


def chunk_events(stream: EventStream, chunk_size: int = 4096
                 ) -> ChunkedEvents:
    """Pad + mask + reshape a stream into :class:`ChunkedEvents`."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    n = stream.n_events
    K = int(chunk_size)
    C = _pad_chunks(max((n + K - 1) // K, 1))
    N = C * K
    dt64 = np.diff(stream.times, prepend=stream.t_start)
    tail64 = stream.t_end - stream.times
    dt = np.zeros(N, np.float32)
    tail = np.zeros(N, np.float32)
    dims = np.zeros(N, np.int32)
    mask = np.zeros(N, bool)
    dt[:n] = dt64
    tail[:n] = tail64
    dims[:n] = stream.dims
    mask[:n] = True
    return ChunkedEvents(
        dt=dt.reshape(C, K), dims=dims.reshape(C, K),
        mask=mask.reshape(C, K), tail=tail.reshape(C, K),
        counts=stream.counts(), n_dims=stream.n_dims, n_events=n,
        t_end=stream.t_end, t_start=stream.t_start)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------

def from_event_log(log, sources: Optional[Sequence[int]] = None,
                   lane: Optional[int] = None) -> EventStream:
    """Simulator :class:`~redqueen_tpu_torch.sim.EventLog` → stream.

    ``sources`` selects which source rows become fit dimensions (dim k =
    ``sources[k]``; default: every source that emitted at least one
    event, in row order) — pass the Hawkes wall rows to fit the walls
    without the controlled broadcaster's posts polluting the estimate.
    ``lane`` picks one lane of a batched log (required when batched).
    """
    times = log.times.detach().cpu().numpy()
    srcs = log.srcs.detach().cpu().numpy()
    n_events = np.asarray(log.n_events.detach().cpu().numpy()
                          if hasattr(log.n_events, "detach")
                          else log.n_events).reshape(-1)
    if times.ndim == 2:
        if lane is None:
            raise ValueError(
                f"batched EventLog ({times.shape[0]} lanes): pass lane=")
        times, srcs = times[lane], srcs[lane]
        n_events = n_events[lane]
    else:
        n_events = n_events[0]
    n = int(n_events)
    times, srcs = times[:n].astype(np.float64), srcs[:n].astype(np.int64)
    if sources is None:
        sources = sorted(set(int(s) for s in srcs))
    sources = [int(s) for s in sources]
    if not sources:
        raise StreamValidationError(
            "no sources selected (empty log?) — nothing to fit")
    lut = np.full(int(max(max(sources), srcs.max(initial=0))) + 1, -1,
                  np.int64)
    lut[sources] = np.arange(len(sources))
    dim = lut[srcs]
    keep = dim >= 0
    return make_stream(times[keep], dim[keep], len(sources),
                       t_end=float(log.cfg.end_time),
                       t_start=float(log.cfg.start_time))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix — user→dimension assignment that is
    stable across runs and processes, never Python ``hash``.  ONE
    implementation: this is the serving cluster's edge partitioner
    (``serving.cluster._mix64``), so grouping here can never silently
    diverge from shard partitioning."""
    from ..serving.cluster import _mix64

    return _mix64(x)


def _group_dims(ids: np.ndarray, n_ids: int, n_dims: Optional[int],
                assign: str):
    """Map entity ids (users, feeds) onto fit dimensions: identity when
    ``n_dims`` covers them all, else splitmix64-hash or modulo grouping
    (both stable across runs/processes)."""
    if n_dims is None or int(n_dims) >= n_ids:
        return ids, max(int(n_ids), 1)
    D = int(n_dims)
    if assign == "hash":
        return ((_splitmix64(ids.astype(np.uint64)) % np.uint64(D))
                .astype(np.int32), D)
    if assign == "modulo":
        return (ids % D).astype(np.int32), D
    raise ValueError(f"unknown assign {assign!r} (want hash|modulo)")


def _window(times: np.ndarray, t_end: Optional[float],
            t_start: Optional[float]):
    """Default observation window for absolute-timestamp corpora.  The
    compensator integrates the WHOLE window, so a corpus observed over
    ``[t0, t1]`` must say so: with epoch-scale timestamps the default
    ``t_start=0`` would charge a huge dead ``[0, t_first]`` interval and
    bias every base rate toward zero — pass the true window."""
    if t_end is None:
        t_end = float(times[-1]) if len(times) else 1.0
    if t_start is None:
        t_start = min(float(times[0]), 0.0) if len(times) else 0.0
    return float(t_end), float(t_start)


def from_traces(traces: List[np.ndarray], n_dims: Optional[int] = None,
                t_end: Optional[float] = None, assign: str = "hash",
                max_rows: Optional[int] = None,
                t_start: Optional[float] = None) -> EventStream:
    """Per-user trace lists (``data.traces.synthetic_twitter``, the
    corpus format) → stream.

    ``n_dims=None`` keeps one dimension per user (only sane for small
    corpora — the alpha matrix is ``D x D``); otherwise users are grouped
    into ``n_dims`` dimensions: ``assign="hash"`` (splitmix64 of the user
    index — balanced in expectation, stable) or ``"modulo"``.
    ``max_rows`` fits a time-prefix of the merged stream (the earliest
    rows).  ``(t_start, t_end)`` is the
    observation window the compensator integrates — it defaults to
    ``[min(t_first, 0), t_last]``, which is right for windows anchored at
    zero (the synthetic corpora) but WRONG for absolute epoch timestamps:
    there, pass the corpus's real observation window explicitly, or the
    fit charges the dead ``[0, t_first]`` span and biases ``mu`` low."""
    from ..serving.corpus import merge_traces

    times, users = merge_traces(traces, max_rows=max_rows)
    dims, D = _group_dims(users, max(len(traces), 1), n_dims, assign)
    t_end, t_start = _window(times, t_end, t_start)
    return make_stream(times, dims, D, t_end=t_end, t_start=t_start)


def from_journal(dir: str, n_dims: Optional[int] = None,
                 t_end: Optional[float] = None, assign: str = "hash",
                 t_start: Optional[float] = None) -> EventStream:
    """Serving journal → stream: replay + verify every retained record
    (``serving.journal.replay`` — rotated segments then the live file,
    checksum-enveloped per record) of a runtime dir, or of every
    ``shard-KKKK/`` under a sharded cluster dir, and fit the ingested
    ``(times, feeds)`` they journaled.  Feeds group into ``n_dims``
    dimensions exactly like :func:`from_traces` users; the
    ``(t_start, t_end)`` window defaults/caveats are
    :func:`from_traces`'s too.

    Shard journals record shard-LOCAL feed indices (the router maps
    global feed → local slot before submit), so each shard's ids are
    namespaced by its directory here — shard 0's feed 3 and shard 1's
    feed 3 are DIFFERENT entities and never collapse into one
    dimension."""
    import glob as _glob
    import os

    from ..serving.journal import JOURNAL_FILENAME, replay as journal_replay

    shard_dirs = sorted(_glob.glob(os.path.join(dir, "shard-[0-9]*")))
    roots = shard_dirs or [dir]
    times_l: List[np.ndarray] = []
    feeds_l: List[np.ndarray] = []
    base = 0
    for root in roots:
        records, _torn = journal_replay(
            os.path.join(root, JOURNAL_FILENAME),
            quarantine_torn_tail=False)
        top = -1
        for rec in records:
            if "feeds" not in rec:
                # Parameter-install (epoch) records share the journal
                # stream with batch records but carry no events.
                continue
            f = np.asarray(rec["feeds"], np.int64)
            times_l.append(np.asarray(rec["times"], np.float64))
            feeds_l.append(f + base)
            if len(f):
                top = max(top, int(f.max()))
        base += top + 1
    if times_l:
        times = np.concatenate(times_l)
        feeds = np.concatenate(feeds_l)
    else:
        times = np.empty(0, np.float64)
        feeds = np.empty(0, np.int64)
    order = np.argsort(times, kind="stable")
    times, feeds = times[order], feeds[order]
    n_ids = int(feeds.max()) + 1 if len(feeds) else 1
    dims, D = _group_dims(feeds, n_ids, n_dims, assign)
    t_end, t_start = _window(times, t_end, t_start)
    return make_stream(times, dims, D, t_end=t_end, t_start=t_start)
