"""Event traces for real-data replay, the counterpart of the JAX
package's ``data/traces.py``, in numpy: the CSV loader (a Python engine
and the native C++ one, ``redqueen_tpu_torch.native``) and writer, the
npz loaders, normalisation of the time axis, padding and bucketing by
length, the heavy-tailed synthetic corpus, the star components built
from a corpus and the gap sequences RMTPP trains on.

No instructions from data files are ever executed — traces are parsed
as numbers only."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike

__all__ = ["Traces", "TraceOrderError", "LoadStats", "load_csv",
           "save_csv", "save_npz", "load_npz", "normalize_traces",
           "pad_traces", "bucket_traces", "gaps_from_traces",
           "synthetic_twitter", "star_from_traces", "replay_buckets"]

Traces = List[np.ndarray]  # one ascending float64 time array per user


class TraceOrderError(ValueError):
    """A trace row's timestamp cannot be ordered (NaN): typed rejection
    instead of a silently NaN-sorted corpus.  Downstream consumers (the
    serving ingest path's reorder window, the RealData replay) all
    assume orderable times, so an unorderable row must die at the
    boundary with a line number, not three layers later as a
    quarantined lane."""


class LoadStats(NamedTuple):
    """What the parse observed about the corpus's ORDER quality — the
    measured input contract for the serving reorder window (a corpus
    with many non-monotonic rows needs a wide window; duplicates feed
    the duplicate-drop expectation)."""

    n_rows: int                 # events parsed (post header/blank skip)
    n_users: int                # distinct users
    duplicate_timestamps: int   # same user, exactly equal timestamps
    non_monotonic_rows: int     # rows that regressed vs the same user's
    #                             previous row in FILE order


def load_csv(path: str, user_col: int = 0, time_col: int = 1,
             delimiter: str = ",", skip_header: int = 1,
             engine: str = "auto", return_stats: bool = False):
    """Load (user, timestamp) rows into per-user ascending time arrays.

    Users are ordered by first appearance; times sort per user (the JAX
    package's format and output).  ``engine``: ``"native"`` requires the
    C++ parser (``redqueen_tpu_torch.native.loader``, built with g++ on
    first use; a failed build raises ``NativeBuildError``), ``"python"``
    parses in the interpreter, and ``"auto"`` takes the native parser
    when it builds here and the arguments suit it (a one-byte delimiter,
    non-negative columns), else the Python one.  Both engines give the
    same traces and ``LoadStats``.

    ``return_stats=True`` returns ``(traces, LoadStats)`` — the
    duplicate-timestamp / non-monotonic-row counts are surfaced, never
    silently absorbed by the per-user sort.  A NaN timestamp raises
    :class:`TraceOrderError` (it cannot be ordered) in both engines."""
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    native_ok = (len(delimiter.encode()) == 1
                 and user_col >= 0 and time_col >= 0)
    if engine == "native" or (engine == "auto" and native_ok):
        from ..native import loader as _native

        if engine == "native" or _native.available():
            return _native.load_csv_native(
                path, user_col=user_col, time_col=time_col,
                delimiter=delimiter, skip_header=skip_header,
                return_stats=return_stats)
    users: Dict = {}
    order: List = []
    n_rows = 0
    non_monotonic = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip_header or not line.strip():
                continue
            parts = line.rstrip("\n").split(delimiter)
            u = parts[user_col]
            t = float(parts[time_col])
            if t != t:  # NaN: unorderable
                raise TraceOrderError(
                    f"{path}: line {i}: unorderable timestamp "
                    f"'{parts[time_col].strip()}' (NaN rows cannot be "
                    f"ordered)")
            if u not in users:
                users[u] = []
                order.append(u)
            elif users[u] and t < users[u][-1]:
                non_monotonic += 1
            users[u].append(t)
            n_rows += 1
    out = [np.sort(np.asarray(users[u], np.float64)) for u in order]
    if not return_stats:
        return out
    duplicates = sum(int(np.sum(a[1:] == a[:-1])) for a in out if len(a))
    return out, LoadStats(
        n_rows=n_rows, n_users=len(order),
        duplicate_timestamps=duplicates,
        non_monotonic_rows=non_monotonic)


def save_csv(path: str, traces: Traces, float_format: str = "%.9g") -> None:
    """Write traces as (user, time) CSV rows under a ``user,time``
    header, user-major, so :func:`load_csv` round-trips to the same
    per-user arrays: users are ordered by first appearance (= writing
    order, named ``u000000``...) and times are already ascending per
    user.  The bytes are the JAX package's.

    ``float_format`` %.9g keeps ~1e-9 relative precision — beyond the
    float32 resolution the kernels run at (exact f64 round-trip needs
    %.17g at ~2x the file size).  Users with EMPTY traces write no rows
    and therefore vanish on round trip (CSV cannot represent them)."""
    with open(path, "w") as f:
        f.write("user,time\n")
        for i, t in enumerate(traces):
            name = f"u{i:06d}"
            f.writelines(f"{name},{float_format % float(x)}\n"
                         for x in np.asarray(t, np.float64))


def save_npz(path: str, traces: Traces) -> None:
    """Persist traces as one array per user (``u000000``...), the JAX
    package's layout: each package loads the other's file."""
    np.savez_compressed(
        path, **{f"u{i:06d}": t for i, t in enumerate(traces)})


def load_npz(path: str) -> Traces:
    """Traces saved by :func:`save_npz`, float64, in user order."""
    with np.load(path) as z:
        return [np.asarray(z[k], np.float64) for k in sorted(z.files)]


def normalize_traces(traces: Traces, end_time: float,
                     t_min: Optional[float] = None,
                     t_max: Optional[float] = None) -> Traces:
    """Map absolute timestamps affinely onto [0, end_time], dropping
    events outside [t_min, t_max] (default: the corpus's range).  Raw
    epoch seconds (~1.5e9) exceed float32's resolution, and the kernels
    run in float32."""
    all_t = (np.concatenate([t for t in traces if len(t)]) if traces
             else np.empty(0))
    if t_min is None:
        t_min = float(all_t.min()) if len(all_t) else 0.0
    if t_max is None:
        t_max = float(all_t.max()) if len(all_t) else 1.0
    span = max(t_max - t_min, 1e-12)
    out = []
    for t in traces:
        t = t[(t >= t_min) & (t <= t_max)]
        out.append((t - t_min) * (end_time / span))
    return out


def pad_traces(traces: Traces, length: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad to a ``[U, L]`` float array (+inf tail) plus lengths ``[U]``."""
    lens = np.array([len(t) for t in traces], np.int64)
    L = int(lens.max()) if length is None else int(length)
    if length is not None and lens.max() > length:
        raise ValueError(
            f"trace of length {int(lens.max())} exceeds requested pad length "
            f"{length} — refusing to truncate silently")
    out = np.full((len(traces), max(L, 1)), np.inf, np.float64)
    for i, t in enumerate(traces):
        out[i, :len(t)] = t
    return out, lens


def bucket_traces(traces: Traces, edges: Sequence[int] = (16, 64, 256, 1024)
                  ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Users grouped into length buckets to bound the padding: one
    ``(user_indices [u], padded [u, L_b], lengths [u])`` per non-empty
    bucket, ``L_b`` the bucket's edge (the longest trace past the last
    edge gets a bucket of its own length; empty traces join the first)."""
    lens = np.array([len(t) for t in traces], np.int64)
    bounds = list(edges)
    if len(lens) and lens.max() > bounds[-1]:
        bounds.append(int(lens.max()))
    out = []
    lo = -1
    for hi in bounds:
        idx = np.where((lens > lo) & (lens <= hi))[0]
        if len(idx):
            padded, ls = pad_traces([traces[i] for i in idx], length=hi)
            out.append((idx, padded, ls))
        lo = hi
    return out


def gaps_from_traces(traces: Traces, length: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user inter-event gaps for likelihood training
    (``models.rmtpp.fit``): ``(taus [U, L], mask [U, L])``, float64 zero
    padding with a boolean validity mask.  The first gap is measured
    from t = 0, where the policy's recurrent state starts; empty traces
    become all-masked rows.  A trace longer than ``length`` raises."""
    gaps = [np.diff(t, prepend=0.0) if len(t) else np.empty(0)
            for t in traces]
    lens = np.array([len(g) for g in gaps], np.int64)
    L = (int(max(lens.max() if len(lens) else 0, 1)) if length is None
         else int(length))
    if lens.max(initial=0) > L:
        raise ValueError(
            f"trace with {int(lens.max())} events exceeds requested length "
            f"{L} — refusing to truncate silently")
    taus = np.zeros((len(traces), L), np.float64)
    mask = np.zeros((len(traces), L), bool)
    for i, g in enumerate(gaps):
        taus[i, : len(g)] = g
        mask[i, : len(g)] = True
    return taus, mask


def synthetic_twitter(seed: int, n_users: int, end_time: float,
                      mean_rate: float = 1.0, sigma: float = 1.0,
                      diurnal: float = 0.5, max_len: Optional[int] = None
                      ) -> Traces:
    """Heavy-tailed synthetic posting corpus: log-normal per-user base
    rates modulated by a sinusoidal diurnal profile, sampled exactly by
    thinning against each user's peak rate (the same numpy draws, in the
    same order, as the JAX package's, so a seed gives the same corpus)."""
    rng = np.random.RandomState(seed)
    base = rng.lognormal(mean=np.log(mean_rate) - sigma ** 2 / 2,
                         sigma=sigma, size=n_users)
    out = []
    for u in range(n_users):
        peak = base[u] * (1 + diurnal)
        n = rng.poisson(peak * end_time)
        t = np.sort(rng.uniform(0, end_time, n))
        lam = base[u] * (1 + diurnal * np.sin(
            2 * np.pi * t / max(end_time / 4, 1e-9)))
        keep = rng.uniform(0, peak, n) < lam
        t = t[keep]
        if max_len is not None and len(t) > max_len:
            t = t[np.sort(rng.choice(len(t), max_len, replace=False))]
        out.append(t)
    return out


def star_from_traces(traces: Traces, end_time: float, ctrl: str = "opt",
                     q: float = 1.0, ctrl_times: Optional[np.ndarray] = None,
                     s_sink: Optional[Sequence[float]] = None,
                     post_cap: int = 2048, device: DeviceLike = "cuda"):
    """The BASELINE config-4 star component: one controlled broadcaster
    (``"opt"``, or ``"replay"`` of ``ctrl_times``) against one replay wall
    per trace.  Returns ``(cfg, wall, ctrl_params)`` on ``device``."""
    from ..parallel.star_builder import StarBuilder

    padded, lens = pad_traces(traces)
    F = padded.shape[0]
    sb = StarBuilder(n_feeds=F, end_time=end_time, s_sink=s_sink)
    for f in range(F):
        sb.wall_replay(f, padded[f, :lens[f]])
    if ctrl == "opt":
        sb.ctrl_opt(q=q)
    elif ctrl == "replay":
        if ctrl_times is None:
            raise ValueError('ctrl="replay" requires ctrl_times')
        sb.ctrl_replay(ctrl_times)
    else:
        raise ValueError(f"unknown ctrl {ctrl!r}")
    return sb.build(wall_cap=max(int(lens.max()), 1), post_cap=post_cap,
                    device=device)


def replay_buckets(traces: Traces, end_time: float, ctrl_times: np.ndarray,
                   edges: Sequence[int] = (16, 64, 256, 1024),
                   s_sink: Optional[Sequence[float]] = None,
                   device: DeviceLike = "cuda"):
    """Length-bucketed star components for a REPLAY-controlled
    broadcaster: ``[(user_indices, cfg, wall, ctrl), ...]`` on ``device``,
    one per :func:`bucket_traces` bucket, each padded only to its edge.
    Valid because a replayed broadcaster's posts are fixed, so the feeds
    decouple; RedQueen's clock couples every feed, so ``ctrl="opt"``
    must run as one component.  Run each through ``simulate_star`` and
    scatter the per-feed metrics back by ``user_indices``."""
    out = []
    for idx, padded, lens in bucket_traces(traces, edges=edges):
        out.append(
            (idx,) + star_from_traces(
                [padded[i, :lens[i]] for i in range(len(idx))], end_time,
                ctrl="replay", ctrl_times=ctrl_times,
                s_sink=None if s_sink is None else [s_sink[i] for i in idx],
                device=device))
    return out
