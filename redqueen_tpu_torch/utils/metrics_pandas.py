"""Pandas evaluation layer: feed-rank metrics over the event-log
DataFrame, a copy of the JAX package's ``utils/metrics_pandas.py``
(after ``redqueen/utils.py`` of MPI-SWS/RedQueen: ``rank_of_src_in_df``,
``time_in_top_k``, ``average_rank`` and the loss and budget helpers).

It reads only the (event, sink) schema that ``utils.dataframe``
produces, the reference's own artifact, so its values are the pandas
values of either package.  pandas is imported here and in ``dataframe``
only.

Conventions (shared with the tensor metrics in ``utils.metrics``):
- r_i(t) = number of posts by OTHER sources into sink i's feed since ``src_id``
  last posted there; r_i(start_time) = 0.
- ``time_in_top_k`` returns the PER-SINK MEAN of the integral
  int_start^end 1[r_i(t) < K] dt.
- ``average_rank`` returns the per-sink mean of int r_i(t) dt / (end - start).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

__all__ = [
    "rank_of_src_in_df",
    "time_in_top_k",
    "average_rank",
    "int_rank_dt",
    "int_rank2_dt",
    "num_posts_of_src",
    "is_sorted",
]


def is_sorted(x) -> bool:
    """True iff x is non-decreasing (reference: ``is_sorted`` helper)."""
    x = np.asarray(x)
    return bool(np.all(x[1:] >= x[:-1]))


def rank_of_src_in_df(df: pd.DataFrame, src_id) -> Dict:
    """Per-sink rank step function of ``src_id`` (reference:
    ``rank_of_src_in_df``).

    Returns {sink_id: (times, ranks)} where ``ranks[j]`` holds on
    [times[j], times[j+1]). The first entry is the first feed event; the rank
    before any feed activity is 0 by convention.
    """
    out = {}
    for sink_id, g in df.groupby("sink_id", sort=True):
        g = g.sort_values(["t", "event_id"], kind="mergesort")
        times = g["t"].to_numpy()
        own = (g["src_id"] == src_id).to_numpy()
        # Vectorized "others since our last post": with c = running count
        # of other-source events (inclusive), the rank at event j is
        # c[j] - c[last own event <= j] (0 baseline before any own post),
        # and 0 at own posts. Equivalent to the per-event loop
        # r = 0 if own else r + 1, at numpy speed for big logs.
        c = np.cumsum(~own)
        base = np.maximum.accumulate(np.where(own, c, 0))
        ranks = np.where(own, 0, c - base).astype(np.int64)
        out[sink_id] = (times, ranks)
    return out


_EMPTY = (np.empty(0), np.empty(0, dtype=np.int64))


def _per_sink_integral(df: pd.DataFrame, src_id, start_time: float,
                       end_time: float, f, sink_ids=None) -> Dict:
    """int_start^end f(r_i(t)) dt per sink, r piecewise-constant.

    The rank step function is built from the FULL event history, then
    integrated over the [start_time, end_time] window only — a rank built up
    before the window carries into it. Pass ``sink_ids`` (e.g.
    ``SimOpts.sink_ids``) so followers whose feeds received no events still
    contribute their full-horizon rank-0 value; inferring sinks from the
    DataFrame alone would silently drop them and bias the per-sink mean.
    """
    rank_ts = rank_of_src_in_df(df, src_id)
    if sink_ids is None:
        sinks = sorted(rank_ts.keys())
    else:
        sinks = list(sink_ids)
    out = {}
    for sink_id in sinks:
        times, ranks = rank_ts.get(sink_id, _EMPTY)
        inside = (times > start_time) & (times < end_time)
        # Rank in effect at start_time: value of the last event at t <= start.
        idx = int(np.searchsorted(times, start_time, side="right")) - 1
        r0 = int(ranks[idx]) if idx >= 0 else 0
        knots = np.concatenate(([start_time], times[inside], [end_time]))
        vals = np.concatenate(([r0], ranks[inside]))
        out[sink_id] = float(np.sum(np.diff(knots) * f(vals.astype(np.float64))))
    return out


def time_in_top_k(df: pd.DataFrame, K: int, end_time: float,
                  src_id, start_time: float = 0.0,
                  per_sink: bool = False, sink_ids=None):
    """Mean over sinks of int 1[r_i(t) < K] dt (reference: ``time_in_top_k`` —
    the BASELINE quality metric at K=1)."""
    per = _per_sink_integral(
        df, src_id, start_time, end_time,
        lambda r: (r < K).astype(np.float64), sink_ids=sink_ids,
    )
    if per_sink:
        return per
    return float(np.mean(list(per.values()))) if per else 0.0


def int_rank_dt(df: pd.DataFrame, end_time: float, src_id,
                start_time: float = 0.0, per_sink: bool = False, sink_ids=None):
    """Mean over sinks of int r_i(t) dt (reference: rank-over-time integral)."""
    per = _per_sink_integral(df, src_id, start_time, end_time, lambda r: r,
                             sink_ids=sink_ids)
    if per_sink:
        return per
    return float(np.mean(list(per.values()))) if per else 0.0


def int_rank2_dt(df: pd.DataFrame, end_time: float, src_id,
                 start_time: float = 0.0, per_sink: bool = False, sink_ids=None):
    """Mean over sinks of int r_i(t)^2 dt (reference: quadratic loss term)."""
    per = _per_sink_integral(df, src_id, start_time, end_time, lambda r: r * r,
                             sink_ids=sink_ids)
    if per_sink:
        return per
    return float(np.mean(list(per.values()))) if per else 0.0


def average_rank(df: pd.DataFrame, end_time: float, src_id,
                 start_time: float = 0.0, sink_ids=None) -> float:
    """Time-averaged mean rank: int_rank_dt / (end - start) (reference:
    ``average_rank``)."""
    return int_rank_dt(df, end_time, src_id, start_time, sink_ids=sink_ids) / (
        end_time - start_time
    )


def num_posts_of_src(df: pd.DataFrame, src_id) -> int:
    """Number of posts by ``src_id`` (budget check; reference: int u dt
    helper — for a counting realization the integral IS the post count)."""
    return int(df[df["src_id"] == src_id]["event_id"].nunique())
