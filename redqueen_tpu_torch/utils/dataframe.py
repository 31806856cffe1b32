"""Event log -> pandas export, a copy of the JAX package's
``utils/dataframe.py`` that also takes torch tensors (on any device).

It turns one component's event buffer (times, srcs) and its adjacency
into the reference's (event, sink) schema,
``event_id, t, time_delta, src_id, sink_id``, one row per (event, sink),
which the unchanged pandas evaluation layer (``utils.metrics_pandas``)
reads.  pandas is imported here and in ``metrics_pandas`` only, never by
the package's ``__init__``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

__all__ = ["events_to_dataframe", "star_events_to_dataframe"]


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def events_to_dataframe(times, srcs, adj, src_ids=None,
                        sink_ids=None, start_time: float = 0.0) -> pd.DataFrame:
    """Expand one component's event log to the reference DataFrame schema.

    ``times`` [E] / ``srcs`` [E] (invalid tail: src == -1), ``adj`` [S, F].
    ``src_ids``/``sink_ids`` optionally relabel rows/columns to external ids
    (the oracle's arbitrary hashable ids); defaults are positional indices.
    ``time_delta`` is the gap since the same source's previous post, measured
    from ``start_time`` (the simulation start) for a source's first post
    (the reference's Event semantics).
    """
    times = _host(times, np.float64)
    srcs = _host(srcs, np.int64)
    adj = _host(adj, bool)
    valid = srcs >= 0
    times, srcs = times[valid], srcs[valid]
    S = adj.shape[0]
    src_ids = np.arange(S) if src_ids is None else np.asarray(src_ids)
    sink_ids = (
        np.arange(adj.shape[1]) if sink_ids is None else np.asarray(sink_ids)
    )

    # time_delta: per-source consecutive gaps (first post from start_time),
    # vectorized as a grouped shift, fast at millions of events.
    prev = pd.Series(times).groupby(srcs).shift()
    deltas = times - prev.fillna(float(start_time)).to_numpy()

    # (event, sink) expansion via a CSR-style gather over per-source sink
    # lists: no per-event Python work.
    indptr = np.zeros(S + 1, np.int64)
    indptr[1:] = adj.sum(axis=1).cumsum()
    # row-major flatnonzero is already grouped by source row == CSR order
    indices = np.flatnonzero(adj) % adj.shape[1]
    counts = np.diff(indptr)[srcs]  # sinks per event
    rows = np.repeat(np.arange(len(times)), counts)
    total = int(counts.sum())
    if total:
        starts = np.repeat(indptr[srcs], counts)
        offset = np.arange(total) - np.repeat(
            np.concatenate(([0], counts.cumsum()[:-1])), counts
        )
        sink_idx = indices[starts + offset]
    else:
        sink_idx = np.empty(0, np.int64)
    return pd.DataFrame(
        {
            "event_id": rows,
            "t": times[rows],
            "time_delta": deltas[rows],
            "src_id": src_ids[srcs[rows]],
            "sink_id": sink_ids[sink_idx],
        }
    )


def star_events_to_dataframe(res, src_id=0,
                             wall_src_offset: int = 100) -> pd.DataFrame:
    """A star run (``parallel.star_types.StarResult``) in the same schema,
    for small-F validation: wall source ids are ``wall_src_offset + feed``;
    own posts land in every feed and go first at equal times."""
    F = res.cfg.n_feeds
    own_all = _host(res.own_times, np.float64)
    own = own_all[np.isfinite(own_all)]
    walls = _host(res.wall_times, np.float64)
    wall_n = _host(res.wall_n, np.int64)
    rows = [(float(t), 0, src_id, None) for t in own]
    for f in range(F):
        for t in walls[f][:int(wall_n[f])]:
            rows.append((float(t), 1, wall_src_offset + f, f))
    rows.sort(key=lambda r: (r[0], r[1]))
    recs = []
    last = {}
    for eid, (t, _, src, sink) in enumerate(rows):
        delta = t - last.get(src, res.cfg.start_time)
        last[src] = t
        for sk in (range(F) if sink is None else [sink]):
            recs.append((eid, t, delta, src, sk))
    return pd.DataFrame(
        recs, columns=["event_id", "t", "time_delta", "src_id", "sink_id"])
