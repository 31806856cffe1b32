"""Corpus replay: trace-corpus rows → sequenced serving micro-batches
(the counterpart of the JAX package's ``serving.corpus``).

The ingest path is not only for synthetic streams: a real trace corpus
replays through the sharded cluster on the card as

    CSV corpus --load_csv(the native C++ loader where it builds, else
    the Python engine)-->
    per-user traces --merge_traces (one global time-ordered event
    stream; ties keep user order, deterministically)-->
    corpus_batches (fixed-size sequence-numbered micro-batches)-->
    ServingCluster.submit/poll (sharded, journaled, fault-isolated)

Every stage is a pure function of the corpus bytes, so a crashed replay
regenerates the byte-identical batch stream — the same retransmit model
as ``serving.events.synthetic_stream`` — and the sharded runtime's
recovery invariants hold unchanged under real data.

CLI: ``python -m redqueen_tpu_torch.serving.corpus --csv corpus.csv --dir D
--shards 4 [--device cpu]`` (see ``--help``; the card unless
``--device cpu``); lands the ``rq.serving.metrics/2``
artifact plus a ``rq.serving.corpus/1`` summary (rows, users, loader
engine, rows/s served).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from ..runtime import integrity as _integrity
from .events import EventBatch

__all__ = ["merge_traces", "corpus_batches", "serve_corpus", "main",
           "CORPUS_SCHEMA"]

CORPUS_SCHEMA = "rq.serving.corpus/1"

# Bounded retransmit: each round resends everything past the acked
# position (auto-recovery runs inside poll), so a healthy cluster
# converges in one; a shard that stays down past this is an operator
# problem and the replay fails loudly instead of under-serving.
_RETRANSMIT_ROUNDS = 8


def merge_traces(traces: List[np.ndarray],
                 max_rows: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-user ascending trace arrays into ONE globally
    time-ordered event stream ``(times f64[R], feeds i32[R])`` where
    ``feeds`` is the user index (= the serving feed/edge id).

    The sort is stable, so rows with equal timestamps keep user order —
    the merge is a pure function of the corpus, which is what makes a
    restarted replay regenerate the byte-identical stream.
    ``max_rows`` truncates the MERGED stream (a time-prefix of the
    corpus: the earliest ``max_rows`` events), never a per-user bite."""
    n_users = len(traces)
    if n_users == 0:
        return np.empty(0, np.float64), np.empty(0, np.int32)
    times = np.concatenate([np.asarray(t, np.float64) for t in traces]) \
        if any(len(t) for t in traces) else np.empty(0, np.float64)
    feeds = np.repeat(np.arange(n_users, dtype=np.int32),
                      [len(t) for t in traces])
    order = np.argsort(times, kind="stable")
    times, feeds = times[order], feeds[order]
    if max_rows is not None and len(times) > int(max_rows):
        times, feeds = times[: int(max_rows)], feeds[: int(max_rows)]
    return times, feeds


def corpus_batches(times: np.ndarray, feeds: np.ndarray,
                   batch_events: int,
                   start_seq: int = 0) -> Iterator[EventBatch]:
    """Chunk a merged event stream into consecutive sequence-numbered
    micro-batches of at most ``batch_events`` events each (the last may
    be short).  Views, not copies — 8.58M corpus rows stream through
    without a second resident copy."""
    if batch_events < 1:
        raise ValueError(f"batch_events must be >= 1, got {batch_events}")
    n = len(times)
    seq = int(start_seq)
    for lo in range(0, n, int(batch_events)):
        hi = min(lo + int(batch_events), n)
        yield EventBatch(seq, times[lo:hi], feeds[lo:hi])
        seq += 1


def serve_corpus(csv_path: str, dir: Optional[str], n_shards: int,
                 batch_events: int = 512, engine: str = "auto",
                 max_rows: Optional[int] = None, seed: int = 0,
                 q: float = 1.0, snapshot_every: int = 256,
                 queue_capacity: int = 64,
                 placement: str = "in-process", clock=time.monotonic,
                 log=None, device: DeviceLike = "cuda") -> dict:
    """End-to-end corpus serving: load (``engine``: the native C++ loader
    where it builds, for ``"auto"``), merge, batch, and drive the full
    stream through a sharded
    :class:`~redqueen_tpu_torch.serving.cluster.ServingCluster` (submit+poll
    per batch — the steady-state serving shape, journal fsync in the
    measured path when ``dir`` is given).  ``placement="workers"``
    replays through out-of-process shard workers (requires ``dir``) —
    same batches, bit-identical decisions, N-process parallel applies.
    The shards serve on ``device`` (the card unless ``device="cpu"``).
    Returns the summary payload (also landed as ``<dir>/corpus.json``
    when ``dir`` is set)."""
    from ..data import traces as traces_mod
    from ..native import loader as native_loader
    from .cluster import ServingCluster

    def _log(*a):
        if log is not None:
            log(*a)

    engine_used = ("native" if (engine in ("auto", "native")
                                and native_loader.available())
                   else "python")
    t0 = clock()
    traces, stats = traces_mod.load_csv(csv_path, engine=engine,
                                        return_stats=True)
    load_s = clock() - t0
    times, feeds = merge_traces(traces, max_rows=max_rows)
    n_feeds = max(len(traces), 1)
    _log(f"corpus: {stats.n_rows} rows / {stats.n_users} users loaded "
         f"in {load_s:.2f}s via the {engine_used} loader; serving "
         f"{len(times)} rows through {n_shards} shard(s)")
    cl = ServingCluster(
        n_feeds=n_feeds, n_shards=n_shards, dir=dir, q=q, seed=seed,
        snapshot_every=snapshot_every, queue_capacity=queue_capacity,
        max_batch_events=batch_events, placement=placement, clock=clock,
        device=device)
    n_batches = 0
    t1 = clock()
    with cl:
        for b in corpus_batches(times, feeds, batch_events):
            cl.submit(b)
            cl.poll()
            n_batches += 1
        # The retransmit model made real: if a shard crashed/shed
        # mid-replay, regenerate the (pure-function) batch stream and
        # resend everything past the cluster's acked position until it
        # converges — rows_served must mean APPLIED, not offered.
        final_seq = n_batches - 1
        for _ in range(_RETRANSMIT_ROUNDS):
            if cl.applied_seq >= final_seq:
                break
            cl.poll()
            for b in corpus_batches(times, feeds, batch_events):
                if int(b.seq) > cl.applied_seq:
                    cl.submit(b)
                    cl.poll()
        if n_batches and cl.applied_seq < final_seq:
            raise RuntimeError(
                f"corpus replay did not converge: applied_seq="
                f"{cl.applied_seq} < {final_seq} after "
                f"{_RETRANSMIT_ROUNDS} retransmit rounds "
                f"(health={cl.health_by_shard}) — a shard is not "
                f"recovering; the metrics artifact in {dir!r} has the "
                f"per-shard breakdown")
        serve_s = max(clock() - t1, 1e-9)
        report = cl.metrics.report(cl.pending_by_shard,
                                   cl.health_by_shard)
        payload = {
            "csv": os.path.abspath(csv_path),
            "loader_engine": engine_used,
            "corpus_rows": int(stats.n_rows),
            "corpus_users": int(stats.n_users),
            "duplicate_timestamps": int(stats.duplicate_timestamps),
            "non_monotonic_rows": int(stats.non_monotonic_rows),
            "rows_served": int(len(times)),
            "rows_truncated": bool(max_rows is not None
                                   and stats.n_rows > len(times)),
            "n_shards": int(n_shards),
            "n_batches": n_batches,
            "batch_events": int(batch_events),
            "load_secs": round(load_s, 3),
            "load_rows_per_sec": round(stats.n_rows / max(load_s, 1e-9),
                                       1),
            "serve_secs": round(serve_s, 3),
            "serve_rows_per_sec": round(len(times) / serve_s, 1),
            "reconciles": report["reconciles"],
            "applied_seq": cl.applied_seq,
            "decision_latency": report["decision_latency"],
        }
        if dir is not None:
            cl.write_metrics()
            _integrity.write_json(os.path.join(dir, "corpus.json"),
                                  payload, schema=CORPUS_SCHEMA)
    _log(f"corpus: served {payload['rows_served']} rows in "
         f"{payload['serve_secs']:.2f}s -> "
         f"{payload['serve_rows_per_sec']:,.0f} rows/s across "
         f"{n_shards} shard(s); reconciles={payload['reconciles']}")
    return payload


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m redqueen_tpu_torch.serving.corpus",
        description="replay a trace corpus through the sharded serving "
                    "cluster as sequenced micro-batches")
    ap.add_argument("--csv", required=True, help="corpus CSV "
                    "(user,timestamp rows — data.traces format)")
    ap.add_argument("--dir", default=None,
                    help="cluster directory (journals + snapshots + "
                         "metrics); omit for an in-memory dry run")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--batch-events", type=int, default=512)
    ap.add_argument("--max-rows", type=int, default=None,
                    help="serve only the earliest N merged rows")
    ap.add_argument("--engine", choices=["auto", "native", "python"],
                    default="auto",
                    help="CSV parser (auto = python; native is not "
                         "ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--snapshot-every", type=int, default=256)
    ap.add_argument("--workers", action="store_true",
                    help="replay through out-of-process shard workers "
                         "(requires --dir; serving.worker)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the shards' carries live and the applies "
                         "run (default: the card)")
    args = ap.parse_args(argv)
    if args.workers and args.dir is None:
        ap.error("--workers needs --dir (a worker subprocess owns its "
                 "shard's on-disk state)")
    payload = serve_corpus(
        args.csv, args.dir, args.shards,
        batch_events=args.batch_events, engine=args.engine,
        max_rows=args.max_rows, seed=args.seed, q=args.q,
        snapshot_every=args.snapshot_every,
        placement="workers" if args.workers else "in-process",
        log=lambda *a: print(*a, file=sys.stderr, flush=True),
        device=args.device)
    import json

    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
