"""Deterministic ingest-stream driver: the serving runtime's test rig
and CLI entry point (``python -m redqueen_tpu_torch.serving.stream``), the
counterpart of the JAX package's ``serving.stream``.

Plays a :func:`serving.events.synthetic_stream` (pure function of its
seed — a restarted driver regenerates byte-identical batches, which IS
the retransmit model) into a :class:`ServingRuntime` — or, with
``--shards N``, a sharded :class:`ServingCluster` — on ``--device``
(the card unless ``--device cpu``), applying the
env-configured ``ingest`` fault (``RQ_FAULT=ingest:mode@batchN``,
``runtime.faultinject``) at the delivery layer where each failure mode
physically lives:

- ``dup``          — batch N delivered twice (lost ack → retransmit);
- ``reorder``      — batches N and N+1 delivered swapped;
- ``drop``         — batch N withheld, redelivered after the first pass
                     (gap → retransmit-on-missing-signal);
- ``torn_journal`` / ``crash_after_apply`` — applied by the RUNTIME
                     itself (``serving.service._apply_one``): a tear of
                     batch N's journal record mid-append + hard exit,
                     or ``os._exit`` right after batch N is applied +
                     journaled (the kill -9 acceptance scenario).  In
                     cluster mode the per-shard runtimes inherit these,
                     so the WHOLE process dies at shard granularity —
                     the first shard to apply sub-batch N exits
                     mid-global-batch, leaving shards at DIFFERENT
                     seqs; ``--resume`` must reconverge them.
- ``crash_in_window`` — the power-loss shape that drops every byte past
                     the group-commit durability watermark (runtime).

Cluster mode additionally honors the ``shard:*`` fault kinds
(``RQ_FAULT=shard:crash|wedge|torn_journal|corrupt_snapshot@shardK
[,batchN]``) applied by the in-process ShardRouter: the DRIVER SURVIVES
those (exit 0) — one fault domain dies and recovers in place while the
others keep serving, which is the chaos acceptance scenario.

``--workers`` moves every shard into its own supervised subprocess
(``serving.worker``; requires ``--shards``) — same directories, same
journals, bit-identical decisions, REAL crash domains, each child on
``--device`` with its own CUDA context.  There the
``worker:kill|hang|eof|garbage@shardK[,batchN]`` kinds apply (each
worker child injures itself at the addressed sub-batch seq); the driver
survives those too (exit 0) — a SIGKILLed worker is restarted under the
RetryPolicy and recovers from its own journal while the survivor
processes keep serving in parallel.

On a clean finish the driver lands ``<dir>/final.json`` — schema
``rq.serving.final/1`` (single) or ``rq.serving.cluster.final/1``
(cluster: cluster + per-shard digests, the partition-independent edge
digest, per-shard journal decision histories, the ``/2`` metrics
report) — everything the acceptance tests compare bitwise between an
uninterrupted run and a faulted/killed+recovered one.  Exit codes: 0
clean (incl. survived shard faults); 17 crash_after_apply (runtime); 19
torn_journal (runtime driver); 23 crash_in_window (runtime — the
power-loss shape consuming the async group-commit durability window).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..runtime import faultinject as _faultinject
from ..runtime import integrity as _integrity
from .cluster import ServingCluster
from .events import EventBatch, synthetic_stream
from .service import ServingRuntime, journal_decisions, recover

__all__ = ["drive", "main", "FINAL_SCHEMA", "CLUSTER_FINAL_SCHEMA",
           "cluster_final_payload"]

FINAL_SCHEMA = "rq.serving.final/1"
CLUSTER_FINAL_SCHEMA = "rq.serving.cluster.final/1"


def _delivery_order(batches: List[EventBatch],
                    fault) -> List[EventBatch]:
    """The shaped first-pass delivery the configured fault implies."""
    order = list(batches)
    if fault is None:
        return order
    idx = {int(b.seq): i for i, b in enumerate(order)}
    n = fault.batch
    if fault.mode == "dup" and n in idx:
        order.insert(idx[n] + 1, order[idx[n]])
    elif fault.mode == "reorder" and n in idx and idx[n] + 1 < len(order):
        i = idx[n]
        order[i], order[i + 1] = order[i + 1], order[i]
    elif fault.mode == "drop" and n in idx:
        dropped = order.pop(idx[n])
        order.append(dropped)  # redelivered after the gap is signalled
    return order


def drive(rt: ServingRuntime, batches: List[EventBatch],
          fault=None, max_retransmit_rounds: int = 4,
          retry_delay_s: float = 0.3) -> None:
    """Deliver ``batches`` (fault-shaped), drain, and retransmit until
    the runtime has applied everything it was offered or the retransmit
    budget is exhausted (then the gap is the caller's to assert on)."""
    import time as _time

    for b in _delivery_order(batches, fault):
        rt.submit(b)
        rt.poll()
    # Retransmit rounds: a real source resends un-acked batches; here
    # "un-acked" is anything past the runtime's applied seq (covers the
    # drop fault's gap and any shed batches once admission reopens).
    for _ in range(max_retransmit_rounds):
        rt.poll()
        missing = [b for b in batches if int(b.seq) > rt.applied_seq]
        if not missing:
            break
        # A real source's retransmit arrives later in wall time; the
        # delay also lets a crashed WORKER pass its RetryPolicy restart
        # gate (the in-process recovery path is synchronous and never
        # needs it — this only runs when batches are actually missing).
        if retry_delay_s:
            _time.sleep(retry_delay_s)
        for b in missing:
            rt.submit(b)
            rt.poll()
    rt.poll()


def _final_payload(rt: ServingRuntime) -> dict:
    return {
        "state_digest": rt.state_digest(),
        "applied_seq": rt.applied_seq,
        "decisions": [
            {"seq": d.seq, "post": d.post,
             "post_time": d.post_time, "intensity": d.intensity}
            for d in journal_decisions(rt.dir)
        ],
        "metrics": rt.metrics.report(pending=rt.pending),
    }


def cluster_final_payload(cl: ServingCluster) -> dict:
    """The cluster run's comparable outcome: per-shard carry digests +
    RETAINED journal decision histories, the whole-cluster digest, and
    the partition-independent edge digest — what the chaos acceptance
    tests compare bitwise between an uninterrupted run and a
    faulted+recovered one (metrics ride along but differ by design:
    they record the recoveries)."""
    digests = cl.shard_digests()
    shards = []
    for k, sdir in enumerate(cl.shard_dirs):
        shards.append({
            "shard": k,
            "n_edges": cl.edges_per_shard[k],
            "digest": digests[k],
            "decisions": [
                {"seq": d.seq, "post": d.post,
                 "post_time": d.post_time, "intensity": d.intensity}
                for d in journal_decisions(sdir)
            ],
        })
    return {
        "cluster_digest": cl.cluster_digest(digests=digests),
        "edge_digest": cl.edge_digest(),
        "applied_seq": cl.applied_seq,
        "n_shards": cl.n_shards,
        "shards": shards,
        "metrics": cl.metrics.report(cl.pending_by_shard,
                                     cl.health_by_shard),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m redqueen_tpu_torch.serving.stream",
        description="drive a deterministic ingest stream through the "
                    "serving runtime (fault-injectable via RQ_FAULT)")
    ap.add_argument("--dir", required=True,
                    help="serving directory (journal + snapshots + "
                         "config + final.json)")
    ap.add_argument("--feeds", type=int, default=8)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--events-per-batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the carries live and the applies run, "
                         "worker children included (default: the card)")
    ap.add_argument("--shards", type=int, default=0,
                    help="run a sharded ServingCluster with N fault "
                         "domains instead of the single-domain runtime "
                         "(0 = single); shard:* faults apply here")
    ap.add_argument("--workers", action="store_true",
                    help="with --shards: place every fault domain in "
                         "its own supervised subprocess (serving."
                         "worker) — real crash domains, parallel "
                         "journal fsyncs; worker:* faults apply here "
                         "(--in-process is the default placement)")
    ap.add_argument("--sockets", action="store_true",
                    help="with --shards: worker subprocesses over "
                         "authenticated TCP (serving.transport) — the "
                         "cross-host placement with reconnect; net:* "
                         "faults apply here")
    ap.add_argument("--in-process", dest="workers", action="store_false",
                    help="keep all shards in this process (default)")
    ap.add_argument("--coalesce", type=int, default=1,
                    help="max micro-batches per device round / journal "
                         "record (the wire-speed apply path; 1 = one "
                         "batch at a time)")
    ap.add_argument("--flush-mode", choices=("sync", "group"),
                    default="sync",
                    help="journal durability mode: sync = fsync before "
                         "ack; group = async group commit with the "
                         "bounded loss window below")
    ap.add_argument("--max-unflushed-records", type=int, default=64,
                    help="group mode: hard record bound of the "
                         "durability window")
    ap.add_argument("--max-flush-delay-ms", type=float, default=50.0,
                    help="group mode: time bound of the durability "
                         "window (background fsync cadence)")
    ap.add_argument("--resume", action="store_true",
                    help="recover from --dir (snapshot + journal "
                         "replay) instead of starting fresh, then "
                         "deliver the full regenerated stream "
                         "(duplicate drop absorbs what already applied)")
    args = ap.parse_args(argv)

    fault = _faultinject.ingest_fault()
    batches = synthetic_stream(args.seed, args.batches, args.feeds,
                               events_per_batch=args.events_per_batch)

    if (args.workers or args.sockets) and not args.shards:
        ap.error("--workers/--sockets need --shards N (worker "
                 "placement is a cluster mode)")
    if args.workers and args.sockets:
        ap.error("--workers and --sockets are exclusive placements")
    if args.shards:
        placement = ("sockets" if args.sockets
                     else "workers" if args.workers else "in-process")
        if args.resume:
            cl, infos = ServingCluster.recover(args.dir,
                                               placement=placement,
                                               device=args.device)
            for k, info in enumerate(infos):
                print(f"recovered shard {k}: "
                      f"snapshot_seq={info.snapshot_seq} "
                      f"replayed={info.replayed} "
                      f"skipped={info.skipped} "
                      f"torn={'yes' if info.torn else 'no'} "
                      f"seq={info.recovered_seq}", file=sys.stderr)
        else:
            cl = ServingCluster(
                n_feeds=args.feeds, n_shards=args.shards, q=args.q,
                seed=args.seed, dir=args.dir,
                snapshot_every=args.snapshot_every,
                reorder_window=args.window,
                queue_capacity=args.queue_capacity,
                coalesce=args.coalesce, flush_mode=args.flush_mode,
                max_unflushed_records=args.max_unflushed_records,
                max_flush_delay_ms=args.max_flush_delay_ms,
                placement=placement, device=args.device)
        with cl:
            drive(cl, batches, fault=fault)
            cl.write_metrics()
            _integrity.write_json(
                os.path.join(args.dir, "final.json"),
                cluster_final_payload(cl),
                schema=CLUSTER_FINAL_SCHEMA)
        return 0

    if args.resume:
        rt, info = recover(args.dir, device=args.device)
        print(f"recovered: snapshot_seq={info.snapshot_seq} "
              f"replayed={info.replayed} skipped={info.skipped} "
              f"torn={'yes' if info.torn else 'no'} "
              f"seq={info.recovered_seq}", file=sys.stderr)
    else:
        rt = ServingRuntime(
            n_feeds=args.feeds, q=args.q, seed=args.seed, dir=args.dir,
            snapshot_every=args.snapshot_every,
            reorder_window=args.window,
            queue_capacity=args.queue_capacity,
            coalesce=args.coalesce, flush_mode=args.flush_mode,
            max_unflushed_records=args.max_unflushed_records,
            max_flush_delay_ms=args.max_flush_delay_ms,
            device=args.device)
    with rt:
        drive(rt, batches, fault=fault)
        rt.write_metrics()
        _integrity.write_json(os.path.join(args.dir, "final.json"),
                              _final_payload(rt), schema=FINAL_SCHEMA)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
