"""Online serving runtime of the port: RedQueen as a service, not a batch
sim (the counterpart of the JAX package's ``redqueen_tpu.serving``).

The paper's algorithm is online — one exponential update per rank
change (WSDM'17) — and this package is its serving shape: persistent
per-edge feed state on the card advanced by ingest micro-batches,
posting decisions returned online, with the integrity envelopes,
checkpoint recovery, edge-health quarantine and deterministic fault
injection made load-bearing:

- :mod:`.events`    — micro-batch types + typed ingest validation
  (:class:`IngestError`);
- :mod:`.ingest`    — duplicate drop + bounded reorder window over
  sequence numbers (:class:`Sequencer`);
- :mod:`.state`     — the per-edge carry (:class:`FeedState`) as PyTorch
  tensors on one device, the micro-batch apply, per-edge health
  quarantine, the canonical carry digest (equal to the JAX package's
  for a bit-identical carry);
- :mod:`.journal`   — crash-safe checksummed append-only journal with
  torn-tail quarantine, sync or async group-commit durability, JSONL
  and binary formats (the JAX package's on-disk formats: a directory
  reads the same in both packages);
- :mod:`.replication` — quorum-replicated group commit
  (:class:`ReplicatedJournal`, :func:`heal_from_replicas`);
- :mod:`.service`   — :class:`ServingRuntime` (bounded queue,
  backpressure, shed accounting, stale-but-served decisions) and
  :func:`recover` (snapshot + journal replay, bit-identical);
- :mod:`.metrics`   — steady-state counters + latency percentiles, the
  enveloped ``rq.serving.metrics/1`` artifact (``/2`` for a cluster);
- :mod:`.paramswap` — the guarded live parameter hot-swap
  (:class:`ParamGate` / :class:`ParamSwapper`) of fit-while-serving;
- :mod:`.cluster`   — sharded fault domains (:class:`ServingCluster`,
  the shard router): per-shard journals, snapshots and sequencers on
  one device, health-aware routing (healthy→degraded→quarantined),
  in-place crash recovery while healthy shards keep serving, and the
  digest-asserted offline :func:`reshard`;
- :mod:`.topology`  — live resharding and follow-graph churn
  (:class:`Migration`, :class:`TopologyState`): the fenced per-range
  handoff, the journaled ``topology.log`` (replayed on recovery), and
  ``add_edges``/``drop_edges``;
- :mod:`.worker`    — a shard as its own process
  (``python -m redqueen_tpu_torch.serving.worker``) over pipes or
  authenticated TCP: on the card each worker holds its own CUDA
  context, and a worker without a card fails its open;
- :mod:`.corpus`    — corpus replay: CSV rows merged into one
  time-ordered stream and served as sequenced micro-batches
  (``python -m redqueen_tpu_torch.serving.corpus``);
- :mod:`.stream`    — the deterministic stream driver / CLI
  (``python -m redqueen_tpu_torch.serving.stream``, single or
  ``--shards N`` with ``--workers``/``--sockets``), where the
  ``RQ_FAULT=ingest:*`` delivery faults are applied.

Every failure mode runs deterministically on the CPU via
``runtime.faultinject``'s ``ingest``, ``shard``, ``worker``, ``net`` and
``reshard`` fault kinds.
"""

from __future__ import annotations

import os as _os

__all__ = [
    "EventBatch", "IngestError", "validate_batch", "synthetic_stream",
    "Sequencer",
    "Journal", "JournalError", "JOURNAL_SCHEMA", "JOURNAL_GROUP_SCHEMA",
    "FLUSH_MODES", "JOURNAL_FORMATS", "journal_format",
    "migrate_to_binary", "durability_info", "tear_tail",
    "GROUP_BODY_MAGIC", "pack_group_body", "unpack_group_body",
    "ParamGate", "ParamSwapper", "ValidatedParams", "GateResult",
    "CANDIDATE_FILENAME", "write_candidate", "read_candidate",
    "params_digest", "spectral_radius",
    "ReplicatedJournal", "heal_from_replicas", "REPLICA_DIR_PREFIX",
    "ServingMetrics", "METRICS_SCHEMA", "ClusterMetrics",
    "CLUSTER_METRICS_SCHEMA",
    "ServingRuntime", "Admission", "RecoveryInfo", "recover",
    "journal_decisions", "CONFIG_SCHEMA",
    "ServingCluster", "ShardRouter", "ClusterAdmission",
    "ClusterDecision", "partition", "shard_seed", "reshard", "RETIRED",
    "CLUSTER_SCHEMA", "RESHARD_SCHEMA",
    "Migration", "TopologyState", "TopologyError", "MigrationInterrupted",
    "MigrationStalled", "TopologyLog", "TOPOLOGY_LOG",
    "read_topology_log", "range_digest", "churn_assign", "plan_moves",
    "PLACEMENTS", "WORKER_PLACEMENTS",
    "FeedState", "Decision", "init_feed_state", "make_apply_fn",
    "make_coalesced_apply_fn", "poison_edge", "state_digest",
    "drive", "FINAL_SCHEMA", "CLUSTER_FINAL_SCHEMA",
    "cluster_final_payload",
]

# ``stream`` is served lazily (PEP 562): an eager import would trip
# runpy's found-in-sys.modules warning on every ``python -m
# redqueen_tpu_torch.serving.stream``.  Everything else in
# ``_LAZY_ATTRS`` (name -> owning submodule) is THE definition of the
# re-exported surface: the eager loop at the bottom and the PEP 562
# fallback both read it, so a new export is added exactly once and
# behaves identically on the normal and the minimal-import
# (RQ_SERVING_WORKER=1 worker-child) path.
_STREAM_NAMES = ("stream", "drive", "FINAL_SCHEMA",
                 "CLUSTER_FINAL_SCHEMA", "cluster_final_payload")
# Never imported eagerly: ``worker``, ``replication`` and ``corpus``
# double as -m entry points (the runpy reason above; replication's
# follower child runs as ``python -m
# redqueen_tpu_torch.serving.replication``) and ``transport`` only
# matters to worker-placement code that imports it by module path
# anyway.  The replication NAMES ride the same lazy path so importing
# the serving package never pays for (or pre-binds) the follower
# entry-point module.
_LAZY_ONLY = ("worker", "transport", "replication", "corpus",
              "ReplicatedJournal", "heal_from_replicas",
              "REPLICA_DIR_PREFIX")
_LAZY_ATTRS = {
    "worker": None, "transport": None, "replication": None,
    "corpus": None,
    "ReplicatedJournal": ".replication",
    "heal_from_replicas": ".replication",
    "REPLICA_DIR_PREFIX": ".replication",
    "cluster": None, "events": None, "ingest": None, "journal": None,
    "metrics": None, "service": None, "state": None,
    "CLUSTER_SCHEMA": ".cluster", "ClusterAdmission": ".cluster",
    "ClusterDecision": ".cluster", "RESHARD_SCHEMA": ".cluster",
    "ServingCluster": ".cluster", "ShardRouter": ".cluster",
    "partition": ".cluster", "reshard": ".cluster",
    "shard_seed": ".cluster", "PLACEMENTS": ".cluster",
    "WORKER_PLACEMENTS": ".cluster", "RETIRED": ".cluster",
    "topology": None,
    "Migration": ".topology", "TopologyState": ".topology",
    "TopologyError": ".topology",
    "MigrationInterrupted": ".topology",
    "MigrationStalled": ".topology",
    "TopologyLog": ".topology", "TOPOLOGY_LOG": ".topology",
    "read_topology_log": ".topology", "range_digest": ".topology",
    "churn_assign": ".topology", "plan_moves": ".topology",
    "EventBatch": ".events", "IngestError": ".events",
    "synthetic_stream": ".events", "validate_batch": ".events",
    "Sequencer": ".ingest",
    "JOURNAL_SCHEMA": ".journal", "Journal": ".journal",
    "JOURNAL_GROUP_SCHEMA": ".journal", "FLUSH_MODES": ".journal",
    "JOURNAL_FORMATS": ".journal", "journal_format": ".journal",
    "migrate_to_binary": ".journal", "durability_info": ".journal",
    "JournalError": ".journal", "tear_tail": ".journal",
    "GROUP_BODY_MAGIC": ".journal", "pack_group_body": ".journal",
    "unpack_group_body": ".journal",
    "paramswap": None,
    "ParamGate": ".paramswap", "ParamSwapper": ".paramswap",
    "ValidatedParams": ".paramswap", "GateResult": ".paramswap",
    "CANDIDATE_FILENAME": ".paramswap",
    "write_candidate": ".paramswap", "read_candidate": ".paramswap",
    "params_digest": ".paramswap", "spectral_radius": ".paramswap",
    "CLUSTER_METRICS_SCHEMA": ".metrics", "ClusterMetrics": ".metrics",
    "METRICS_SCHEMA": ".metrics", "ServingMetrics": ".metrics",
    "Admission": ".service", "CONFIG_SCHEMA": ".service",
    "RecoveryInfo": ".service", "ServingRuntime": ".service",
    "journal_decisions": ".service", "recover": ".service",
    "Decision": ".state", "FeedState": ".state",
    "init_feed_state": ".state", "make_apply_fn": ".state",
    "make_coalesced_apply_fn": ".state",
    "poison_edge": ".state", "state_digest": ".state",
}


def __getattr__(name):
    import importlib

    # import_module (not ``from . import``): the fromlist protocol
    # getattrs the package for the submodule and would re-enter this
    # hook before the import finishes binding the attribute.
    if name in _STREAM_NAMES:
        _stream = importlib.import_module(".stream", __name__)
        if name == "stream":
            return _stream
        return getattr(_stream, name)
    if name in _LAZY_ATTRS:
        target = _LAZY_ATTRS[name]
        if target is None:  # a submodule
            return importlib.import_module("." + name, __name__)
        return getattr(importlib.import_module(target, __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# Worker children (RQ_SERVING_WORKER=1) skip the eager torch-pulling
# imports (cluster -> service -> state -> torch); the package
# __getattr__ above resolves every public name lazily, so the surface
# is identical — a worker subprocess just doesn't PAY for it until its
# shard loads.  See redqueen_tpu_torch/__init__ for the same guard one
# level up.
if not _os.environ.get("RQ_SERVING_WORKER"):
    for _n in _LAZY_ATTRS:
        if _n not in _LAZY_ONLY:
            globals()[_n] = __getattr__(_n)
    del _n
