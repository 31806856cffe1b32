"""Sharded serving fault domains: per-shard journals, health-aware
routing, and crash isolation at corpus scale (the counterpart of the JAX
package's ``serving.cluster``).

One :class:`ServingCluster` partitions the feed-edge state by EDGE HASH
into ``n_shards`` independent fault domains.  Each shard is a full
:class:`~redqueen_tpu_torch.serving.service.ServingRuntime` — its OWN
journal segments, snapshot tree, ``Sequencer``, carry, and health
state under ``<dir>/shard-KKKK/`` — so recovery, torn-tail quarantine,
and overload shedding are decided per shard, never per service: one
wedged apply, torn journal, or killed carry takes down 1/N of the edge
graph while the other shards keep serving.

**Routing (the ShardRouter role).**  ``submit`` validates the global
micro-batch once, splits it by the deterministic edge-hash partition
(:func:`partition` — hash-ordered round-robin dealing, balanced to ±1
edge, pure function of ``(n_feeds, n_shards, PARTITION_VERSION)``), and
offers every shard its sub-batch **under the global sequence number**
(empty slices included) — so each shard's journal is independently
replayable and each shard's decision stream is a pure function of
``(shard carry, global stream)``.  ``poll`` dispatches one sub-batch at
a time per shard with timeout detection, exponential poll-round backoff
for wedged shards, and per-shard health tracking:

    healthy --timeout/transient--> degraded --HEAL_AFTER clean--> healthy
    degraded --QUARANTINE_AFTER consecutive failures--> quarantined
    any --crash / torn journal / journal-append failure--> quarantined
    quarantined --recover_shard (snapshot + digest-asserted replay)-->
        degraded (probation)

**Crash isolation.**  A crashed shard loses exactly what SIGKILL leaves
behind: its in-memory carry, queue, and reorder window die; its fsynced
journal records and snapshots survive.  ``recover_shard`` rebuilds the
shard in place through :func:`serving.service.recover` (newest provable
snapshot + digest-asserted journal replay — bit-identical carry AND
decisions) while healthy shards keep serving; sub-batches offered to a
quarantined shard are shed-with-recorded-seqs (``shed_unavailable``),
and the batches that died un-applied inside the crashed shard are
reclassified ``lost_on_crash`` — the router-side
:class:`~redqueen_tpu_torch.serving.metrics.ClusterMetrics` ledger keeps the
closed accounting identity ``ingested == applied + shed + rejected +
duplicates (+ pending)`` true per shard and cluster-wide at every
instant, including mid-recovery.

**Fault injection.**  Every failure mode runs deterministically in CI on
CPU via ``runtime.faultinject``'s ``shard`` kinds
(``RQ_FAULT=shard:crash|wedge|torn_journal|corrupt_snapshot@shardK
[,batchN]``), applied by the router at exact sub-batch sequence numbers;
:meth:`ServingCluster.kill_shard` is the same teardown as an operator
chaos hook.

**Worker placement (out-of-process shards).**  ``placement="workers"``
moves every fault domain into its own SUBPROCESS
(:mod:`serving.worker`): the shard directory layout, journals,
snapshots, and recovery protocol are unchanged on disk — in-process and
worker placements are interchangeable and bit-identical — but the crash
domain becomes REAL: a SIGSEGV/OOM/SIGKILL in one shard is a child
exit the router observes, not a cluster death, and the N per-shard
journal fsyncs run in N processes in parallel instead of serializing
behind one GIL.  The router drives each worker over the checksummed
frame protocol (:mod:`serving.transport`) with split
``start_*``/``finish_*`` calls, so submits and polls fan out to every
worker before any response is collected — that overlap is the
parallel-serving win.  Failure classification maps transport shapes
onto the SAME health state machine: a request deadline expiry or stale
heartbeat is a timeout (degrade + backoff, quarantine-and-SIGKILL
after ``QUARANTINE_AFTER``), a child exit / pipe EOF is a crash, and a
poisoned byte stream (checksum/magic/desync, or a worker-side error
reply) tears the worker down — never a router crash, never a
silently-trusted payload.  A dead worker is restarted under the
``runtime.supervisor`` :class:`~redqueen_tpu_torch.runtime.supervisor
.RetryPolicy` (crash-loop exponential backoff, give-up →
quarantined-for-the-operator) and recovers IN PLACE from its own
journal while the survivors keep serving.  Worker-level faults
(``RQ_FAULT=worker:kill|hang|eof|garbage@shardK[,batchN]``) are applied
by the worker child itself at exact sub-batch seqs, so the
SIGKILL-a-real-process chaos scenario runs deterministically on CPU.

**Socket placement (cross-host shards).**  ``placement="sockets"``
keeps everything above but moves the frames onto authenticated TCP
(:class:`transport.Listener` per shard, hello token via
``RQ_WORKER_TOKEN``): a worker may run on ANY host that can dial the
router.  The network becomes a first-class failure domain with its own
healing path — a dead LINK is not a dead WORKER: the worker redials
under a deterministic RetryPolicy, the router reattaches the same live
process (pid-matched hello, ``worker_reattach_grace_s``), classifies
the episode as a timeout (degrade → probation), and RESYNCS the
decisions whose response frames the link ate from the worker's bounded
recent-ring (``replay_decisions``) — no journal replay for a mere
partition, and the accounting identity stays closed (a resync and a
salvaged late frame can never double-count: both filter to
still-outstanding seqs).  ``net:drop|delay|partition|reconnect@shardK
[,batchN]`` fault kinds drive every link failure deterministically in
CI; :meth:`partition_shard` is the router-side chaos hook; and
:meth:`remote_worker_commands` + ``SocketWorkerHandle.await_external``
are the remote-spawn recipe.  See docs/DESIGN.md "Durability modes &
the ack contract".

**Wire-speed ingest.**  ``coalesce=K`` + ``flush_mode="group"`` +
:meth:`submit_many` form the high-throughput path:
one frame per round per shard, one device round + one journal
record per round per worker, acks inside an explicit bounded
durability window (``max_unflushed_records`` / ``max_flush_delay_ms``,
recorded by :meth:`durability` in every metrics artifact; a consumed
window is reported per shard as ``lost_in_window`` and healed by
retransmit).

**Reshard (grow without genesis replay).**  :func:`reshard` migrates a
drained N-shard directory to M shards by per-edge state migration: the
per-edge ``(rank, health)`` carry, the cluster clock, and the stream
position move to the new partition, each new shard lands an immediate
snapshot at the migrated seq (recovery never replays from genesis), and
the whole move is **digest-asserted** — the canonical per-edge
:meth:`~ServingCluster.edge_digest` must be bit-identical before and
after, or the reshard raises instead of serving silently-migrated-wrong
state.  Per-shard lifetime counters (``n_events``/``n_posts``) reset at
a reshard (they are fault-domain metrics, not stream state); the stream
position (``seq``/``n_batches``) migrates.

**Elastic topology (live resharding + graph churn).**
:meth:`begin_reshard` grows the cluster N→M shards UNDER TRAFFIC via
:mod:`serving.topology`: a journaled, resumable migration plan moves
feed ranges one at a time through a two-phase fence→install→flip
handoff — the source shard is fenced (admissions touching it refuse
with status ``"fenced"`` and retransmit after the flip), the carry
slice streams to a pre-sized fresh destination as a digest-asserted
``install_range`` journal record, and the router flips ownership via a
fsynced topology-epoch record in ``topology.log``.  SIGKILL of source,
destination, or router mid-migration resumes from the last fenced
range (``resume_migration``), with the per-range digest asserted
bit-identical across the outage; :meth:`ServingCluster.recover`
replays the topology log exactly like param epochs.  ``add_edges`` /
``drop_edges`` are journaled live graph churn on the same substrate;
``reshard:kill_src|kill_dst|kill_router|wedge|torn_plan@rangeK``
fault kinds drive every interruption deterministically in CI.  See
docs/DESIGN.md "Elastic topology & live resharding".

**Device.**  Every shard's carry and apply live on the cluster's
``device`` (the card unless ``device="cpu"``): in process, each
runtime is built there; under worker placement, each child is started
with ``--device`` and resolves it when it opens or recovers its shard,
so one card holds K shard processes, each with its own CUDA context.
A child that finds no card fails its open with the reason — it never
serves on the CPU.  The device is not part of the directory:
``cluster.json`` does not name it, and a cluster directory reads the
same in both packages (snapshots aside: each package reads only its own
snapshot format, so a directory crosses packages with snapshots off).

See docs/DESIGN.md "Sharded serving & fault domains".
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..runtime import faultinject as _faultinject
from ..runtime import integrity as _integrity
from ..runtime import telemetry as _telemetry
from ..runtime.supervisor import RetryPolicy
from . import topology as _topology
from .events import EventBatch, IngestError, validate_batch
from .metrics import ClusterMetrics
from .service import (RecoveryInfo, ServingRuntime, SNAPSHOTS_DIRNAME,
                      _CONFIG as _SHARD_CONFIG,
                      recover as _recover_runtime)
from .topology import TopologyError
from .transport import TransportEOF, TransportError, TransportTimeout

# NOTE: serving.worker is imported lazily (in _spawn_worker) — it
# doubles as a ``python -m`` entry point, and an eager import here
# would trip runpy's found-in-sys.modules warning on every manual
# invocation.

__all__ = ["ServingCluster", "ShardRouter", "ClusterAdmission",
           "ClusterDecision", "partition", "shard_seed", "reshard",
           "CLUSTER_SCHEMA", "RESHARD_SCHEMA", "PARTITION_VERSION",
           "PLACEMENTS", "WORKER_PLACEMENTS", "HEALTHY", "DEGRADED",
           "QUARANTINED", "RETIRED", "HEAL_AFTER", "QUARANTINE_AFTER",
           "WEDGE_FIRES", "MAX_BACKOFF_ROUNDS",
           "DEFAULT_RESTART_POLICY"]

CLUSTER_SCHEMA = "rq.serving.cluster/1"
RESHARD_SCHEMA = "rq.serving.reshard/1"
_CLUSTER_CONFIG = "cluster.json"

# Bump when the partition function changes: a directory written under a
# different partition CANNOT be reopened (edges would silently route to
# the wrong journals) — the config check refuses instead.
PARTITION_VERSION = 1

# Health states + state-machine constants (see the module docstring).
HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
# A migration source that shed its last feed: its directory and journal
# stay on disk (history), but it owns no edges, receives no traffic,
# and is never auto-recovered.  Terminal — distinct from QUARANTINED so
# reads don't count a retired slot as degraded serving.
RETIRED = "retired"
HEAL_AFTER = 3          # consecutive clean applies: degraded -> healthy
QUARANTINE_AFTER = 3    # consecutive timeouts: degraded -> quarantined
WEDGE_FIRES = 2         # injected-wedge timeouts before the stall clears
MAX_BACKOFF_ROUNDS = 8  # cap on the wedged-shard poll-round backoff
RECOVERY_GIVE_UP = 3    # failed auto-recoveries before poll() raises

# Shard placement modes: every fault domain lives in the router's
# process ("in-process"), in its own supervised subprocess over
# pipes ("workers"), or in a subprocess over an authenticated TCP
# connection ("sockets" — same frame protocol, plus reconnect: the
# cross-host placement, where a shard worker may run on ANY host that
# can dial the router's per-shard listener).  Interchangeable on disk —
# NOT part of the directory identity.
PLACEMENTS = ("in-process", "workers", "sockets")
# The placements whose shards live out of process (drive WorkerHandle
# surfaces over frames).
WORKER_PLACEMENTS = ("workers", "sockets")

# Worker restart schedule (placement="workers"): the runtime.supervisor
# RetryPolicy drives the crash-loop backoff — restart n of a crash
# streak waits delay(n), and max_attempts consecutive FAILED recoveries
# is the give-up bound (the shard stays quarantined and poll() raises
# for the operator).  seed=0: the jitter — and with it the whole chaos
# timeline — is deterministic in CI.
DEFAULT_RESTART_POLICY = RetryPolicy(
    max_attempts=RECOVERY_GIVE_UP, base_delay_s=0.25, multiplier=2.0,
    max_delay_s=10.0, jitter=0.1, seed=0)
_CRASH_STREAK_CAP = 10  # backoff exponent cap (delay saturates anyway)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 (vectorized; wraparound is the
    point)."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def partition(n_feeds: int, n_shards: int) -> np.ndarray:
    """``assign[feed] = owning shard``: edges are ordered by their
    splitmix64 hash, then dealt round-robin — decorrelated from feed-id
    locality like a plain ``hash % N`` but balanced BY CONSTRUCTION
    (shard sizes differ by at most one edge, so no shard can come up
    empty while ``n_shards <= n_feeds``).  Pure function of
    ``(n_feeds, n_shards)`` under :data:`PARTITION_VERSION`."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > n_feeds:
        raise ValueError(
            f"n_shards={n_shards} > n_feeds={n_feeds}: every shard must "
            f"own at least one edge")
    h = _mix64(np.arange(n_feeds, dtype=np.uint64))
    order = np.argsort(h, kind="stable")
    assign = np.empty(n_feeds, np.int64)
    assign[order] = np.arange(n_feeds, dtype=np.int64) % n_shards
    return assign


def shard_seed(seed: int, shard: int) -> int:
    """Deterministic per-shard PRNG seed derivation — distinct shards
    must draw from distinct decision streams (never reuse one key
    across independent consumers)."""
    return (int(seed) * 1_000_003 + 7_919 * (int(shard) + 1)) \
        % (2 ** 31 - 1)


class ClusterAdmission(NamedTuple):
    """One global ``submit``'s outcome: ``status`` summarizes
    (``accepted`` = every shard accepted or acked a duplicate;
    ``partial`` = at least one shard shed / was unavailable / rejected;
    ``shed`` = no shard kept it; ``rejected`` = failed global
    validation before fan-out); ``per_shard`` is the exact per-shard
    admission status list."""

    status: str
    seq: Optional[int] = None
    backpressure: bool = False
    reason: Optional[str] = None
    per_shard: Tuple[str, ...] = ()


class ClusterDecision(NamedTuple):
    """The cluster read path's aggregate: summed intensity over the
    shards that have decided, ``post`` if any shard's latest decision
    posted, total unapplied backlog as staleness, and how many fault
    domains are reporting vs quarantined (degraded-serving visibility,
    never a blocked read)."""

    seq: int                 # min applied seq over reporting shards
    post: bool
    intensity: float
    stale_batches: int
    shards_reporting: int
    shards_quarantined: int


class _ShardSlot:
    """One fault domain's router-side bookkeeping (the runtime itself is
    replaced wholesale on crash/recovery; this slot identity persists)."""

    __slots__ = ("k", "dir", "feeds", "s_slice", "runtime", "health",
                 "fail_streak", "clean_streak", "skip_rounds",
                 "recover_failures", "crash_streak", "restart_at",
                 "outstanding", "listener", "acked_seq", "retired",
                 "start_seq")

    def __init__(self, k: int, dir: Optional[str], feeds: np.ndarray,
                 s_slice: np.ndarray, start_seq: int = 0):
        self.k = k
        self.dir = dir
        # Global feed ids this slot's RUNTIME carries (ascending) — the
        # shard geometry.  Ownership can be narrower: a migration
        # source keeps its geometry until it retires, but the router's
        # ``_owner`` map (flipped per range) decides routing.
        self.feeds = feeds
        self.s_slice = s_slice
        # The stream position this slot's runtime was born at — genesis
        # slots share the cluster start_seq; a migration destination
        # starts at the fence watermark + 1.
        self.start_seq = int(start_seq)
        # Terminal migrated-away state (see RETIRED).
        self.retired = False
        # Socket placement: the per-shard accept point (survives worker
        # restarts — the replacement dials the same address).
        self.listener: Optional[Any] = None
        # Highest seq OBSERVED applied (the ack watermark): what the
        # group-commit loss report compares against at recovery.
        self.acked_seq = -1
        # In-process: a ServingRuntime.  Worker placement: a
        # WorkerHandle presenting the same surface over the frame
        # protocol.  None = quarantined (no live fault domain).
        self.runtime: Optional[Any] = None
        self.health = HEALTHY
        self.fail_streak = 0
        self.clean_streak = 0
        self.skip_rounds = 0
        self.recover_failures = 0
        self.crash_streak = 0       # consecutive crashes since last heal
        self.restart_at = 0.0       # worker restart gate (RetryPolicy)
        # seq -> (arrival stamp, n_events): accepted but not yet applied
        # (mirrors the shard's queue + reorder window; reclassified
        # lost_on_crash if the carry dies under them)
        self.outstanding: Dict[int, Tuple[float, int]] = {}


class ServingCluster:
    """See the module docstring.  Single-writer like the per-shard
    runtime: one process owns the cluster directory."""

    def __init__(self, n_feeds: int, n_shards: int,
                 dir: Optional[str] = None, q: float = 1.0,
                 s_sink: Optional[np.ndarray] = None, seed: int = 0,
                 start_seq: int = 0, snapshot_every: int = 8,
                 reorder_window: int = 8, queue_capacity: int = 64,
                 max_batch_events: int = 256, fsync_every_n: int = 1,
                 flush_mode: str = "sync",
                 max_unflushed_records: int = 64,
                 max_flush_delay_ms: float = 50.0, coalesce: int = 1,
                 journal_format: Optional[str] = None,
                 replication_factor: int = 0,
                 replication_quorum: Optional[int] = None,
                 replication_mode: str = "thread",
                 placement: str = "in-process",
                 restart_policy: Optional[RetryPolicy] = None,
                 worker_request_timeout_s: float = 30.0,
                 worker_open_timeout_s: float = 300.0,
                 worker_heartbeat_every_s: float = 1.0,
                 worker_heartbeat_timeout_s: float = 30.0,
                 worker_read_timeout_s: float = 5.0,
                 worker_reattach_grace_s: float = 8.0,
                 listen_host: str = "127.0.0.1",
                 token: Optional[str] = None,
                 external_workers: bool = False,
                 clock=time.monotonic,
                 auto_recover: bool = True, _open_runtimes: bool = True,
                 device: DeviceLike = "cuda"):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {placement!r}")
        if placement in WORKER_PLACEMENTS and dir is None:
            raise ValueError(
                f"placement={placement!r} needs a cluster directory — a "
                f"worker subprocess owns its shard's on-disk state; an "
                f"in-memory fault domain cannot leave the process")
        # Where every shard's carry lives (raises without a card unless
        # device="cpu"); worker children get it as --device.
        self.device = resolve_device(device)
        self.n_feeds = int(n_feeds)
        self.n_shards = int(n_shards)
        self.dir = dir
        self.q = float(q)
        self.seed = int(seed)
        self.start_seq = int(start_seq)
        self.snapshot_every = int(snapshot_every)
        self.reorder_window = int(reorder_window)
        self.queue_capacity = int(queue_capacity)
        self.max_batch_events = int(max_batch_events)
        if int(fsync_every_n) < 1:
            raise ValueError(
                f"fsync_every_n must be >= 1, got {fsync_every_n}")
        self.fsync_every_n = int(fsync_every_n)
        from .journal import FLUSH_MODES as _FLUSH_MODES

        if flush_mode not in _FLUSH_MODES:
            raise ValueError(f"flush_mode must be one of "
                             f"{_FLUSH_MODES}, got {flush_mode!r}")
        self.flush_mode = str(flush_mode)
        self.max_unflushed_records = int(max_unflushed_records)
        self.max_flush_delay_ms = float(max_flush_delay_ms)
        if int(coalesce) < 1:
            raise ValueError(f"coalesce must be >= 1, got {coalesce}")
        self.coalesce = int(coalesce)
        if int(replication_factor) < 0:
            raise ValueError(f"replication_factor must be >= 0, got "
                             f"{replication_factor}")
        self.journal_format = journal_format
        self.replication_factor = int(replication_factor)
        self.replication_quorum = (None if replication_quorum is None
                                   else int(replication_quorum))
        self.replication_mode = str(replication_mode)
        self.placement = placement
        self.restart_policy = restart_policy or DEFAULT_RESTART_POLICY
        self._restart_rng = self.restart_policy.rng()
        self.worker_request_timeout_s = float(worker_request_timeout_s)
        self.worker_open_timeout_s = float(worker_open_timeout_s)
        self.worker_heartbeat_every_s = float(worker_heartbeat_every_s)
        self.worker_heartbeat_timeout_s = float(
            worker_heartbeat_timeout_s)
        self.worker_read_timeout_s = float(worker_read_timeout_s)
        self.worker_reattach_grace_s = float(worker_reattach_grace_s)
        self.listen_host = str(listen_host)
        # The per-cluster socket credential: hello frames must carry it
        # (and, on reattach, the same pid) or the connection is refused.
        self.token = (token if token is not None
                      else os.urandom(16).hex())
        if external_workers and placement != "sockets":
            raise ValueError(
                f"external_workers=True needs placement='sockets' "
                f"(only a TCP listener can adopt a worker someone else "
                f"spawned), got placement={placement!r}")
        self.external_workers = bool(external_workers)
        self.auto_recover = bool(auto_recover)
        self._clock = clock
        s = (np.ones(n_feeds) if s_sink is None
             else np.asarray(s_sink, np.float64))
        if s.shape != (self.n_feeds,):
            raise ValueError(
                f"s_sink must have shape ({n_feeds},), got {s.shape}")
        # Router-side copy of the global baseline sink vector (each
        # runtime holds its own live slice) — grows with add_edges.
        self._sink = s

        self._assign = partition(self.n_feeds, self.n_shards)
        # Live ownership map: assign is the GENESIS partition (part of
        # the directory identity, immutable); _owner is what routing
        # uses, rewritten by journaled topology flips (-1 = dropped
        # edge, -2 = added edge awaiting its slot attach).
        self._owner = self._assign.copy()
        # local index of each global feed within its owning shard
        self._local_index = np.empty(self.n_feeds, np.int32)
        self._slots: List[_ShardSlot] = []
        for k in range(self.n_shards):
            feeds = np.flatnonzero(self._assign == k)
            self._local_index[feeds] = np.arange(len(feeds),
                                                 dtype=np.int32)
            sdir = (None if dir is None
                    else os.path.join(dir, f"shard-{k:04d}"))
            self._slots.append(_ShardSlot(k, sdir, feeds, s[feeds],
                                          start_seq=self.start_seq))
        # Elastic-topology protocol state + journal (serving.topology);
        # the log opens lazily on the first topology mutation.
        self._topo = _topology.TopologyState()
        self._topo_log: Optional[_topology.TopologyLog] = None

        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._check_or_write_config()
            tlog = os.path.join(dir, _topology.TOPOLOGY_LOG)
            if _open_runtimes and os.path.exists(tlog) \
                    and os.path.getsize(tlog) > 0:
                raise ValueError(
                    f"cluster dir {dir} carries topology records — its "
                    f"shard layout evolved past the genesis config "
                    f"this constructor would build; use "
                    f"ServingCluster.recover({dir!r}) instead")

        self.metrics = ClusterMetrics(self.n_shards, clock=clock)
        self._fault = _faultinject.shard_fault()
        if self._fault is not None and self._fault.shard >= self.n_shards:
            # faultinject's contract: a spec that can never fire dies
            # loudly, not as a vacuously-green chaos run.
            raise ValueError(
                f"RQ_FAULT targets shard {self._fault.shard} but this "
                f"cluster has {self.n_shards} shard(s) (valid: 0.."
                f"{self.n_shards - 1}) — the fault could never fire")
        if self._fault is not None and self._worker_mode:
            raise ValueError(
                f"RQ_FAULT=shard:{self._fault.mode} is applied by the "
                f"IN-PROCESS router and could never fire under "
                f"placement={self.placement!r} — use the worker:* kinds "
                f"(the worker child injures itself at the same seqs)")
        wfault = _faultinject.worker_fault()
        if wfault is not None:
            if not self._worker_mode:
                raise ValueError(
                    f"RQ_FAULT=worker:{wfault.mode} targets an "
                    f"out-of-process shard worker but this cluster runs "
                    f"placement={self.placement!r} — the fault could "
                    f"never fire")
            if wfault.shard >= self.n_shards:
                raise ValueError(
                    f"RQ_FAULT targets worker shard {wfault.shard} but "
                    f"this cluster has {self.n_shards} shard(s) (valid: "
                    f"0..{self.n_shards - 1}) — the fault could never "
                    f"fire")
        nfault = _faultinject.net_fault()
        if nfault is not None:
            if self.placement != "sockets":
                raise ValueError(
                    f"RQ_FAULT=net:{nfault.mode} targets a SOCKET "
                    f"worker's connection but this cluster runs "
                    f"placement={self.placement!r} — the fault could "
                    f"never fire (pipes cannot partition)")
            if nfault.shard >= self.n_shards:
                raise ValueError(
                    f"RQ_FAULT targets net shard {nfault.shard} but "
                    f"this cluster has {self.n_shards} shard(s) (valid: "
                    f"0..{self.n_shards - 1}) — the fault could never "
                    f"fire")
        self._fault_spent = False
        self._wedge_left = WEDGE_FIRES

        if _open_runtimes:
            if self.external_workers:
                # The operator's workers dial in later
                # (adopt_external_worker); create the listeners now so
                # remote_worker_commands() can print the addresses.
                from .transport import Listener

                for slot in self._slots:
                    slot.listener = Listener(host=self.listen_host,
                                             clock=self._clock)
            elif self._worker_mode:
                self._open_workers(recover=False)
            else:
                for slot in self._slots:
                    slot.runtime = self._fresh_runtime(slot)

    @property
    def _worker_mode(self) -> bool:
        """True when shards live out of process (pipe or socket
        placement) — the router drives WorkerHandle surfaces."""
        return self.placement in WORKER_PLACEMENTS

    # ---- construction / config identity ----

    def _config(self) -> Dict[str, Any]:
        return {
            "n_feeds": self.n_feeds, "n_shards": self.n_shards,
            "q": self.q, "s_sink": [float(x) for x in self._sink],
            "seed": self.seed, "start_seq": self.start_seq,
            "snapshot_every": self.snapshot_every,
            "reorder_window": self.reorder_window,
            "queue_capacity": self.queue_capacity,
            "max_batch_events": self.max_batch_events,
            "partition_version": PARTITION_VERSION,
            # Durability/throughput knobs — recorded so recover()
            # reuses them, EXCLUDED from the identity refusal below:
            # group commit changes when records hit media and coalescing
            # changes how many batches share a dispatch/record, never
            # what either says.  (placement is likewise not identity:
            # in-process, worker, and socket modes are interchangeable
            # over the same directory, and so is the device.)
            "fsync_every_n": self.fsync_every_n,
            "flush_mode": self.flush_mode,
            "max_unflushed_records": self.max_unflushed_records,
            "max_flush_delay_ms": self.max_flush_delay_ms,
            "coalesce": self.coalesce,
            # Likewise non-identity: the journal encoding and the
            # replication group shape change where/when records
            # persist, never what they say.
            "journal_format": self.journal_format,
            "replication_factor": self.replication_factor,
            "replication_quorum": self.replication_quorum,
            "replication_mode": self.replication_mode,
        }

    def _check_or_write_config(self) -> None:
        cfg_path = os.path.join(self.dir, _CLUSTER_CONFIG)
        cfg = self._config()
        if os.path.exists(cfg_path):
            # Same refusal contract as the per-shard config: the stored
            # config is the directory's identity — a silently different
            # partition/seed would route edges into the wrong journals.
            stored = _integrity.read_json(cfg_path, schema=CLUSTER_SCHEMA)
            for field in ("n_feeds", "n_shards", "q", "s_sink", "seed",
                          "start_seq", "max_batch_events",
                          "partition_version"):
                if stored.get(field) != cfg[field]:
                    raise ValueError(
                        f"cluster dir {self.dir} was created with "
                        f"{field}={stored.get(field)!r} but this cluster "
                        f"was constructed with {field}={cfg[field]!r} — "
                        f"edges would route to the wrong shards / replay "
                        f"would diverge; recover() with the stored "
                        f"config, reshard(), or use a fresh directory")
        else:
            _integrity.write_json(cfg_path, cfg, schema=CLUSTER_SCHEMA)

    def _fresh_runtime(self, slot: _ShardSlot) -> ServingRuntime:
        return ServingRuntime(
            n_feeds=len(slot.feeds), q=self.q, s_sink=slot.s_slice,
            seed=shard_seed(self.seed, slot.k), dir=slot.dir,
            start_seq=slot.start_seq, snapshot_every=self.snapshot_every,
            reorder_window=self.reorder_window,
            queue_capacity=self.queue_capacity,
            max_batch_events=self.max_batch_events,
            fsync_every_n=self.fsync_every_n,
            flush_mode=self.flush_mode,
            max_unflushed_records=self.max_unflushed_records,
            max_flush_delay_ms=self.max_flush_delay_ms,
            coalesce=self.coalesce,
            journal_format=self.journal_format,
            replication_factor=self.replication_factor,
            replication_quorum=self.replication_quorum,
            replication_mode=self.replication_mode, clock=self._clock,
            device=self.device)

    # ---- worker placement plumbing ----

    def _worker_config(self, slot: _ShardSlot) -> Dict[str, Any]:
        """The ``open`` request payload — the exact ServingRuntime
        constructor args :meth:`_fresh_runtime` would use, so the two
        placements build bit-identical shard state."""
        return {"n_feeds": int(len(slot.feeds)), "q": self.q,
                "s_sink": [float(x) for x in slot.s_slice],
                "seed": shard_seed(self.seed, slot.k),
                "start_seq": slot.start_seq,
                "snapshot_every": self.snapshot_every,
                "reorder_window": self.reorder_window,
                "queue_capacity": self.queue_capacity,
                "max_batch_events": self.max_batch_events,
                "fsync_every_n": self.fsync_every_n,
                "flush_mode": self.flush_mode,
                "max_unflushed_records": self.max_unflushed_records,
                "max_flush_delay_ms": self.max_flush_delay_ms,
                "coalesce": self.coalesce,
                "journal_format": self.journal_format,
                "replication_factor": self.replication_factor,
                "replication_quorum": self.replication_quorum,
                "replication_mode": self.replication_mode}

    def _spawn_worker(self, slot: _ShardSlot) -> "WorkerHandle":  # noqa: F821
        from .worker import SocketWorkerHandle, WorkerHandle

        if self.placement == "sockets":
            if slot.listener is None:
                from .transport import Listener

                slot.listener = Listener(host=self.listen_host,
                                         clock=self._clock)
            return SocketWorkerHandle.spawn_socket(
                slot.dir, slot.k, slot.listener, self.token,
                heartbeat_every_s=self.worker_heartbeat_every_s,
                request_timeout_s=self.worker_request_timeout_s,
                open_timeout_s=self.worker_open_timeout_s,
                read_timeout_s=self.worker_read_timeout_s,
                clock=self._clock, device=str(self.device))
        return WorkerHandle.spawn(
            slot.dir, slot.k,
            heartbeat_every_s=self.worker_heartbeat_every_s,
            request_timeout_s=self.worker_request_timeout_s,
            open_timeout_s=self.worker_open_timeout_s,
            read_timeout_s=self.worker_read_timeout_s,
            clock=self._clock, device=str(self.device))

    def remote_worker_commands(self) -> List[Dict[str, Any]]:
        """The REMOTE-SPAWN recipe (socket placement): one entry per
        shard — the argv to run on any host that can reach this
        router's listeners, plus the env var carrying the cluster token
        (value supplied out of band, never printed).  The shard
        directory path in the argv is as THIS host sees it; a remote
        worker needs the same path visible (shared filesystem) or a
        synced copy."""
        if self.placement != "sockets":
            raise ValueError(
                f"remote spawn needs placement='sockets', this cluster "
                f"runs {self.placement!r}")
        from .transport import Listener
        from .worker import SocketWorkerHandle

        out = []
        for slot in self._slots:
            if slot.listener is None:
                slot.listener = Listener(host=self.listen_host,
                                         clock=self._clock)
            out.append({
                "shard": slot.k,
                **SocketWorkerHandle.remote_command(
                    slot.dir, slot.k, slot.listener.address,
                    self.worker_heartbeat_every_s,
                    device=str(self.device))})
        return out

    def _open_workers(self, recover: bool) -> List[RecoveryInfo]:
        """Spawn one worker per shard and open/recover them ALL in
        flight (the fan-out parallelism the placement exists for: N
        torch imports + CUDA context starts overlap instead of
        serializing).
        Any failure tears every worker down and raises — a cluster
        must come up whole or not at all."""
        infos: List[RecoveryInfo] = []
        procs: List[Any] = []
        try:
            if self.placement == "sockets":
                # Launch ALL children first, then accept each hello —
                # interpreter start + package import + dial overlap
                # across shards (the same in-flight discipline the
                # open/recover fan-out below uses).
                from .transport import Listener
                from .worker import SocketWorkerHandle

                live = [s for s in self._slots if not s.retired]
                for slot in live:
                    if slot.listener is None:
                        slot.listener = Listener(host=self.listen_host,
                                                 clock=self._clock)
                    procs.append(SocketWorkerHandle.launch(
                        slot.dir, slot.k, slot.listener, self.token,
                        heartbeat_every_s=self.worker_heartbeat_every_s,
                        device=str(self.device)))
                for slot, proc in zip(live, procs):
                    slot.runtime = SocketWorkerHandle.from_child(
                        proc, slot.k, slot.listener, self.token,
                        request_timeout_s=self.worker_request_timeout_s,
                        open_timeout_s=self.worker_open_timeout_s,
                        read_timeout_s=self.worker_read_timeout_s,
                        clock=self._clock)
            else:
                for slot in self._slots:
                    if slot.retired:
                        continue
                    slot.runtime = self._spawn_worker(slot)
            pending = []
            for slot in self._slots:
                if slot.retired:
                    continue
                h = slot.runtime
                # A slot journaled into existence mid-migration whose
                # process died before the runtime wrote config.json has
                # nothing on disk to recover — it opens fresh and the
                # resumed migration re-streams its ranges.
                use_rec = recover and slot.dir is not None \
                    and os.path.exists(
                        os.path.join(slot.dir, _SHARD_CONFIG))
                pending.append((slot, use_rec,
                                h.start_recover() if use_rec
                                else h.start_open(
                                    self._worker_config(slot))))
            for slot, use_rec, rid in pending:
                if use_rec:
                    infos.append(slot.runtime.finish_recover(rid))
                else:
                    slot.runtime.finish_open(rid)
        except (TransportError, OSError) as e:
            for slot in self._slots:
                if slot.runtime is not None:
                    slot.runtime.kill()
                    slot.runtime = None
            for proc in procs:
                # launched-but-never-adopted children (the adopt loop
                # raised before reaching them) must not outlive the
                # failed open
                if proc.poll() is None:
                    try:
                        proc.kill()
                    except OSError:
                        pass
            raise RuntimeError(
                f"worker cluster failed to "
                f"{'recover' if recover else 'open'}: "
                f"{type(e).__name__}: {e}") from e
        return infos

    @classmethod
    def recover(cls, dir: str, clock=time.monotonic,
                auto_recover: bool = True,
                placement: str = "in-process",
                restart_policy: Optional[RetryPolicy] = None,
                worker_request_timeout_s: float = 30.0,
                worker_open_timeout_s: float = 300.0,
                worker_heartbeat_every_s: float = 1.0,
                worker_heartbeat_timeout_s: float = 30.0,
                worker_read_timeout_s: float = 5.0,
                device: DeviceLike = "cuda",
                ) -> Tuple["ServingCluster", List[RecoveryInfo]]:
        """Rebuild a cluster from its directory after a crash: read the
        enveloped cluster config, then :func:`serving.service.recover`
        EVERY shard fault domain independently (each one = newest
        provable snapshot + digest-asserted journal replay).  Shards
        killed at different points recover to different seqs; the
        source's retransmit of everything past :attr:`applied_seq`
        (the cluster min) reconverges them — duplicate drop absorbs the
        rest.  ``placement`` picks where the recovered shards live (the
        directory does not care — either placement recovers the other's
        state bit-identically); with ``"workers"`` every shard recovers
        in its own subprocess, all in flight.  ``device`` is where the
        recovered shards serve (the card unless ``device="cpu"``); the
        directory does not name one."""
        cfg = _integrity.read_json(os.path.join(dir, _CLUSTER_CONFIG),
                                   schema=CLUSTER_SCHEMA)
        if cfg.get("partition_version") != PARTITION_VERSION:
            raise ValueError(
                f"cluster dir {dir} uses partition_version="
                f"{cfg.get('partition_version')!r}, this code is "
                f"{PARTITION_VERSION} — reshard() with the old code "
                f"first")
        cl = cls(n_feeds=int(cfg["n_feeds"]),
                 n_shards=int(cfg["n_shards"]), dir=dir,
                 q=float(cfg["q"]),
                 s_sink=np.asarray(cfg["s_sink"], np.float64),
                 seed=int(cfg["seed"]), start_seq=int(cfg["start_seq"]),
                 snapshot_every=int(cfg["snapshot_every"]),
                 reorder_window=int(cfg["reorder_window"]),
                 queue_capacity=int(cfg["queue_capacity"]),
                 max_batch_events=int(cfg["max_batch_events"]),
                 fsync_every_n=int(cfg.get("fsync_every_n", 1)),
                 flush_mode=str(cfg.get("flush_mode", "sync")),
                 max_unflushed_records=int(
                     cfg.get("max_unflushed_records", 64)),
                 max_flush_delay_ms=float(
                     cfg.get("max_flush_delay_ms", 50.0)),
                 coalesce=int(cfg.get("coalesce", 1)),
                 placement=placement, restart_policy=restart_policy,
                 worker_request_timeout_s=worker_request_timeout_s,
                 worker_open_timeout_s=worker_open_timeout_s,
                 worker_heartbeat_every_s=worker_heartbeat_every_s,
                 worker_heartbeat_timeout_s=worker_heartbeat_timeout_s,
                 worker_read_timeout_s=worker_read_timeout_s,
                 clock=clock, auto_recover=auto_recover,
                 _open_runtimes=False, device=device)
        # Replay the topology log BEFORE opening runtimes: every slot
        # added / ownership flip / retirement since genesis re-applies
        # in journal order (the param-epoch replay pattern, lifted to
        # the shard layout itself).
        records, _torn = _topology.read_topology_log(
            os.path.join(dir, _topology.TOPOLOGY_LOG))
        for rec in records:
            cl._apply_topo_record(rec, recovering=True)
        if placement in WORKER_PLACEMENTS:
            return cl, cl._open_workers(recover=True)
        infos: List[RecoveryInfo] = []
        for slot in cl._slots:
            if slot.retired:
                continue
            if os.path.exists(os.path.join(slot.dir, _SHARD_CONFIG)):
                rt, info = _recover_runtime(slot.dir, clock=clock,
                                            device=cl.device)
                slot.runtime = rt
                infos.append(info)
            else:
                # Journaled into existence but crashed before its
                # runtime persisted anything — open fresh; the resumed
                # migration re-streams whatever it was owed.
                slot.runtime = cl._fresh_runtime(slot)
        return cl, infos

    # ---- routing: the ingest path ----

    def _split_batch(self, batch: EventBatch) -> List[EventBatch]:
        """One sub-batch per shard in ONE pass over the events (a
        per-shard boolean mask would make the measured ingest path
        O(n_shards x events) per global batch): stable-sort the events
        by owning shard — intra-shard event order is preserved — and
        slice the contiguous runs."""
        seq = int(batch.seq)
        if len(batch.feeds) == 0:
            empty = EventBatch(seq, np.empty(0, np.float64),
                               np.empty(0, np.int32))
            return [empty] * self.n_shards
        assign = self._owner[batch.feeds]
        order = np.argsort(assign, kind="stable")
        times_s = batch.times[order]
        local_s = self._local_index[batch.feeds[order]]
        bounds = np.searchsorted(assign[order],
                                 np.arange(self.n_shards + 1))
        return [EventBatch(seq, times_s[bounds[k]:bounds[k + 1]],
                           local_s[bounds[k]:bounds[k + 1]])
                for k in range(self.n_shards)]

    def submit(self, batch: EventBatch) -> ClusterAdmission:
        """Admit one GLOBAL micro-batch: validate once, fan out one
        sub-batch per shard under the global seq (empty slices included
        — every shard's journal tracks the full stream position).  Never
        raises on bad input; a quarantined shard's slice is shed with
        its seq recorded (``shed_unavailable``) so the source
        retransmits it after recovery."""
        with _telemetry.span("cluster.submit") as tsp:
            adm = self._submit(batch)
            tsp.set(status=adm.status)
            return adm

    def _submit(self, batch: EventBatch) -> ClusterAdmission:
        try:
            batch = validate_batch(batch, self.n_feeds,
                                   max_events=self.max_batch_events)
        except IngestError as e:
            # Rejected before fan-out: one rejected sub-outcome per
            # shard keeps the ledger's sub-batch units uniform.
            self.metrics.global_rejected += 1
            for k in range(self.n_shards):
                self.metrics.observe_submitted(k)
                self.metrics.observe_rejected(k)
            return ClusterAdmission(
                "rejected", seq=e.seq, reason=str(e),
                per_shard=("rejected",) * self.n_shards)
        reason = self._route_block(batch)
        if reason is not None:
            if reason.startswith("fenced"):
                # Refused BEFORE fan-out: nothing entered any shard
                # ledger, so the closed accounting identity is
                # untouched — the source just retransmits after the
                # flip lands.
                self.metrics.observe_fenced_retry()
                return ClusterAdmission("fenced", seq=int(batch.seq),
                                        reason=reason)
            self.metrics.global_rejected += 1
            for k in range(self.n_shards):
                self.metrics.observe_submitted(k)
                self.metrics.observe_rejected(k)
            return ClusterAdmission(
                "rejected", seq=int(batch.seq), reason=reason,
                per_shard=("rejected",) * self.n_shards)
        seq = int(batch.seq)
        subs = self._split_batch(batch)
        now = self._clock()
        statuses: List[Optional[str]] = [None] * self.n_shards
        backpressure = False
        if self._worker_mode:
            # Fan the sub-batches out to EVERY live worker before
            # collecting any admission — N journal fsyncs in flight at
            # once (the parallel-ingest win).  A worker that dies
            # mid-submit is torn down and its slice shed-with-seq: the
            # sub-batch was never acked, so the source retransmits it
            # (if the worker did journal it first, the retransmit comes
            # back "duplicate" — an ack, absorbed).
            sent: List[Tuple[_ShardSlot, int]] = []
            for slot in self._slots:
                if slot.retired:
                    statuses[slot.k] = "retired"
                    continue
                self.metrics.observe_submitted(slot.k)
                if slot.runtime is None:
                    statuses[slot.k] = "unavailable"
                    self.metrics.observe_shed_unavailable(slot.k, seq)
                    backpressure = True
                    continue
                try:
                    sent.append((slot,
                                 slot.runtime.start_submit(subs[slot.k])))
                except TransportError as e:
                    # A severed socket link reattaches (degrade) rather
                    # than crashing the worker; either way this round's
                    # slice is shed-with-seq and retransmit covers it.
                    self._lost_link(
                        slot, e, f"worker died on submit send: {e}")
                    statuses[slot.k] = "unavailable"
                    self.metrics.observe_shed_unavailable(slot.k, seq)
                    backpressure = True
            for slot, rid in sent:
                try:
                    adm = slot.runtime.finish_submit(rid)
                except TransportTimeout as e:
                    # Alive but past the deadline (e.g. still inside a
                    # long apply the previous poll round timed out on):
                    # degrade + backoff, never SIGKILL a busy worker.
                    # The slice is not acked — the source retransmits
                    # it and duplicate drop absorbs any overshoot if
                    # the worker did journal it before answering late.
                    self._on_timeout(slot, f"submit deadline expired: "
                                           f"{e}")
                    statuses[slot.k] = "unavailable"
                    self.metrics.observe_shed_unavailable(slot.k, seq)
                    backpressure = True
                    continue
                except TransportError as e:
                    self._lost_link(
                        slot, e, f"submit to worker failed: "
                                 f"{type(e).__name__}: {e}")
                    statuses[slot.k] = "unavailable"
                    self.metrics.observe_shed_unavailable(slot.k, seq)
                    backpressure = True
                    continue
                statuses[slot.k] = adm.status
                backpressure |= self._note_admission(
                    slot, adm, subs[slot.k].n_events, seq, now)
        else:
            for slot in self._slots:
                if slot.retired:
                    statuses[slot.k] = "retired"
                    continue
                self.metrics.observe_submitted(slot.k)
                if slot.runtime is None:
                    statuses[slot.k] = "unavailable"
                    self.metrics.observe_shed_unavailable(slot.k, seq)
                    backpressure = True
                    continue
                sub = subs[slot.k]
                adm = slot.runtime.submit(sub, _validated=True)
                statuses[slot.k] = adm.status
                backpressure |= self._note_admission(
                    slot, adm, sub.n_events, seq, now)
        live = [st for st in statuses if st != "retired"]
        if all(st in ("accepted", "duplicate") for st in live):
            status = "accepted"
        elif all(st in ("shed", "unavailable") for st in live):
            status = "shed"
        else:
            status = "partial"
        return ClusterAdmission(status, seq=seq,
                                backpressure=backpressure,
                                per_shard=tuple(statuses))

    def submit_many(self, batches: List[EventBatch]
                    ) -> List[ClusterAdmission]:
        """Admit a whole ROUND of global micro-batches with ONE frame
        round-trip per shard (``submit_many`` op) instead of one per
        batch — the batched-frame half of the wire-speed ingest path.
        Semantically identical to calling :meth:`submit` per batch (same
        validation, same per-shard admissions, same ledger); only the
        transport amortization differs.  In-process placement simply
        loops (there is no frame to batch)."""
        if not batches:
            return []
        with _telemetry.span("cluster.submit_round") as tsp:
            tsp.set(n=len(batches))
            return self._submit_many(batches)

    def _submit_many(self, batches: List[EventBatch]
                     ) -> List[ClusterAdmission]:
        if not self._worker_mode:
            return [self.submit(b) for b in batches]
        prepared = []  # (batch|None, subs|None, admission-or-None)
        for batch in batches:
            try:
                v = validate_batch(batch, self.n_feeds,
                                   max_events=self.max_batch_events)
            except IngestError as e:
                self.metrics.global_rejected += 1
                for k in range(self.n_shards):
                    self.metrics.observe_submitted(k)
                    self.metrics.observe_rejected(k)
                prepared.append((None, None, ClusterAdmission(
                    "rejected", seq=e.seq, reason=str(e),
                    per_shard=("rejected",) * self.n_shards)))
                continue
            reason = self._route_block(v)
            if reason is not None:
                if reason.startswith("fenced"):
                    self.metrics.observe_fenced_retry()
                    prepared.append((None, None, ClusterAdmission(
                        "fenced", seq=int(v.seq), reason=reason)))
                else:
                    self.metrics.global_rejected += 1
                    for k in range(self.n_shards):
                        self.metrics.observe_submitted(k)
                        self.metrics.observe_rejected(k)
                    prepared.append((None, None, ClusterAdmission(
                        "rejected", seq=int(v.seq), reason=reason,
                        per_shard=("rejected",) * self.n_shards)))
                continue
            prepared.append((v, self._split_batch(v), None))
        now = self._clock()
        n_valid = sum(1 for b, _, _ in prepared if b is not None)
        statuses: Dict[int, List[Optional[str]]] = {}
        bps: Dict[int, List[bool]] = {}
        sent: List[Tuple[_ShardSlot, int]] = []

        def shed_round(slot: _ShardSlot) -> None:
            """One shard's whole-round failure outcome — the single
            place the unavailable accounting lives (four failure paths
            share it; a missed copy would skew the closed identity)."""
            statuses[slot.k] = ["unavailable"] * n_valid
            bps[slot.k] = [True] * n_valid
            for b, _, _ in prepared:
                if b is not None:
                    self.metrics.observe_shed_unavailable(
                        slot.k, int(b.seq))

        for slot in self._slots:
            if slot.retired:
                statuses[slot.k] = ["retired"] * n_valid
                bps[slot.k] = [False] * n_valid
                continue
            for _ in range(n_valid):
                self.metrics.observe_submitted(slot.k)
            if slot.runtime is None:
                shed_round(slot)
                continue
            shard_batches = [subs[slot.k] for b, subs, _ in prepared
                             if b is not None]
            try:
                sent.append((slot, slot.runtime.start_submit_many(
                    shard_batches)))
            except TransportError as e:
                self._lost_link(slot, e,
                                f"worker died on submit_many send: {e}")
                shed_round(slot)
        for slot, rid in sent:
            try:
                adms = slot.runtime.finish_submit_many(rid)
            except TransportTimeout as e:
                self._on_timeout(slot,
                                 f"submit_many deadline expired: {e}")
                shed_round(slot)
                continue
            except TransportError as e:
                self._lost_link(slot, e,
                                f"submit_many to worker failed: "
                                f"{type(e).__name__}: {e}")
                shed_round(slot)
                continue
            sts: List[Optional[str]] = []
            bp_list: List[bool] = []
            i = 0
            for b, subs, _ in prepared:
                if b is None:
                    continue
                adm = adms[i]
                i += 1
                sts.append(adm.status)
                bp_list.append(self._note_admission(
                    slot, adm, subs[slot.k].n_events, int(b.seq), now))
            statuses[slot.k] = sts
            bps[slot.k] = bp_list
        out: List[ClusterAdmission] = []
        vi = 0
        for b, _subs, rejected in prepared:
            if rejected is not None:
                out.append(rejected)
                continue
            per = tuple(statuses[k][vi] for k in range(self.n_shards))
            # Per-BATCH backpressure, same as submit(): only the
            # batches whose own admissions signalled it — a source must
            # not over-throttle a whole round for one shed slice.
            bp = any(bps[k][vi] for k in range(self.n_shards))
            vi += 1
            live = [st for st in per if st != "retired"]
            if all(st in ("accepted", "duplicate") for st in live):
                status = "accepted"
            elif all(st in ("shed", "unavailable") for st in live):
                status = "shed"
            else:
                status = "partial"
            out.append(ClusterAdmission(status, seq=int(b.seq),
                                        backpressure=bp,
                                        per_shard=per))
        return out

    def _note_admission(self, slot: _ShardSlot, adm, n_events: int,
                        seq: int, now: float) -> bool:
        """Ledger one sub-batch admission (both placements share this
        exactly); returns the admission's backpressure bit."""
        if adm.status == "accepted":
            if seq in slot.outstanding:
                # retransmit of a batch still held in the shard's
                # reorder window: redundant delivery, not durable —
                # the ledger counts the extra submission a duplicate
                self.metrics.observe_duplicate(slot.k)
            else:
                slot.outstanding[seq] = (now, int(n_events))
        elif adm.status == "duplicate":
            self.metrics.observe_duplicate(slot.k)
        elif adm.status == "shed":
            self.metrics.observe_shed_queue(slot.k, seq)
        else:  # "rejected" — per-shard validation (shouldn't happen
            self.metrics.observe_rejected(slot.k)  # post-global)
        return bool(adm.backpressure)

    # ---- routing: the apply path (health-aware dispatch) ----

    def poll(self, max_batches_per_shard: Optional[int] = None
             ) -> Dict[int, List[Any]]:
        """One dispatch round: every serviceable shard applies up to
        ``max_batches_per_shard`` queued sub-batches (all, by default),
        one at a time so faults and health observations land at exact
        sequence numbers.  Wedged shards back off (skip rounds,
        exponential, capped); quarantined shards auto-recover in place
        when ``auto_recover`` (healthy shards are NOT blocked on it —
        they were already drained by the time recovery runs, and their
        admissions never depend on the dead shard).  Returns the
        per-shard decision lists."""
        with _telemetry.span("cluster.poll") as tsp:
            out = self._poll(max_batches_per_shard)
            tsp.set(applied=sum(len(v) for v in out.values()))
            return out

    def _poll(self, max_batches_per_shard: Optional[int] = None
              ) -> Dict[int, List[Any]]:
        if self._worker_mode:
            return self._poll_workers(max_batches_per_shard)
        out: Dict[int, List[Any]] = {}
        for slot in self._slots:
            if slot.retired:
                out[slot.k] = []
                continue
            if slot.runtime is None:
                if self.auto_recover and slot.dir is not None \
                        and slot.skip_rounds == 0:
                    self._try_auto_recover(slot)
                elif slot.skip_rounds > 0:
                    slot.skip_rounds -= 1
                if slot.runtime is None:
                    out[slot.k] = []
                    continue
            if slot.skip_rounds > 0:
                slot.skip_rounds -= 1  # backoff: the wedged shard rests
                out[slot.k] = []
                continue
            out[slot.k] = self._poll_slot(slot, max_batches_per_shard)
        return out

    def _poll_workers(self, max_batches: Optional[int]
                      ) -> Dict[int, List[Any]]:
        """One worker-placement dispatch round: liveness-check every
        slot (child exit = crash, stale heartbeat = hang), fan
        ``poll`` out to every serviceable worker, THEN collect — the
        N workers apply and fsync concurrently while the router waits
        once.  Transport failures classify onto the same health state
        machine as in-process faults; a quarantined worker restarts
        under the RetryPolicy gate and recovers from its own journal
        while the survivors' requests are already in flight."""
        out: Dict[int, List[Any]] = {k: [] for k in
                                     range(self.n_shards)}
        dispatch: List[Tuple[_ShardSlot, int]] = []
        for slot in self._slots:
            if slot.retired:
                continue
            if slot.runtime is None:
                if self.auto_recover \
                        and self._clock() >= slot.restart_at:
                    self._try_auto_recover(slot)
                if slot.runtime is None:
                    continue
            if slot.skip_rounds > 0:
                slot.skip_rounds -= 1  # backoff: the wedged shard rests
                continue
            h = slot.runtime
            # Crash detection via child exit: cheaper and earlier than
            # discovering the EOF on the next request.
            if not h.alive():
                self._crash_slot(
                    slot, f"worker process exited "
                          f"rc={h.proc.returncode}")
                continue
            h.drain_beats()
            self._salvage_stale(slot, out[slot.k])
            # Heartbeat-staleness hang detection: the worker owes a
            # beat every worker_heartbeat_every_s even when idle — an
            # age past the bound means the child is alive but wedged.
            age = h.beat_age()
            if age > self.worker_heartbeat_timeout_s:
                self._on_timeout(
                    slot, f"worker heartbeat stale {age:.1f}s > "
                          f"{self.worker_heartbeat_timeout_s:.1f}s")
                continue
            try:
                dispatch.append((slot, h.start_poll(max_batches)))
            except TransportError as e:
                self._lost_link(slot, e,
                                f"worker died on poll send: {e}")
        for slot, rid in dispatch:
            h = slot.runtime
            try:
                ds = h.finish_poll(rid)
            except TransportTimeout:
                # The wedged-worker shape: the request deadline expired
                # with the child still running.  The sub-batch stays
                # queued worker-side; degrade, back off, retry — and
                # a late answer is salvaged by id, never misattributed.
                self._on_timeout(
                    slot, f"poll deadline "
                          f"{h.request_timeout_s:.1f}s expired "
                          f"(worker alive but unresponsive)")
                continue
            except TransportEOF as e:
                # A dead LINK is not yet a dead WORKER under socket
                # placement: give the same live process a grace window
                # to redial (partition heal), then retry the response
                # wait once — a reconnect-mode worker answers on the
                # new connection; a partition-mode worker's response is
                # gone and the retry times out (resync heals later).
                if not self._lost_link(
                        slot, e,
                        f"poll failed: {type(e).__name__}: {e}"):
                    continue
                try:
                    # Short retry deadline: only a clean link flap
                    # (net:reconnect) re-delivers the response; a real
                    # partition ate it and resync heals that — the
                    # whole round must not stall on the apply budget.
                    ds = h.finish_poll(rid, timeout_s=h.read_timeout_s)
                except TransportTimeout:
                    # The partition ate the response — the EXPECTED
                    # outcome, already paid for by the reattach's
                    # timeout strike; a second strike here would burn
                    # 2/3 of the quarantine budget per episode.  Resync
                    # recovers the journaled decisions.
                    self._maybe_resync(slot, out[slot.k])
                    continue
                except TransportError as e2:
                    self._crash_slot(
                        slot, f"poll failed after reattach: "
                              f"{type(e2).__name__}: {e2}")
                    continue
            except TransportError as e:
                # FrameError (poisoned byte stream) or WorkerOpError
                # (the worker's runtime raised): the fault domain
                # cannot be trusted mid-stream — SIGKILL + quarantine,
                # recovery from durable state only.
                self._crash_slot(
                    slot,
                    f"poll failed: {type(e).__name__}: {e}")
                continue
            self._observe_decisions(slot, ds, out[slot.k], clean=True)
            self._salvage_stale(slot, out[slot.k])
            self._maybe_resync(slot, out[slot.k])
        return out

    def _lost_link(self, slot: _ShardSlot, e: Exception,
                   reason: str, wait: bool = True) -> bool:
        """Classify a transport failure: under socket placement an EOF
        from a still-running worker gets a reattach grace (the worker
        redials under its RetryPolicy) — heal as a TIMEOUT (degrade,
        probation) and resync, never a journal recovery.  Everything
        else is a crash.  Returns True iff the link was reattached.

        ``wait=False`` is the READ-path contract (decide/status/
        digest): those ops are bounded by the short read deadline, so
        they may only adopt an ALREADY-redialed worker (near-zero
        grace) — a still-down link degrades the read immediately (one
        fewer reporter) and the next poll round pays the full grace."""
        h = slot.runtime
        if (isinstance(e, TransportEOF) and h is not None
                and getattr(h, "listener", None) is not None
                and h.alive()):
            grace = self.worker_reattach_grace_s if wait else 0.05
            if h.try_reattach(grace):
                self.metrics.observe_reattach(slot.k)
                self._on_timeout(slot, f"link lost, worker "
                                       f"reattached: {reason}")
                return True
            if not wait:
                # Alive but not yet redialed: degrade this read, leave
                # the worker for the poll round's full-grace reattach.
                self._on_timeout(slot, f"link down (read path): "
                                       f"{reason}")
                return False
        self._crash_slot(slot, reason)
        return False

    def _maybe_resync(self, slot: _ShardSlot, into: List[Any]) -> None:
        """Heal the ledger after lost response frames: any outstanding
        seq at or below the worker's last reported ``applied_seq`` was
        applied+journaled worker-side but its decisions never reached
        the router (net drop / partition / reconnect).  Pull them from
        the worker's recent-ring (``replay_decisions``); an incomplete
        ring sends the shard to the journal-recovery path rather than
        trusting a hole."""
        h = slot.runtime
        if h is None or not slot.outstanding:
            return
        top = getattr(h, "last_polled_seq", None)
        if top is None:
            return
        missed = [s for s in slot.outstanding if s <= top]
        if not missed:
            return
        try:
            ds, complete = h.replay_decisions(min(missed) - 1)
        except TransportError as e:
            self._lost_link(slot, e,
                            f"resync failed: {type(e).__name__}: {e}")
            return
        if not complete:
            self._crash_slot(
                slot, f"resync ring incomplete for seqs {missed} — "
                      f"recovering from the journal instead")
            return
        ds = [d for d in ds if int(d.seq) in slot.outstanding]
        self.metrics.observe_resync(slot.k, len(ds))
        # Late facts, not health evidence (clean=False) — the shard
        # heals on in-deadline replies.
        self._observe_decisions(slot, ds, into, clean=False)

    def _observe_decisions(self, slot: _ShardSlot, decisions: List[Any],
                           into: List[Any], clean: bool) -> None:
        """Ledger applied decisions (both placements share this
        exactly): pop the outstanding seq, observe latency/events,
        collect the decision, and count clean applies toward heal."""
        for d in decisions:
            arrival = slot.outstanding.pop(int(d.seq), None)
            if arrival is None:
                # This seq was never ledgered "accepted" — its
                # admission response died with the link and the slice
                # was recorded shed_unavailable.  The books are already
                # balanced (shed now, duplicate-ack on the healing
                # retransmit), so ALSO counting an apply here would
                # break the closed identity: submitted=1 but
                # shed+applied=2.
                continue
            latency = self._clock() - arrival[0]
            n_events = arrival[1]
            self.metrics.observe_applied(slot.k, n_events, d.post,
                                         latency)
            # The ack watermark: what the group-commit loss report
            # compares against when this shard next recovers.
            if int(d.seq) > slot.acked_seq:
                slot.acked_seq = int(d.seq)
            into.append(d)
            if clean:
                self._on_clean(slot)

    def _salvage_stale(self, slot: _ShardSlot,
                       into: List[Any]) -> None:
        """Ledger the decisions of poll responses that answered after
        their request timed out: the worker APPLIED and JOURNALED those
        batches, so the router must observe them or the accounting
        identity would leak.  Late answers are not evidence of health
        (``clean=False``) — the shard heals on in-deadline replies."""
        if slot.runtime is None:
            return
        for value in slot.runtime.drain_stale_polls():
            ds = [slot.runtime._decision(d)
                  for d in value.get("decisions", [])]
            # Only seqs still outstanding: a late answer may race the
            # resync protocol (or a crash reclassification) for the
            # same seqs, and observing a seq twice would double-count
            # ``applied`` and break the closed identity.
            ds = [d for d in ds if int(d.seq) in slot.outstanding]
            self._observe_decisions(slot, ds, into, clean=False)

    def _poll_slot(self, slot: _ShardSlot,
                   max_batches: Optional[int]) -> List[Any]:
        decisions: List[Any] = []
        fault = None if self._fault_spent else self._fault
        if fault is None:
            # No shard fault armed: let the runtime drain its queue in
            # coalesced groups (one dispatch + one record per group) —
            # the in-process router only steps batch-by-batch to land
            # injected faults at exact seqs.
            try:
                ds = slot.runtime.poll(max_batches=max_batches)
            except Exception as e:  # noqa: BLE001 — apply/journal
                # failure: the fault domain can no longer be made
                # durable; quarantine it, keep the cluster serving.
                self._crash_slot(slot, f"apply failed: {e}")
                return decisions
            self._observe_decisions(slot, ds, decisions, clean=True)
            return decisions
        while max_batches is None or len(decisions) < max_batches:
            seq = slot.runtime.next_queued_seq()
            if seq is None:
                break
            if (fault is not None and fault.mode == "wedge"
                    and fault.shard == slot.k
                    and (fault.batch is None or fault.batch == seq)):
                if self._wedge_left > 0:
                    # The deadline-expiry detection point: the dispatch
                    # did not come back in time, the batch stays queued,
                    # the shard degrades and backs off.
                    self._wedge_left -= 1
                    self._on_timeout(
                        slot, f"apply deadline expired at sub-batch "
                              f"{seq} (injected wedge)")
                    break
                self._fault_spent = True
                fault = None
            try:
                ds = slot.runtime.poll(max_batches=1)
            except Exception as e:  # noqa: BLE001 — any apply/journal
                # failure means the fault domain can no longer be made
                # durable: quarantine it, keep the cluster serving.
                self._crash_slot(slot, f"apply failed: {e}")
                break
            if not ds:
                break
            d = ds[0]
            fire = (fault is not None and fault.shard == slot.k
                    and fault.mode in ("crash", "torn_journal",
                                       "corrupt_snapshot")
                    and (fault.batch is None or fault.batch == d.seq))
            if fire and fault.mode == "torn_journal":
                # The append for this batch went out torn and the shard
                # died before acknowledging: the decision never left the
                # dying fault domain, so it is NOT observed applied —
                # the seq stays outstanding and reclassifies as lost.
                self._fault_spent = True
                from .journal import tear_tail

                if slot.runtime.journal_path:
                    tear_tail(slot.runtime.journal_path)
                self._crash_slot(
                    slot, f"journal append torn at sub-batch {d.seq} "
                          f"(injected)")
                break
            self._observe_decisions(slot, [d], decisions, clean=True)
            if fire:  # crash | corrupt_snapshot: batch d.seq was acked
                self._fault_spent = True
                if fault.mode == "corrupt_snapshot":
                    self._corrupt_newest_snapshot(slot)
                self._crash_slot(
                    slot, f"{fault.mode} after sub-batch {d.seq} "
                          f"(injected)")
                break
        return decisions

    # ---- health state machine ----

    def _on_clean(self, slot: _ShardSlot) -> None:
        slot.fail_streak = 0
        if slot.health == DEGRADED:
            slot.clean_streak += 1
            if slot.clean_streak >= HEAL_AFTER:
                slot.health = HEALTHY
                slot.clean_streak = 0
                # A heal ends the crash loop: the restart backoff
                # schedule starts over at the next (unrelated) crash.
                slot.crash_streak = 0

    def _on_timeout(self, slot: _ShardSlot, reason: str) -> None:
        slot.fail_streak += 1
        slot.clean_streak = 0
        if slot.health == HEALTHY:
            slot.health = DEGRADED
        backoff = min(2 ** slot.fail_streak, MAX_BACKOFF_ROUNDS)
        self.metrics.observe_timeout(slot.k, backoff)
        if slot.fail_streak >= QUARANTINE_AFTER:
            # A shard that will not come back is presumed dead: its
            # volatile state cannot be trusted mid-apply — same teardown
            # as a crash, recovery from durable state only.
            self._crash_slot(
                slot, f"quarantined after {slot.fail_streak} "
                      f"consecutive timeouts: {reason}")
        else:
            slot.skip_rounds = backoff

    def _crash_slot(self, slot: _ShardSlot, reason: str) -> None:
        rt, slot.runtime = slot.runtime, None
        slot.health = QUARANTINED
        slot.fail_streak = slot.clean_streak = slot.skip_rounds = 0
        slot.crash_streak += 1
        if self._worker_mode:
            # Crash-loop backoff (runtime.supervisor RetryPolicy): the
            # n-th crash of a streak gates its restart delay(n) out —
            # a worker that dies on every recovery can't hot-loop the
            # spawn + torch import + CUDA start.  A heal resets the streak.
            slot.restart_at = self._clock() + self.restart_policy.delay(
                min(slot.crash_streak, _CRASH_STREAK_CAP),
                self._restart_rng)
        if rt is not None:
            teardown = getattr(rt, "kill", None)
            if teardown is not None:
                # A worker handle: SIGKILL the real process (wedged or
                # poisoned children don't get a graceful goodbye) and
                # close the pipes.  Never raises.
                teardown()
            else:
                # In-process: releases the journal fd only — every
                # acknowledged record was already fsynced; the carry/
                # queue/reorder window are dropped un-flushed, exactly
                # the SIGKILL leave-behind.
                try:
                    rt.close()
                except OSError:
                    pass
        for seq in sorted(slot.outstanding):
            self.metrics.observe_lost_on_crash(slot.k, seq)
        slot.outstanding.clear()
        self.metrics.observe_crash(slot.k, reason)
        self._salvage_flight(slot)

    def _salvage_flight(self, slot: _ShardSlot) -> None:
        """Pull the dead fault domain's flight-recorder ring (the last
        ~N spans the process completed before it died — a SIGKILL'd
        worker's only testimony) into the crash report: the span dicts
        land on the shard's metrics block AND in this router's telemetry
        buffer, so an exported trace stitches the child's final moments
        under their original trace ids.  Best-effort by design: a
        missing or torn ring is an empty salvage, never an error in the
        crash path.  The ring file is consumed (removed) so a later,
        unrelated crash cannot re-report stale evidence."""
        if slot.dir is None:
            return
        ring = os.path.join(slot.dir, _telemetry.FLIGHT_FILENAME)
        spans = _telemetry.read_flight(ring)
        if not spans:
            return
        self.metrics.observe_flight_salvage(slot.k, spans)
        tel = _telemetry.get()
        if tel.enabled:
            tel.adopt_spans(spans)
        try:
            os.remove(ring)
        except OSError:
            pass

    def _corrupt_newest_snapshot(self, slot: _ShardSlot) -> None:
        """The ``corrupt_snapshot`` fault body: scribble every file of
        the shard's newest landed snapshot step (recovery must fall back
        past it via ``latest_valid_step`` and replay more journal)."""
        if slot.dir is None:
            return
        snaps = os.path.join(slot.dir, SNAPSHOTS_DIRNAME)
        if not os.path.isdir(snaps):
            return
        steps = sorted((int(n) for n in os.listdir(snaps)
                        if n.isdigit()), reverse=True)
        if not steps:
            return
        for root, _, files in os.walk(os.path.join(snaps,
                                                   str(steps[0]))):
            for f in files:
                with open(os.path.join(root, f), "wb") as fh:
                    fh.write(b"garbage (injected corrupt_snapshot)")

    def _try_auto_recover(self, slot: _ShardSlot) -> None:
        if self.external_workers:
            return  # the operator owns the processes; adoption is
            # explicit (adopt_external_worker), never an auto-respawn
        try:
            self.recover_shard(slot.k)
        except Exception as e:  # noqa: BLE001 — a failed recovery must
            # not take down the healthy shards; back off and retry, give
            # up loudly after the bound (RECOVERY_GIVE_UP in process,
            # the RetryPolicy's max_attempts for worker restarts).
            slot.recover_failures += 1
            if self._worker_mode:
                give_up = self.restart_policy.max_attempts
                slot.restart_at = (self._clock()
                                   + self.restart_policy.delay(
                                       min(slot.crash_streak
                                           + slot.recover_failures,
                                           _CRASH_STREAK_CAP),
                                       self._restart_rng))
            else:
                give_up = RECOVERY_GIVE_UP
                slot.skip_rounds = MAX_BACKOFF_ROUNDS
            self.metrics.observe_crash(
                slot.k, f"recovery attempt {slot.recover_failures} "
                        f"failed: {e}")
            if slot.recover_failures >= give_up:
                raise RuntimeError(
                    f"shard {slot.k} failed {slot.recover_failures} "
                    f"recovery attempts (last: {e}) — the fault domain "
                    f"at {slot.dir} needs operator attention") from e

    # ---- crash / recovery (the operator surface) ----

    def kill_shard(self, k: int, reason: str = "operator kill") -> None:
        """Chaos hook: destroy shard ``k``'s volatile state exactly the
        way the ``shard:crash`` fault does (carry, queue, and reorder
        window die; fsynced journal + snapshots survive).  What the
        MTTR bench and the chaos acceptance test drive."""
        slot = self._slots[k]
        if slot.runtime is None:
            raise ValueError(f"shard {k} is already quarantined")
        self._crash_slot(slot, reason)

    def adopt_external_worker(self, k: int,
                              accept_timeout_s: float = 300.0,
                              recover: bool = False):
        """PUBLIC remote-spawn adoption (socket placement): wait for an
        operator-launched worker — another host, a container scheduler
        — to dial shard ``k``'s listener (run the
        :meth:`remote_worker_commands` recipe there), authenticate it,
        and ``open`` (fresh) or ``recover`` (existing on-disk state,
        with the group-commit loss window reported against the router's
        ack watermark) its shard.  Returns the ``RecoveryInfo`` when
        ``recover`` else None.  The cluster never SIGKILLs an adopted
        worker's process (the remote supervisor owns it); a dead one is
        quarantined until the operator adopts a replacement."""
        if self.placement != "sockets":
            raise ValueError(
                f"adopt_external_worker needs placement='sockets', "
                f"this cluster runs {self.placement!r}")
        from .transport import Listener
        from .worker import SocketWorkerHandle

        slot = self._slots[k]
        if slot.runtime is not None:
            raise ValueError(f"shard {k} already has a live worker — "
                             f"kill_shard it first")
        if slot.listener is None:
            slot.listener = Listener(host=self.listen_host,
                                     clock=self._clock)
        h = SocketWorkerHandle.await_external(
            slot.k, slot.listener, self.token,
            accept_timeout_s=accept_timeout_s,
            request_timeout_s=self.worker_request_timeout_s,
            open_timeout_s=self.worker_open_timeout_s,
            read_timeout_s=self.worker_read_timeout_s,
            clock=self._clock)
        info = None
        try:
            if recover:
                info = h.finish_recover(h.start_recover(
                    acked_seq=(slot.acked_seq if slot.acked_seq >= 0
                               else None)))
            else:
                h.finish_open(h.start_open(self._worker_config(slot)))
        except TransportError as e:
            h.kill()
            raise RuntimeError(
                f"adopted worker for shard {k} failed to "
                f"{'recover' if recover else 'open'}: "
                f"{type(e).__name__}: {e}") from e
        slot.runtime = h
        # Probation only after a crash history; a first adoption serves
        # healthy.
        slot.health = DEGRADED if slot.crash_streak else HEALTHY
        slot.fail_streak = slot.clean_streak = slot.skip_rounds = 0
        slot.recover_failures = 0
        if info is not None:
            self.metrics.observe_recovery(k, info.replayed, 0.0)
            for seq in info.lost_acked_seqs:
                self.metrics.observe_lost_in_window(k, seq)
        return info

    def partition_shard(self, k: int) -> None:
        """Chaos hook (socket placement): sever shard ``k``'s connection
        abruptly — the ROUTER side of a network partition.  The worker
        process survives with its runtime intact, redials under its
        RetryPolicy, and the next poll round reattaches it (hello pid
        must match) and resyncs the decisions the dead link ate — no
        journal replay, no bit divergence, accounting reconciles."""
        if self.placement != "sockets":
            raise ValueError(
                f"partition_shard needs placement='sockets' (a pipe "
                f"cannot partition), this cluster runs "
                f"{self.placement!r}")
        slot = self._slots[k]
        if slot.runtime is None:
            raise ValueError(f"shard {k} is quarantined — no link to "
                             f"partition")
        slot.runtime.sever_link()

    def recover_shard(self, k: int) -> RecoveryInfo:
        """Recover quarantined shard ``k`` in place: newest provable
        snapshot + digest-asserted journal replay (bit-identical carry
        and decision stream), then probation (``degraded`` until
        ``HEAL_AFTER`` clean applies).  Healthy shards are untouched —
        under worker placement they are literally other processes, so
        the replacement worker's spawn + torch import + replay never
        blocks their serving."""
        slot = self._slots[k]
        if slot.runtime is not None:
            raise ValueError(f"shard {k} is not quarantined")
        if slot.dir is None:
            raise ValueError(
                f"shard {k} has no directory — an in-memory cluster "
                f"cannot recover a crashed fault domain")
        if self.external_workers:
            raise ValueError(
                f"shard {k}'s workers are operator-spawned "
                f"(external_workers=True) — this router cannot restart "
                f"a process it does not own; launch a replacement from "
                f"remote_worker_commands() and "
                f"adopt_external_worker({k}, recover=True)")
        t0 = self._clock()
        if self._worker_mode:
            handle = self._spawn_worker(slot)
            try:
                info = handle.finish_recover(handle.start_recover(
                    acked_seq=(slot.acked_seq if slot.acked_seq >= 0
                               else None)))
            except TransportError as e:
                handle.kill()
                raise RuntimeError(
                    f"replacement worker for shard {k} failed to "
                    f"recover: {type(e).__name__}: {e}") from e
            rt = handle
        else:
            rt, info = _recover_runtime(
                slot.dir, clock=self._clock,
                acked_seq=(slot.acked_seq if slot.acked_seq >= 0
                           else None), device=self.device)
        ms = (self._clock() - t0) * 1e3
        slot.runtime = rt
        slot.health = DEGRADED
        slot.fail_streak = slot.clean_streak = slot.skip_rounds = 0
        slot.recover_failures = 0
        self.metrics.observe_recovery(k, info.replayed, ms)
        # The group-commit durability window a power-style crash
        # consumed: acked seqs the journal did not keep.  Recorded
        # (diagnostic, never silent), healed by the source's
        # retransmit-past-applied_seq contract — each retransmit
        # re-enters the ledger as its own (submitted, applied) pair.
        for seq in info.lost_acked_seqs:
            self.metrics.observe_lost_in_window(k, seq)
        return info

    # ---- elastic topology (live resharding + graph churn) ----

    def _uniform_applied_seq(self, why: str) -> int:
        """Every active shard's applied seq, asserted equal — the
        watermark a topology mutation anchors to."""
        seqs: Dict[int, int] = {}
        for slot in self._slots:
            if slot.retired:
                continue
            if slot.runtime is None:
                raise TopologyError(
                    f"shard {slot.k} is quarantined — "
                    f"recover_shard({slot.k}) first: {why}")
            seqs[slot.k] = int(slot.runtime.applied_seq)
        if len(set(seqs.values())) != 1:
            raise TopologyError(
                f"shards disagree on applied seq ({seqs}) — {why}; "
                f"retransmit the gap seqs and poll until uniform")
        return next(iter(seqs.values()))

    def _drain_for_topology(self, drain_rounds: int) -> int:
        for _ in range(int(drain_rounds)):
            if self.pending == 0:
                break
            self.poll()
        if self.pending:
            raise TopologyError(
                f"cluster will not drain ({self.pending} sub-batches "
                f"still pending after {drain_rounds} poll rounds) — "
                f"retransmit the gap seqs first")
        return self._uniform_applied_seq(
            "a topology mutation anchors to one uniform watermark")

    def _append_topo(self, rec: Dict[str, Any]) -> None:
        """Journal one topology record (durable BEFORE it takes
        effect — the flip the router acts on must be the flip recovery
        will replay), then apply it to the live routing state.  A
        dirless cluster keeps the topology in memory only."""
        if self._topo_log is None and self.dir is not None:
            self._topo_log = _topology.TopologyLog(
                os.path.join(self.dir, _topology.TOPOLOGY_LOG))
        if self._topo_log is not None:
            self._topo_log.append(rec)
        self._apply_topo_record(rec, recovering=False)

    def _apply_topo_record(self, rec: Dict[str, Any],
                           recovering: bool) -> None:
        """The ONE place topology records mutate router state — the
        live path and the recovery replay run the same transitions, so
        a recovered router's ownership map is bit-identical to the one
        that journaled the records.  ``recovering`` suppresses only the
        COUNTING observers (the ledger is per-router-process); the
        structural ones (``add_shard``, the epoch) always run."""
        t = self._topo
        kind = rec["kind"]
        t.note_epoch(int(rec["epoch"]))
        if kind == "add_edges":
            first, count = int(rec["first"]), int(rec["count"])
            if first != self.n_feeds:
                raise ValueError(
                    f"topology log corrupt: add_edges starts at feed "
                    f"{first} but the cluster holds {self.n_feeds}")
            self.n_feeds += count
            self._owner = np.concatenate(
                [self._owner,
                 np.full(count, -2, self._owner.dtype)])
            self._local_index = np.concatenate(
                [self._local_index, np.zeros(count, np.int32)])
            self._sink = np.concatenate(
                [self._sink, np.asarray(rec["s_sink"], np.float64)])
            if not recovering:
                self.metrics.observe_edges_added(count)
        elif kind == "add_slot":
            k = int(rec["k"])
            if k != len(self._slots):
                raise ValueError(
                    f"topology log corrupt: add_slot k={k} but the "
                    f"cluster holds {len(self._slots)} slots")
            feeds = np.asarray(rec["feeds"], np.int64)
            sdir = (None if self.dir is None
                    else os.path.join(self.dir, f"shard-{k:04d}"))
            self._slots.append(_ShardSlot(
                k, sdir, feeds, self._sink[feeds],
                start_seq=int(rec["start_seq"])))
            self.n_shards = len(self._slots)
            self.metrics.add_shard()
            # Pending-attach feeds (added by the add_edges record this
            # slot was created to serve) become live here.
            pend = feeds[self._owner[feeds] == -2]
            if len(pend):
                self._owner[pend] = k
                self._local_index[pend] = np.searchsorted(
                    feeds, pend).astype(np.int32)
        elif kind == "plan":
            t.plan = dict(rec)
            t.fences = {}
            t.flipped = set()
        elif kind == "fence":
            t.fences[int(rec["range"])] = dict(rec)
        elif kind == "flip":
            feeds = np.asarray(rec["feeds"], np.int64)
            dst = self._slots[int(rec["dst"])]
            self._owner[feeds] = dst.k
            self._local_index[feeds] = np.searchsorted(
                dst.feeds, feeds).astype(np.int32)
            t.fences.pop(int(rec["range"]), None)
            t.flipped.add(int(rec["range"]))
            if not recovering:
                self.metrics.observe_range_migrated()
        elif kind == "retire":
            slot = self._slots[int(rec["k"])]
            slot.retired = True
            slot.health = RETIRED
            if slot.runtime is not None:
                try:
                    slot.runtime.close()
                except (TransportError, OSError):
                    pass
                slot.runtime = None
            if slot.listener is not None:
                slot.listener.close()
                slot.listener = None
            slot.outstanding.clear()
        elif kind == "complete":
            t.plan = None
            t.fences = {}
            t.flipped = set()
            t.plans_completed += 1
            if not recovering:
                self.metrics.observe_plan_complete()
        elif kind == "drop_edges":
            feeds = np.asarray(rec["feeds"], np.int64)
            self._owner[feeds] = -1
            if not recovering:
                self.metrics.observe_edges_dropped(len(feeds))
        else:
            raise ValueError(
                f"unknown topology record kind {kind!r}")
        self.metrics.set_topology_epoch(t.epoch)

    def _open_slot_runtime(self, slot: _ShardSlot) -> None:
        """Bring a just-journaled slot's runtime up (fresh, pre-sized).
        Separate from :meth:`_apply_topo_record` because the RECOVERY
        replay must not open runtimes mid-replay — it rebuilds the slot
        table first and opens everything afterwards."""
        if self._worker_mode:
            h = self._spawn_worker(slot)
            try:
                h.finish_open(h.start_open(self._worker_config(slot)))
            except TransportError as e:
                h.kill()
                raise RuntimeError(
                    f"worker for new shard {slot.k} failed to open: "
                    f"{type(e).__name__}: {e}") from e
            slot.runtime = h
        else:
            slot.runtime = self._fresh_runtime(slot)

    def _route_block(self, batch: EventBatch) -> Optional[str]:
        """The admission-time topology gate: dropped feeds reject;
        a batch past the fence watermark touching a FENCED source shard
        is refused ("fenced" — the source retransmits after the flip).
        Seqs at or below ``max(watermark, source acked seq)`` pass:
        the source already applied them, so re-admission is a pure
        duplicate there — and it is exactly what lets a recovered,
        lagging destination catch up to the watermark mid-migration."""
        if len(batch.feeds) == 0:
            return None
        owners = self._owner[batch.feeds]
        if (owners < 0).any():
            bad = np.unique(batch.feeds[owners < 0])
            return (f"batch {int(batch.seq)} touches dropped feeds "
                    f"{[int(f) for f in bad[:8]]} — removed by "
                    f"drop_edges, no longer routable")
        t = self._topo
        if not t.fences:
            return None
        seq = int(batch.seq)
        for rec in t.fences.values():
            src = self._slots[int(rec["src"])]
            if seq <= max(int(rec["watermark"]), src.acked_seq):
                continue
            if (owners == src.k).any():
                return (f"fenced: seq {seq} touches shard {src.k}, "
                        f"paused for range {int(rec['range'])} handoff "
                        f"(watermark {int(rec['watermark'])}) — "
                        f"retransmit after the flip")
        return None

    @property
    def migration_pending(self) -> bool:
        return self._topo.plan is not None

    @property
    def topology_epoch(self) -> int:
        return self._topo.epoch

    def begin_reshard(self, n_shards: int,
                      range_size: Optional[int] = None,
                      drain_rounds: int = 64) -> "_topology.Migration":
        """Start a LIVE N→M grow-migration: journal the new pre-sized
        slots and the range plan, then return the resumable
        :class:`serving.topology.Migration` driver — the caller
        interleaves ``step()`` with traffic.  Only grows (existing
        runtimes never receive into their live arrays — that would
        invalidate their journaled digests); shrink via the drained,
        offline :func:`reshard`."""
        if self.migration_pending:
            raise TopologyError(
                f"plan {self._topo.plan.get('plan')!r} is still "
                f"migrating — resume_migration() and finish it first")
        if self.external_workers:
            raise TopologyError(
                "this router does not own its workers "
                "(external_workers=True) — it cannot spawn new shard "
                "processes; reshard offline instead")
        active = [s for s in self._slots if not s.retired]
        n_new = int(n_shards) - len(active)
        if n_new < 1:
            raise TopologyError(
                f"live resharding only grows ({len(active)} active "
                f"shards, asked for {int(n_shards)}) — use reshard() "
                f"(drained, offline) to shrink")
        w = self._drain_for_topology(drain_rounds)
        owned = {s.k: np.flatnonzero(self._owner == s.k)
                 for s in active}
        new_ids = [len(self._slots) + i for i in range(n_new)]
        new_feeds, ranges = _topology.plan_moves(owned, new_ids,
                                                 range_size)
        for k in new_ids:
            # A fresh runtime at start_seq=w+1 sits at applied_seq=w —
            # already level with the drained cluster, so the next
            # drain stays uniform while the new slot rides the stream.
            self._append_topo({"kind": "add_slot",
                               "epoch": self._topo.next_epoch(),
                               "k": int(k),
                               "feeds": [int(f) for f in new_feeds[k]],
                               "start_seq": int(w) + 1})
            self._open_slot_runtime(self._slots[k])
        plan_id = f"plan-{self._topo.next_epoch():06d}"
        plan = {"kind": "plan", "epoch": self._topo.next_epoch(),
                "plan": plan_id, "ranges": ranges,
                "watermark": int(w),
                "new_slots": [int(k) for k in new_ids]}
        self._append_topo(plan)
        return _topology.Migration(self, plan,
                                   fault=_faultinject.reshard_fault())

    def resume_migration(self) -> "_topology.Migration":
        """Re-arm the driver for the journaled in-flight plan (after a
        crash + recovery, or just a new driver object) — it continues
        from the first unflipped range, re-asserting the fenced
        digest."""
        if self._topo.plan is None:
            raise TopologyError("no migration is pending")
        return _topology.Migration(self, self._topo.plan,
                                   fault=_faultinject.reshard_fault())

    def add_edges(self, n: int,
                  s_sink: Optional[np.ndarray] = None,
                  drain_rounds: int = 64) -> List[int]:
        """Grow the follow graph by ``n`` new feeds under traffic:
        journal the new feed block, assign it to the least-loaded
        shards (:func:`serving.topology.churn_assign`), and materialize
        each receiving shard as a mini-migration into a fresh pre-sized
        slot (growth IS resharding — a live runtime's arrays never grow
        in place).  Returns the new feed ids."""
        if self.migration_pending:
            raise TopologyError(
                f"plan {self._topo.plan.get('plan')!r} is still "
                f"migrating — finish it before churning the graph")
        if self.external_workers:
            raise TopologyError(
                "this router does not own its workers — it cannot "
                "spawn the replacement shard add_edges needs")
        n = int(n)
        if n < 1:
            raise TopologyError(f"add_edges needs n >= 1, got {n}")
        if s_sink is None:
            s_new = np.ones(n, np.float64)
        else:
            s_new = np.asarray(s_sink, np.float64)
            if s_new.shape != (n,):
                raise TopologyError(
                    f"s_sink must have shape ({n},), got "
                    f"{s_new.shape}")
        w = self._drain_for_topology(drain_rounds)
        active = [s for s in self._slots if not s.retired]
        counts = {s.k: int((self._owner == s.k).sum())
                  for s in active}
        choice = _topology.churn_assign(counts, n)
        first = self.n_feeds
        new_ids = list(range(first, first + n))
        self._append_topo({"kind": "add_edges",
                           "epoch": self._topo.next_epoch(),
                           "first": int(first), "count": n,
                           "s_sink": [float(x) for x in s_new]})
        ranges: List[Dict[str, Any]] = []
        for old_k in sorted(set(choice)):
            new_k = len(self._slots)
            owned_old = np.flatnonzero(self._owner == old_k)
            attach = [f for f, c in zip(new_ids, choice)
                      if c == old_k]
            feeds = sorted([int(f) for f in owned_old] + attach)
            self._append_topo({"kind": "add_slot",
                               "epoch": self._topo.next_epoch(),
                               "k": int(new_k), "feeds": feeds,
                               "start_seq": int(w) + 1})
            self._open_slot_runtime(self._slots[new_k])
            if len(owned_old):
                ranges.append({"id": len(ranges), "src": int(old_k),
                               "dst": int(new_k),
                               "feeds": [int(f) for f in owned_old]})
        if ranges:
            plan_id = f"plan-{self._topo.next_epoch():06d}"
            plan = {"kind": "plan",
                    "epoch": self._topo.next_epoch(),
                    "plan": plan_id, "ranges": ranges,
                    "watermark": int(w), "new_slots": []}
            self._append_topo(plan)
            _topology.Migration(
                self, plan,
                fault=_faultinject.reshard_fault()).run()
        return new_ids

    def drop_edges(self, feeds: Sequence[int],
                   drain_rounds: int = 64) -> None:
        """Remove feeds from the live graph: poison their carry on the
        owning shard (rank 0, health bit set — no intensity
        contribution, journaled in the shard's OWN journal so recovery
        replays it) and journal the routing drop (owner -1: future
        batches touching them reject, and they leave
        :meth:`edge_digest`).  The poison lands before the drop record
        — a crash between the two re-runs ``drop_edges`` idempotently."""
        if self.migration_pending:
            raise TopologyError(
                f"plan {self._topo.plan.get('plan')!r} is still "
                f"migrating — finish it before churning the graph")
        feeds = np.unique(np.asarray(feeds, np.int64))
        if len(feeds) == 0:
            return
        if feeds.min() < 0 or feeds.max() >= self.n_feeds:
            raise TopologyError(
                f"drop_edges feed ids out of range 0..{self.n_feeds - 1}")
        owners = self._owner[feeds]
        if (owners < 0).any():
            bad = [int(f) for f, o in zip(feeds, owners) if o < 0]
            raise TopologyError(
                f"feeds {bad[:8]} are already dropped")
        self._drain_for_topology(drain_rounds)
        for k in sorted(set(int(o) for o in owners)):
            slot = self._slots[k]
            sel = feeds[owners == k]
            local = self._local_index[sel]
            r0 = np.zeros(len(sel), np.float32)
            h1 = np.ones(len(sel), np.uint32)
            dg = _topology.range_digest(sel, r0, h1)
            self._topo.assert_owner(self._owner[sel], k, sel)
            slot.runtime.install_range(
                [int(i) for i in local], r0, h1,
                feeds=[int(f) for f in sel],
                topo_epoch=self._topo.next_epoch(), digest=dg,
                plan_id="drop", range_id=-1)
            slot.runtime.snapshot()
        self._append_topo({"kind": "drop_edges",
                           "epoch": self._topo.next_epoch(),
                           "feeds": [int(f) for f in feeds]})

    # ---- read / inspection paths ----

    def _slot_pending(self, slot: _ShardSlot) -> int:
        """One shard's pending count; a worker that died since the last
        round classifies as a crash here (its pending died with it —
        the outstanding seqs were reclassified lost)."""
        if slot.runtime is None:
            return 0
        try:
            return int(slot.runtime.pending)
        except TransportTimeout as e:
            # The short read deadline expired with the child alive —
            # busy or stalled, not proven dead: degrade and back off,
            # exactly like a poll deadline.  SIGKILLing a healthy
            # worker over one slow read would convert a hiccup into a
            # full journal-replay recovery.
            self._on_timeout(slot, f"status read timed out: {e}")
            return 0
        except TransportError as e:
            self._lost_link(slot, e, f"worker died on status: {e}",
                            wait=False)
            return 0

    @property
    def pending(self) -> int:
        return sum(self._slot_pending(s) for s in self._slots)

    @property
    def pending_by_shard(self) -> List[int]:
        return [self._slot_pending(s) for s in self._slots]

    @property
    def health_by_shard(self) -> List[str]:
        return [s.health for s in self._slots]

    @property
    def shard_dirs(self) -> List[Optional[str]]:
        return [s.dir for s in self._slots]

    @property
    def edges_per_shard(self) -> List[int]:
        # Ownership, not geometry: a slot's array can still HOLD a
        # range that migrated off it (frozen, excluded from reads).
        return [int((self._owner == s.k).sum()) for s in self._slots]

    @property
    def applied_seq(self) -> int:
        """The cluster's acknowledged stream position: the MIN applied
        seq over shards (a quarantined shard counts -1 — everything
        must be retransmitted until it recovers and reports)."""
        seqs = []
        for s in self._slots:
            if s.retired:
                continue
            if s.runtime is None:
                seqs.append(-1)
                continue
            try:
                seqs.append(int(s.runtime.applied_seq))
            except TransportTimeout as e:
                # Alive but slow: degrade (see _slot_pending) and
                # report -1 — the source retransmits, duplicate drop
                # absorbs any overshoot once the shard answers again.
                self._on_timeout(s, f"status read timed out: {e}")
                seqs.append(-1)
            except TransportError as e:
                self._lost_link(s, e, f"worker died on status: {e}",
                                wait=False)
                seqs.append(-1)
        return min(seqs)

    def decide(self) -> Optional[ClusterDecision]:
        """The non-blocking cluster read: aggregate the latest applied
        decision of every reporting shard (quarantined shards are
        excluded and COUNTED — degraded serving is visible, never a
        blocked read).  None until a first batch applies somewhere."""
        self.metrics.decisions_served += 1
        per = []
        for slot in self._slots:
            if slot.runtime is None:
                continue
            try:
                d = slot.runtime.decide()
            except TransportTimeout as e:
                # Alive but past the short read deadline: one fewer
                # reporter THIS read, degrade + backoff — never a
                # SIGKILL over a slow answer.
                self._on_timeout(slot, f"decide read timed out: {e}")
                continue
            except TransportError as e:
                # A dead worker degrades the read (one fewer reporter),
                # never blocks it; a severed socket link reattaches
                # only if the worker already redialed (wait=False: the
                # read path never pays the full grace).
                self._lost_link(slot, e, f"worker died on decide: {e}",
                                wait=False)
                continue
            if d is not None:
                per.append(d)
        if not per:
            return None
        stale = self.pending
        if stale:
            self.metrics.stale_decisions += 1
        return ClusterDecision(
            seq=min(d.seq for d in per),
            post=any(d.post for d in per),
            intensity=float(sum(d.intensity for d in per)),
            stale_batches=stale,
            shards_reporting=len(per),
            shards_quarantined=sum(1 for s in self._slots
                                   if s.runtime is None
                                   and not s.retired))

    def shard_digests(self) -> Dict[int, Optional[str]]:
        out: Dict[int, Optional[str]] = {}
        for s in self._slots:
            if s.retired:
                continue
            if s.runtime is None:
                out[s.k] = None
                continue
            try:
                out[s.k] = s.runtime.state_digest()
            except TransportTimeout as e:
                self._on_timeout(s, f"digest read timed out: {e}")
                out[s.k] = None
            except TransportError as e:
                self._lost_link(s, e, f"worker died on digest: {e}",
                                wait=False)
                out[s.k] = None
        return out

    def cluster_digest(self,
                       digests: Optional[Dict[int, Optional[str]]] = None
                       ) -> str:
        """sha256 over the per-shard carry digests (every shard must be
        live) — the whole-cluster bit-identity witness the chaos tests
        compare.  Pass ``digests`` (a :meth:`shard_digests` result) to
        reuse already-computed digests: each one is a full device→host
        transfer + hash of the shard carry."""
        h = hashlib.sha256()
        if digests is None:
            digests = self.shard_digests()
        for k, d in sorted(digests.items()):
            if d is None:
                raise ValueError(
                    f"shard {k} is quarantined — recover it before "
                    f"taking a cluster digest")
            h.update(f"{k}:{d}\n".encode())
        return h.hexdigest()

    def _gather_edges(self) -> Tuple[np.ndarray, np.ndarray, int, float,
                                     int]:
        """Assemble the global per-edge carry ``(rank, health)`` plus
        the stream position ``(seq, cluster clock, n_batches)`` from the
        live shards.  ``ServingRuntime.gather`` owns the one explicit
        device→host boundary per shard; ``WorkerHandle.gather`` answers
        it bit-identically over the frame protocol, so both placements
        produce byte-equal edge digests.  Requires every shard live and
        at the SAME seq (drained)."""
        rank = np.zeros(self.n_feeds, np.float32)
        health = np.zeros(self.n_feeds, np.uint32)
        seqs, ts, nbs = [], [], []
        for slot in self._slots:
            if slot.retired:
                continue
            if slot.runtime is None:
                raise ValueError(
                    f"shard {slot.k} is quarantined — recover before "
                    f"gathering edge state")
            r, h, sq, t, nb = slot.runtime.gather()
            # Ownership-masked: a migrated-off range still sits frozen
            # in the source's arrays (and a dropped edge sits poisoned
            # in its old owner's) — only the feeds this slot OWNS
            # contribute to the global view.
            own = self._owner[slot.feeds] == slot.k
            sel = slot.feeds[own]
            rank[sel] = r[own]
            health[sel] = h[own]
            seqs.append(int(sq))
            ts.append(float(t))
            nbs.append(int(nb))
        if len(set(seqs)) != 1:
            raise ValueError(
                f"shards disagree on applied seq ({seqs}) — drain "
                f"(retransmit + poll) before gathering edge state")
        return rank, health, seqs[0], max(ts), max(nbs)

    def edge_digest(self) -> str:
        """Canonical digest of the cluster's PER-EDGE serving state —
        global ``(rank, health)`` by feed id, the stream seq, and the
        cluster clock — independent of the partition, so it is THE
        reshard witness: an N→M migration must preserve it bitwise."""
        rank, health, seq, t_max, _ = self._gather_edges()
        live = np.flatnonzero(self._owner >= 0)
        h = hashlib.sha256()
        h.update(np.int64(len(live)).tobytes())
        h.update(np.int64(seq).tobytes())
        h.update(np.float32(t_max).tobytes())
        if len(live) != self.n_feeds:
            # Dropped edges leave holes: the surviving feed ids become
            # part of the witness.  When nothing was ever dropped the
            # digest stays byte-identical to the pre-elastic format.
            h.update(live.astype(np.int64).tobytes())
        h.update(rank[live].tobytes())
        h.update(health[live].tobytes())
        return h.hexdigest()

    # ---- durability / artifacts ----

    def snapshot_all(self) -> Dict[int, Optional[int]]:
        out: Dict[int, Optional[int]] = {}
        for s in self._slots:
            if s.runtime is None:
                continue
            try:
                out[s.k] = s.runtime.snapshot()
            except TransportTimeout as e:
                self._on_timeout(s, f"snapshot deadline expired: {e}")
            except TransportError as e:
                self._lost_link(s, e, f"worker died on snapshot: {e}")
        return out

    def write_metrics(self, path: Optional[str] = None,
                      extra: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """The ``rq.serving.metrics/2`` artifact (defaults into the
        cluster directory)."""
        if path is None:
            if self.dir is None:
                raise ValueError("no cluster directory and no path given")
            path = os.path.join(self.dir, "metrics.json")
        base = {"n_feeds": self.n_feeds, "q": self.q,
                "applied_seq": self.applied_seq,
                "durability": self.durability()}
        if extra:
            base.update(extra)
        return self.metrics.write(path, self.pending_by_shard,
                                  self.health_by_shard, extra=base)

    def durability(self) -> Dict[str, Any]:
        """The cluster's configured durability window (identical on
        every shard) — committed in the ``rq.serving.metrics/2``
        artifact so no throughput number is ever quoted without its
        durability cost (``journal.durability_info`` is the one
        definition)."""
        from .journal import durability_info

        repl = (None if not self.replication_factor
                else {"factor": self.replication_factor,
                      "quorum": (self.replication_quorum
                                 if self.replication_quorum is not None
                                 else self.replication_factor // 2 + 1)})
        return durability_info(self.flush_mode, self.fsync_every_n,
                               self.max_unflushed_records,
                               self.max_flush_delay_ms, self.coalesce,
                               replication=repl)

    def close(self) -> None:
        for slot in self._slots:
            if slot.runtime is not None:
                slot.runtime.close()
            if slot.listener is not None:
                slot.listener.close()
                slot.listener = None
        if self._topo_log is not None:
            self._topo_log.close()
            self._topo_log = None

    def reset_metrics(self) -> None:
        """Fresh router ledger (bench warm-up exclusion); refused while
        sub-batches are pending anywhere — see
        ``ServingRuntime.reset_metrics``."""
        if self.pending:
            raise ValueError(
                f"cannot reset metrics with {self.pending} sub-batches "
                f"pending — drain (poll) first")
        for slot in self._slots:
            if slot.runtime is not None:
                try:
                    slot.runtime.reset_metrics()
                except TransportTimeout as e:
                    self._on_timeout(
                        slot, f"reset_metrics timed out: {e}")
                except TransportError as e:
                    self._lost_link(
                        slot, e, f"worker died on reset_metrics: {e}")
            slot.outstanding.clear()
        self.metrics = ClusterMetrics(self.n_shards, clock=self._clock)
        # Counters restart; the epoch is structural state, not a count.
        self.metrics.set_topology_epoch(self._topo.epoch)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# The class IS the router: routing, health, and
# recovery live on the cluster object itself — no extra indirection.
ShardRouter = ServingCluster


# ---------------------------------------------------------------------------
# Reshard: digest-asserted N -> M state migration (grow without genesis
# replay)
# ---------------------------------------------------------------------------

def reshard(src_dir: str, dst_dir: str, n_shards: int,
            clock=time.monotonic,
            device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Migrate a DRAINED cluster directory from its current shard count
    to ``n_shards`` fault domains under ``dst_dir`` (which must not
    exist or be empty; ``src_dir`` is left intact as the rollback).

    Protocol: recover every source shard (provable snapshot + journal
    replay — nothing unproven migrates), require a uniform applied seq
    (an undrained cluster refuses), gather the global per-edge
    ``(rank, health)`` carry and the stream position, deal the edges to
    the NEW partition, install the migrated carry into each fresh shard
    and land an IMMEDIATE snapshot at the migrated seq (post-reshard
    recovery never replays from genesis), then **assert the per-edge
    digest is bit-identical across the move** — a divergent migration
    raises instead of serving silently-wrong state.  Per-shard decision
    keys re-derive from the new shard ids (decisions from ``seq+1`` on
    are deterministic in the new geometry); per-shard lifetime counters
    (``n_events``/``n_posts``) reset — they are fault-domain metrics,
    not stream state.  Returns the enveloped report also written to
    ``<dst_dir>/reshard.json`` (schema ``rq.serving.reshard/1``).

    Both clusters serve on ``device`` (the card unless ``device="cpu"``):
    the migrated carry is built as tensors there, health entering as the
    int32 bit pattern of its uint32 words (a bit view, never a value
    cast — the carry digest hashes those bits)."""
    src, _ = ServingCluster.recover(src_dir, clock=clock,
                                    auto_recover=False, device=device)
    try:
        rank_g, health_g, seq, t_max, n_batches = src._gather_edges()
        edge_before = src.edge_digest()
        cfg = src._config()
    finally:
        src.close()

    if os.path.exists(dst_dir) and os.listdir(dst_dir):
        raise ValueError(
            f"reshard destination {dst_dir} is not empty — refusing to "
            f"mix with existing serving state")
    dst = None
    try:
        # Construction INSIDE the cleanup scope: a shard runtime that
        # fails to open mid-constructor has already written the cluster
        # config and the earlier shards' directories — that partial,
        # unverified destination must die with the failure too, not
        # just failures past this point.
        dst = ServingCluster(
            n_feeds=int(cfg["n_feeds"]), n_shards=int(n_shards),
            dir=dst_dir, q=float(cfg["q"]),
            s_sink=np.asarray(cfg["s_sink"], np.float64),
            seed=int(cfg["seed"]), start_seq=int(cfg["start_seq"]),
            snapshot_every=int(cfg["snapshot_every"]),
            reorder_window=int(cfg["reorder_window"]),
            queue_capacity=int(cfg["queue_capacity"]),
            max_batch_events=int(cfg["max_batch_events"]),
            fsync_every_n=int(cfg.get("fsync_every_n", 1)),
            flush_mode=str(cfg.get("flush_mode", "sync")),
            max_unflushed_records=int(
                cfg.get("max_unflushed_records", 64)),
            max_flush_delay_ms=float(
                cfg.get("max_flush_delay_ms", 50.0)),
            coalesce=int(cfg.get("coalesce", 1)), clock=clock,
            device=device)
        for slot in dst._slots:
            st = slot.runtime.carry
            dev = st.device
            migrated = st.replace(
                rank=torch.from_numpy(np.ascontiguousarray(
                    rank_g[slot.feeds], np.float32)).to(dev),
                health=torch.from_numpy(np.ascontiguousarray(
                    health_g[slot.feeds], np.uint32).view(np.int32)
                ).to(dev),
                t=torch.tensor(t_max, dtype=st.t.dtype, device=dev),
                seq=torch.tensor(seq, dtype=torch.int32, device=dev),
                n_batches=torch.tensor(n_batches, dtype=torch.int32,
                                       device=dev))
            slot.runtime.install_carry(migrated)
            slot.runtime.snapshot()
        edge_after = dst.edge_digest()
        if edge_after != edge_before:
            raise RuntimeError(
                f"reshard diverged: per-edge digest "
                f"{edge_after[:12]}.. after migration != "
                f"{edge_before[:12]}.. before — refusing to serve "
                f"migrated state (src left intact at {src_dir}, "
                f"divergent destination removed)")
        report = {
            "src_dir": os.path.abspath(src_dir),
            "dst_dir": os.path.abspath(dst_dir),
            "n_shards_src": int(cfg["n_shards"]),
            "n_shards_dst": int(n_shards),
            "n_feeds": int(cfg["n_feeds"]),
            "seq": int(seq),
            "n_batches": int(n_batches),
            "edge_digest": edge_before,
            "edges_per_shard": [int(len(s.feeds)) for s in dst._slots],
            "verified": True,
        }
        _integrity.write_json(os.path.join(dst_dir, "reshard.json"),
                              report, schema=RESHARD_SCHEMA)
    except BaseException:
        # A half-built destination is a fully-formed cluster directory
        # holding UNVERIFIED migrated state — left on disk, a later
        # ServingCluster.recover(dst_dir) would serve exactly the
        # silently-wrong state the digest assert refuses, so the
        # destination (created by us: it was empty at entry) dies with
        # the failure.
        if dst is not None:
            dst.close()
        shutil.rmtree(dst_dir, ignore_errors=True)
        raise
    dst.close()
    return report
