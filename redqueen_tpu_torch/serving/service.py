"""The online serving runtime: bounded ingest, journaled apply, recovery
(the counterpart of the JAX package's ``serving.service``).

One :class:`ServingRuntime` owns one feed-state carry on one device (the
card unless ``device="cpu"``), one journal, and one snapshot directory.
The data path is

    submit(batch) -> [validate -> dedup/reorder -> bounded queue]
    poll()        -> [apply (device) -> one read -> journal -> commit]
    decide()      -> [read the latest applied carry, never blocks]

Three robustness layers, each deterministic and CI-driven through
``runtime.faultinject``'s ``ingest`` kinds:

**Crash safety.**  Every applied batch lands as one fsynced checksummed
journal record (``serving.journal``) BEFORE the apply is acknowledged,
and every ``snapshot_every`` batches the carry goes through
``utils.checkpoint`` (an enveloped NPZ per step, corrupt-tolerant
``latest_valid_step``).
:func:`recover` = newest provable snapshot + journal replay: because the
apply step is a pure function of (carry, batch) with counter-addressed
draws, replay reconstructs the killed process's carry and decision
stream **bit-identically** (asserted per record against the journaled
state digest — a divergent replay raises instead of serving wrong
state).

**Idempotent, order-tolerant ingest.**  Sequence-numbered batches;
duplicates drop, a bounded reorder window holds early arrivals, beyond
the window is a typed rejection carrying the missing-seq retransmit
list, malformed events are typed :class:`IngestError` rejections, and a
non-finite rank quarantines exactly that edge via the health bits
while healthy edges keep serving.

**Graceful degradation.**  The ingest queue is bounded: past capacity,
new batches are SHED (counted, seqs recorded — never a silent gap) and
the admission carries ``backpressure=True`` from the high-water mark on;
``decide`` always answers from the latest applied carry (stale-but-
served beats blocked) with the backlog depth reported as staleness.
Everything lands in the ``rq.serving.metrics/1`` artifact with the
closed accounting identity ``ingested == applied + shed + rejected +
duplicates (+ pending)``.
"""

from __future__ import annotations

import collections
import os
import time
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.lanes import bucket_width
from ..runtime import faultinject as _faultinject
from ..runtime import integrity as _integrity
from ..runtime import telemetry as _telemetry
from .events import EventBatch, IngestError, validate_batch
from .ingest import Sequencer
from .journal import (FLUSH_MODES, JOURNAL_FILENAME, Journal,
                      JournalError, replay as journal_replay)
from .metrics import ServingMetrics
from .paramswap import (PARAMS_LOG_FILENAME, PARAMS_LOG_SCHEMA,
                        ValidatedParams, params_digest)
from .state import (Decision, FeedState, init_feed_state, make_apply_fn,
                    make_coalesced_apply_fn, poison_edge, read_decisions,
                    state_digest, state_to_numpy)

__all__ = ["ServingRuntime", "Admission", "RecoveryInfo", "recover",
           "journal_decisions", "CONFIG_SCHEMA", "SNAPSHOTS_DIRNAME"]

CONFIG_SCHEMA = "rq.serving.config/1"
_JOURNAL = JOURNAL_FILENAME  # shared contract lives in serving.journal
# Public: the cluster layer (serving.cluster) addresses a shard's
# snapshot tree for the corrupt_snapshot fault + recovery assertions.
SNAPSHOTS_DIRNAME = "snapshots"
_SNAPSHOTS = SNAPSHOTS_DIRNAME
_CONFIG = "config.json"


class Admission(NamedTuple):
    """The outcome of one ``submit``: ``status`` is ``accepted`` /
    ``duplicate`` / ``shed`` / ``rejected``; ``backpressure`` asks the
    source to slow down; ``missing`` is the retransmit list when the
    reorder window is blocked on a gap."""

    status: str
    seq: Optional[int] = None
    backpressure: bool = False
    reason: Optional[str] = None
    missing: Tuple[int, ...] = ()


class RecoveryInfo(NamedTuple):
    """What :func:`recover` did: where the carry came from and what the
    journal contributed."""

    snapshot_seq: Optional[int]   # snapshot step restored, None = fresh
    replayed: int                 # journal batches re-applied
    skipped: int                  # batches already inside the snapshot
    torn: Optional[Dict[str, Any]]  # quarantined-tail info, None = clean
    recovered_seq: int            # the carry's seq after recovery
    # Acked seqs the journal did NOT keep — the group-commit durability
    # window a power-style crash actually consumed.  Non-empty only when
    # the caller told recover() its ack high-water mark (``acked_seq``);
    # the source's retransmit past ``recovered_seq`` heals exactly these.
    # Under quorum replication this is the EXACT quorum-loss set: with
    # ``heal_replicas`` the surviving holders re-seed the journal before
    # replay, so a seq appears here iff EVERY holder died before its
    # lagging checkpoint.
    lost_acked_seqs: Tuple[int, ...] = ()
    # Seqs re-seeded from surviving replica holders before replay
    # (``heal_replicas``): records the leader's disk lost but the quorum
    # kept — present in the recovered carry, absent from the loss set.
    healed_seqs: Tuple[int, ...] = ()


#: Smallest padded dispatch width the live apply paths use: pad widths
#: are pow-2 BUCKETS between this floor and ``max_batch_events`` (the
#: unified lane layer, ``parallel.lanes.bucket_width``), so a 3-event
#: micro-batch no longer pads to the full configured width while the
#: number of compiled apply shapes stays <= log2(E/floor)+1.  The apply
#: step is bitwise invariant to the pad width (every padded slot is
#: ``valid``-masked; asserted against the full-width path in
#: tests/test_serving_wirespeed.py), so replay/recovery — which may pad
#: at a different width — stays bit-identical.
_PAD_WIDTH_FLOOR = 16


def _pad_width(n_events: int, max_batch_events: int) -> int:
    """Bucketed pad width for a group of ``n_events`` valid events."""

    return bucket_width(int(n_events), floor=_PAD_WIDTH_FLOOR,
                        cap=int(max_batch_events))


def _pad_events(times, feeds, width: int):
    """Pad one batch to the dispatch width (a pow-2 bucket on the live
    path, the full ``max_batch_events`` on replay — the apply step's
    bitwise pad-width invariance makes the two interchangeable)."""
    E = int(width)
    t = np.zeros(E, np.float32)
    f = np.zeros(E, np.int32)
    n = len(times)
    t[:n] = np.asarray(times, np.float64)
    f[:n] = np.asarray(feeds, np.int64)
    return t, f, np.int32(n)


def _param_tensor(x, device: torch.device) -> torch.Tensor:
    """A policy parameter (host float64 or float) as a NEW float32 tensor
    on ``device``: every install makes fresh tensors, so an apply still
    holding the previous epoch's keeps them intact."""
    return torch.as_tensor(np.asarray(x, np.float64),
                           dtype=torch.float32).to(device)


def _set_range(state: FeedState, idx, rank, health) -> FeedState:
    """``state`` with ``rank``/``health`` (host float32 / uint32 values)
    set at edges ``idx`` — new tensors, the input carry untouched."""
    dev = state.device
    i = torch.as_tensor(np.asarray(idx, np.int64)).to(dev)
    r = torch.from_numpy(np.ascontiguousarray(
        np.asarray(rank, np.float32))).to(dev)
    h = torch.from_numpy(np.ascontiguousarray(
        np.asarray(health, np.uint32)).view(np.int32)).to(dev)
    new_rank = state.rank.clone()
    new_health = state.health.clone()
    new_rank[i] = r
    new_health[i] = h
    return state.replace(rank=new_rank, health=new_health)


class ServingRuntime:
    """See the module docstring.  Single-writer by design: one process
    owns the directory (the watchdog/lease layer guards multi-process
    misuse at deployment granularity, not here)."""

    def __init__(self, n_feeds: int, q: float = 1.0,
                 s_sink: Optional[np.ndarray] = None, seed: int = 0,
                 dir: Optional[str] = None, start_seq: int = 0,
                 snapshot_every: int = 8, reorder_window: int = 8,
                 queue_capacity: int = 64, max_batch_events: int = 256,
                 fsync_every_n: int = 1, flush_mode: str = "sync",
                 max_unflushed_records: int = 64,
                 max_flush_delay_ms: float = 50.0, coalesce: int = 1,
                 journal_format: Optional[str] = None,
                 replication_factor: int = 0,
                 replication_quorum: Optional[int] = None,
                 replication_mode: str = "thread",
                 replication_ack_timeout_s: float = 1.0,
                 clock=time.monotonic,
                 _state: Optional[FeedState] = None,
                 device: DeviceLike = "cuda"):
        if n_feeds < 1:
            raise ValueError(f"n_feeds must be >= 1, got {n_feeds}")
        if not (np.isfinite(q) and q > 0):
            raise ValueError(f"q must be finite and > 0, got {q!r}")
        if queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {queue_capacity}")
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self.n_feeds = int(n_feeds)
        self.q = float(q)
        s = (np.ones(n_feeds) if s_sink is None
             else np.asarray(s_sink, np.float64))
        if s.shape != (n_feeds,):
            raise ValueError(
                f"s_sink must have shape ({n_feeds},), got {s.shape}")
        bad = ~(np.isfinite(s) & (s >= 0))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"s_sink must be finite and >= 0, got {s[i]!r} at {i}")
        self.seed = int(seed)
        self.dir = dir
        self.snapshot_every = int(snapshot_every)
        self.queue_capacity = int(queue_capacity)
        self.max_batch_events = int(max_batch_events)
        if int(fsync_every_n) < 1:
            raise ValueError(
                f"fsync_every_n must be >= 1, got {fsync_every_n}")
        self.fsync_every_n = int(fsync_every_n)
        if flush_mode not in FLUSH_MODES:
            raise ValueError(f"flush_mode must be one of {FLUSH_MODES}, "
                             f"got {flush_mode!r}")
        self.flush_mode = flush_mode
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
        self.replication_ack_timeout_s = float(replication_ack_timeout_s)
        self._clock = clock
        self.device = (_state.device if _state is not None
                       else resolve_device(device))
        self._s_sink = _param_tensor(s, self.device)
        self._q = _param_tensor(self.q, self.device)
        # Two-slot epoch state for the guarded hot-swap (serving.
        # paramswap): epoch 0 is the constructor's vetted params; every
        # install bumps the epoch and retains the outgoing slot as the
        # rollback target.  An install REPLACES the param tensors (never
        # writes into them) and the applies take them as ARGUMENTS, so
        # an in-flight apply that captured the old tensors finishes on
        # the old epoch with no lock on the decision path.
        self._param_epoch = 0
        self._param_fingerprint = "initial"
        self._param_prev: Optional[Dict[str, Any]] = None
        self._apply = make_apply_fn()
        self._apply_many = (make_coalesced_apply_fn()
                            if self.coalesce > 1 else None)
        self._queue: collections.deque = collections.deque()
        # arrival stamps for batches held in the reorder window (popped
        # when they drain into the queue; bounded by the window size)
        self._arrival: Dict[int, float] = {}
        self._seq = Sequencer(start_seq=start_seq, window=reorder_window)
        self.metrics = ServingMetrics(clock=clock)
        self._last_decision: Optional[Decision] = None
        self._since_snapshot = 0
        self._fault = _faultinject.ingest_fault()

        if _state is not None:
            self._state = _state
            self._seq.next_seq = int(_state.seq) + 1
        else:
            self._state = init_feed_state(n_feeds, seed,
                                          start_seq=start_seq,
                                          device=self.device)
            self._state = self._maybe_poison(self._state)

        self._prewarm_pad_widths()
        self._journal: Optional[Journal] = None
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            cfg_path = os.path.join(dir, _CONFIG)
            cfg = {
                "n_feeds": self.n_feeds, "q": self.q,
                "s_sink": [float(x) for x in s],
                "seed": self.seed, "start_seq": int(start_seq),
                "snapshot_every": self.snapshot_every,
                "reorder_window": int(reorder_window),
                "queue_capacity": self.queue_capacity,
                "max_batch_events": self.max_batch_events,
                # Durability/throughput knobs, NOT replay identity:
                # group commit changes when records hit media and
                # coalescing changes how many batches share a dispatch/
                # record, never what either says (the coalesced apply is
                # grouping-invariant bitwise — asserted in tests) — so
                # they are recorded (recover() reuses them) but excluded
                # from the mismatch refusal below.
                "fsync_every_n": self.fsync_every_n,
                "flush_mode": self.flush_mode,
                "max_unflushed_records": self.max_unflushed_records,
                "max_flush_delay_ms": self.max_flush_delay_ms,
                "coalesce": self.coalesce,
                # Same non-identity class: the journal encoding and the
                # replication group shape where/when records persist,
                # never what they say — replay is format-sniffing and
                # quorum is an ack property, so both are recorded for
                # recover() but excluded from the refusal below.
                "journal_format": self.journal_format,
                "replication_factor": self.replication_factor,
                "replication_quorum": self.replication_quorum,
                "replication_mode": self.replication_mode,
            }
            if os.path.exists(cfg_path):
                # The stored config is the directory's identity: the
                # journal/snapshots in it were produced under these
                # parameters, and recover() rebuilds from them.  A
                # constructor that silently disagrees on a
                # determinism-critical field would journal records the
                # stored config can no longer replay — wedging the
                # directory with a misleading digest-divergence error
                # at the NEXT recovery.  Refuse loudly instead.
                stored = _integrity.read_json(cfg_path,
                                              schema=CONFIG_SCHEMA)
                for field in ("n_feeds", "q", "s_sink", "seed",
                              "start_seq", "max_batch_events"):
                    if stored.get(field) != cfg[field]:
                        raise ValueError(
                            f"serving dir {dir} was created with "
                            f"{field}={stored.get(field)!r} but this "
                            f"runtime was constructed with "
                            f"{field}={cfg[field]!r} — replay would "
                            f"diverge; recover() the directory with "
                            f"its stored config, or use a fresh "
                            f"directory")
            else:
                _integrity.write_json(cfg_path, cfg,
                                      schema=CONFIG_SCHEMA)
            if self.replication_factor >= 1:
                from .replication import ReplicatedJournal
                self._journal = ReplicatedJournal(
                    os.path.join(dir, _JOURNAL),
                    factor=self.replication_factor,
                    quorum=self.replication_quorum,
                    mode=self.replication_mode,
                    ack_timeout_s=self.replication_ack_timeout_s,
                    fsync_every_n=self.fsync_every_n,
                    max_unflushed_records=self.max_unflushed_records,
                    max_flush_delay_ms=self.max_flush_delay_ms,
                    fmt=self.journal_format)
            else:
                self._journal = Journal(
                    os.path.join(dir, _JOURNAL),
                    fsync_every_n=self.fsync_every_n,
                    flush_mode=self.flush_mode,
                    max_unflushed_records=self.max_unflushed_records,
                    max_flush_delay_ms=self.max_flush_delay_ms,
                    fmt=self.journal_format)

    # ---- ingest path ----

    def _maybe_poison(self, state: FeedState) -> FeedState:
        """The ``numeric`` fault kind addresses serving EDGES the way it
        addresses sim lanes (deterministic stand-in for an in-memory bit
        flip), so the edge-quarantine path runs in CI."""
        hit = _faultinject.active_numeric_lane(self.n_feeds)
        if hit is None:
            return state
        lane, mode = hit
        return poison_edge(state, lane, mode)

    @property
    def pending(self) -> int:
        """Batches accepted but not yet applied (queued + held in the
        reorder window)."""
        return len(self._queue) + self._seq.held

    @property
    def applied_seq(self) -> int:
        return int(self._state.seq)

    @property
    def carry(self) -> FeedState:
        """Read-only view of the live carry — the cluster layer's state-
        migration (reshard) and edge-digest paths read it through one
        explicit device-to-host read on their side; mutating it would
        desynchronize the journal, so don't."""
        return self._state

    @property
    def journal_path(self) -> Optional[str]:
        """The LIVE journal file (None when running without a directory)
        — what the cluster's ``shard:torn_journal`` fault tears."""
        return None if self._journal is None else self._journal.path

    def next_queued_seq(self) -> Optional[int]:
        """Sequence number of the batch the next ``poll(max_batches=1)``
        would apply, or None when the queue is empty — the cluster
        router's per-batch dispatch peek (it polls one batch at a time
        so shard faults land at exact sequence numbers)."""
        return int(self._queue[0][0].seq) if self._queue else None

    def reset_metrics(self) -> None:
        """Start a fresh metrics block (same contract as recovery: the
        report describes steady state from this instant).  Refused while
        batches are pending — zeroing the counters under a live backlog
        would break the closed accounting identity."""
        if self.pending:
            raise ValueError(
                f"cannot reset metrics with {self.pending} batches "
                f"pending — drain (poll) first")
        self.metrics = ServingMetrics(clock=self._clock)
        # submit() copies the sequencer's lifetime counters into the
        # report by absolute overwrite — pre-reset duplicate/reorder
        # traffic would resurface as phantom counts and break the
        # closed identity, so they reset with the ledger.
        self._seq.duplicates = 0
        self._seq.reordered = 0
        self._seq.window_rejects = 0

    def install_carry(self, state: FeedState) -> None:
        """Replace the carry with a MIGRATED one (the cluster reshard
        path).  Only legal on a fresh runtime — nothing applied, nothing
        queued, nothing journaled — and the caller must ``snapshot()``
        right after so the migrated state has a durable recovery base
        (the journal holds no records for it)."""
        # Freshness witness is the carry's apply counter, NOT
        # applied_seq: a fresh runtime built with start_seq=S sits at
        # applied_seq=S-1 (>= 0 for any S > 0), but n_batches is 0
        # until something actually applies.
        n_applied = int(self._state.n_batches)
        if self.pending or n_applied:
            raise ValueError(
                f"install_carry needs a fresh runtime (pending="
                f"{self.pending}, batches applied={n_applied}) — "
                f"migrating over live serving state would desync the "
                f"journal")
        if tuple(state.rank.shape) != (self.n_feeds,):
            raise ValueError(
                f"migrated carry has {state.rank.shape[0]} edges, this "
                f"runtime serves {self.n_feeds}")
        if state.device != self.device:
            raise ValueError(
                f"migrated carry lives on {state.device}, this runtime "
                f"serves on {self.device}")
        self._state = state
        self._seq.next_seq = int(state.seq) + 1

    # ---- live resharding range handoff (serving.topology drives) ----

    def extract_range(self, idx: Sequence[int]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The carry slice for local feed indices ``idx`` as host
        arrays ``(rank f32, health u32)`` — what the migration fence
        streams to the destination.  Read-only, but only meaningful on
        a drained runtime (a pending batch could still mutate the
        slice)."""
        if self.pending:
            raise ValueError(
                f"extract_range with {self.pending} batches pending — "
                f"drain (poll) first; a queued apply could mutate the "
                f"fenced slice")
        idx = np.asarray(idx, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_feeds):
            raise ValueError(
                f"extract_range indices out of range for {self.n_feeds}"
                f" feeds")
        r, h, _sq, _t, _nb = self.gather()
        return r[idx].copy(), h[idx].copy()

    def install_range(self, idx: Sequence[int], rank: np.ndarray,
                      health: np.ndarray, *, feeds: Sequence[int],
                      topo_epoch: int, digest: str, plan_id: str,
                      range_id: int) -> None:
        """Install one migrated range into the carry — the journaled,
        digest-asserted, IDEMPOTENT scatter-set the live-reshard flip
        depends on (the cluster layer's ``Migration`` calls this only
        after ``assert_fenced``).

        The record lands in this shard's own journal (fsynced, like a
        parameter-epoch record) BEFORE the in-memory flip, keyed by
        ``topo_epoch`` and pinned to the current applied seq, so
        recovery re-applies it at exactly the same stream position —
        and because it is a pure set of journaled values, replaying it
        twice (a resumed migration re-installs after a crash) is
        bit-identical to once."""
        if self.pending:
            raise ValueError(
                f"install_range with {self.pending} batches pending — "
                f"drain (poll) first; the install must land at a "
                f"well-defined stream position")
        idx = np.asarray(idx, np.int32)
        r = np.ascontiguousarray(np.asarray(rank, np.float32))
        h = np.ascontiguousarray(np.asarray(health, np.uint32))
        feeds = [int(f) for f in feeds]
        if not (idx.shape == r.shape == h.shape
                and len(feeds) == idx.shape[0]):
            raise ValueError(
                f"install_range arrays disagree: {idx.shape[0]} "
                f"indices, {r.shape[0]} ranks, {h.shape[0]} health "
                f"words, {len(feeds)} feeds")
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_feeds):
            raise ValueError(
                f"install_range indices out of range for "
                f"{self.n_feeds} feeds")
        from .topology import range_digest
        got = range_digest(feeds, r, h)
        if got != digest:
            raise RuntimeError(
                f"range payload digest mismatch at install: fence "
                f"says {str(digest)[:12]}.., arrays hash to "
                f"{got[:12]}.. — the slice was altered between fence "
                f"and install; refusing")
        new = _set_range(self._state, idx, r, h)
        rec = {
            "topo_epoch": int(topo_epoch),
            "plan": str(plan_id),
            "range": int(range_id),
            "seq": self.applied_seq,
            "idx": [int(i) for i in idx],
            "feeds": feeds,
            "rank": [float(x) for x in r],
            "health": [int(x) for x in h],
            "digest": str(digest),
            "state_digest": state_digest(new),
        }
        with _telemetry.span("serving.topo.install_range",
                             plan=str(plan_id), range=int(range_id)):
            if self._journal is not None:
                try:
                    self._journal.append(rec, seq=self.applied_seq)
                    # Same durability contract as a param install: the
                    # flip the router is about to journal must never
                    # outlive this record in a crash.
                    self._journal.sync()
                except OSError as e:
                    raise RuntimeError(
                        f"journal append failed for topology epoch "
                        f"{topo_epoch} range install: {e} — range "
                        f"installs must be durable; restart and recover "
                        f"from {self.dir}") from e
            self._state = new

    # ---- live-parameter epoch swap (serving.paramswap is the gate) ----

    def live_params(self) -> Dict[str, Any]:
        """The policy parameters currently deciding, as host arrays —
        what the swapper snapshots before an install (the rollback
        target) and what ``status`` surfaces."""
        return {
            "s_sink": self._s_sink.cpu().numpy().astype(np.float64),
            "q": float(self._q.cpu()),
            "epoch": self._param_epoch,
            "fingerprint": self._param_fingerprint,
        }

    def previous_params(self) -> Optional[Dict[str, Any]]:
        """The retained previous slot (last-good before the newest
        install); None before any install."""
        return None if self._param_prev is None else dict(self._param_prev)

    def install_params(self, vp: ValidatedParams) -> int:
        """Atomically install gate-validated parameters as a new epoch.

        Takes ONLY a :class:`serving.paramswap.ValidatedParams` token
        (minted by ``ParamGate`` — the validation gate is the one road
        into the live policy).  The token's digest is re-derived from
        the arrays immediately before the flip — a mismatch means
        tampering between gate and install and refuses loudly.  Returns the new
        epoch."""
        if not isinstance(vp, ValidatedParams):
            raise TypeError(
                f"install_params takes a ValidatedParams token minted "
                f"by serving.paramswap.ParamGate, got "
                f"{type(vp).__name__} — raw parameters cannot be "
                f"installed into the live policy")
        s = np.ascontiguousarray(np.asarray(vp.s_sink, np.float64))
        if s.shape != (self.n_feeds,):
            raise ValueError(
                f"candidate s_sink has shape {s.shape}, this runtime "
                f"serves {self.n_feeds} feeds")
        q = float(vp.q)
        got = params_digest(s, q)
        if got != vp.digest:
            raise RuntimeError(
                f"params digest mismatch at install: token says "
                f"{vp.digest}, arrays hash to {got} — the token was "
                f"altered after validation; refusing to install")
        return self._install_validated(s, q, vp.fingerprint, vp.digest)

    def _install_validated(self, s64: np.ndarray, q: float,
                           fingerprint: str, digest: str,
                           journal: bool = True) -> int:
        """The ONE sanctioned assignment site for the live policy
        params outside ``__init__``.  Journals the
        install (digest-asserted epoch record, fsynced — never inside
        the group-commit loss window) and mirrors it into the
        ``params_log.json`` sidecar so recovery replays every batch
        under the epoch that decided it even after segment pruning;
        ``journal=False`` is recovery re-installing an epoch the
        journal already carries.

        Durability-before-swap: the epoch record reaches the
        journal (append + sync) BEFORE the in-memory slots flip, so a
        crash anywhere in the gap either replays the old epoch (record
        never landed, swap never happened) or the new one (record is
        durable) — never serves parameters the journal cannot
        reproduce.  A failed append leaves the previous epoch serving
        untouched."""
        epoch = self._param_epoch + 1
        if journal and self._journal is not None:
            rec = {
                "epoch": epoch,
                "seq": self.applied_seq,
                "s_sink": [float(x) for x in s64],
                "q": float(q),
                "fingerprint": str(fingerprint),
                "digest": str(digest),
                "state_digest": state_digest(self._state),
            }
            try:
                self._journal.append(rec, seq=self.applied_seq)
                # The install record must never sit in the async loss
                # window: a crash right after an install has to replay
                # under the installed epoch, so force it to media (and
                # to the replicas' checkpoint path) before the swap
                # below makes it live.
                self._journal.sync()
            except OSError as e:
                raise RuntimeError(
                    f"journal append failed for epoch "
                    f"{epoch} install: {e} — parameter "
                    f"installs must be durable; restart and recover "
                    f"from {self.dir}") from e
            self._append_params_log(rec)
        # the guarded swap: by here the epoch record is on media, so
        # the span's start strictly follows the durability spans.  New
        # tensors replace the old ones: the rollback slot and any apply
        # still holding the old epoch's tensors keep them intact.
        with _telemetry.span("serving.params.install", epoch=epoch):
            self._param_prev = self.live_params()
            self._param_epoch = epoch
            self._param_fingerprint = str(fingerprint)
            self._s_sink = _param_tensor(s64, self.device)
            self._q = _param_tensor(q, self.device)
            self.q = float(q)
        return self._param_epoch

    def _append_params_log(self, rec: Dict[str, Any]) -> None:
        """Mirror one install into the sidecar log (full history,
        atomic rewrite — installs are rare; the journal's epoch record
        is the hot-path write, this is the prune-survivable index)."""
        path = os.path.join(self.dir, PARAMS_LOG_FILENAME)
        try:
            log = _integrity.read_json(path, schema=PARAMS_LOG_SCHEMA)
        except FileNotFoundError:
            log = {"installs": []}
        except _integrity.CorruptArtifactError:
            # The new params are already live and their epoch record is
            # journaled + fsynced — a corrupt sidecar must not fail the
            # install (it would raise post-install and then fail every
            # future install too).  read_json quarantined the bad file;
            # rebuild the index from the journal's own epoch records.
            # Installs whose segments were pruned are unrecoverable
            # here, degrading recovery to journal-reachable epochs.
            log = {"installs": self._rebuild_params_log_installs(
                before_epoch=int(rec["epoch"]))}
        log["installs"].append(
            {k: rec[k] for k in ("epoch", "seq", "s_sink", "q",
                                 "fingerprint", "digest")})
        _integrity.write_json(path, log, schema=PARAMS_LOG_SCHEMA)

    def _rebuild_params_log_installs(
            self, before_epoch: int) -> List[Dict[str, Any]]:
        """Reconstruct the sidecar's install list from the journal's
        epoch records (every install is appended + fsynced there before
        the sidecar mirror, so all epochs < ``before_epoch`` that still
        have their segments are on media).  Read-only: the live file's
        tail is never quarantined from here.  A journal that cannot be
        replayed yields an empty list — a fresh sidecar beats wedging
        the install path."""
        try:
            records, _ = journal_replay(
                os.path.join(self.dir, _JOURNAL),
                quarantine_torn_tail=False)
        except (OSError, JournalError):
            return []
        return [{k: r[k] for k in ("epoch", "seq", "s_sink", "q",
                                   "fingerprint", "digest")}
                for r in records
                if "epoch" in r and int(r["epoch"]) < before_epoch]

    def submit(self, batch: EventBatch,
               _validated: bool = False) -> Admission:
        """Admit one micro-batch; never raises on bad input — typed
        failures come back as the admission status (the source-facing
        boundary must stay up under garbage).  ``_validated`` is the
        cluster router's trusted path: a sub-batch it fans out is a
        masked slice of a batch that already passed ``validate_batch``
        (coerced dtypes, non-decreasing times, in-range local feeds by
        construction), so re-validating every slice would double the
        O(events) host work on the measured ingest path."""
        with _telemetry.span("serving.admit") as tsp:
            adm = self._submit(batch, _validated)
            tsp.set(status=adm.status)
            return adm

    def _submit(self, batch: EventBatch,
                _validated: bool = False) -> Admission:
        self.metrics.ingested += 1
        backpressure = self.pending >= max(self.queue_capacity * 3 // 4, 1)
        if not _validated:
            try:
                batch = validate_batch(batch, self.n_feeds,
                                       max_events=self.max_batch_events)
            except IngestError as e:
                self.metrics.rejected += 1
                return Admission("rejected", seq=e.seq, reason=str(e),
                                 backpressure=backpressure)
        cls = self._seq.classify(batch.seq)
        if cls != "new":
            # Redundant deliveries drop BEFORE the capacity check — they
            # must never pollute the shed accounting.  "applied" comes
            # back as a duplicate ADMISSION (an ack: the batch is in the
            # journal, the source may stop retransmitting); a retransmit
            # of a merely HELD batch comes back "accepted" — it is
            # buffered but NOT yet durable, and acking it would lose it
            # if the process dies before the gap closes.
            self._seq.offer(batch)  # counts it; touches no queue state
            self.metrics.duplicates = self._seq.duplicates
            return Admission(
                "duplicate" if cls == "applied" else "accepted",
                seq=batch.seq, backpressure=backpressure,
                missing=tuple(self._seq.missing_seqs()))
        if len(self._queue) >= self.queue_capacity:
            # Overload: bounded queue sheds the NEWEST arrival (the
            # in-window backlog stays coherent) and records exactly what
            # was dropped; the source retransmits when admission opens.
            # (A gap-closing batch may drain up to reorder_window held
            # batches past this check in one append — they are in-order
            # and cannot be shed without corrupting the stream — so the
            # hard memory bound is queue_capacity + reorder_window.)
            self.metrics.observe_shed(batch.seq, batch.n_events)
            return Admission("shed", seq=batch.seq, backpressure=True,
                             reason="ingest queue at capacity")
        try:
            _, ready = self._seq.offer(batch)
        except IngestError as e:
            self.metrics.rejected += 1
            self.metrics.window_rejects = self._seq.window_rejects
            return Admission(
                "rejected", seq=batch.seq, backpressure=True,
                reason=str(e),
                missing=tuple(self._seq.missing_seqs()
                              or [self._seq.next_seq]))
        # Latency is wall-clock ARRIVAL->decision: a batch held in the
        # reorder window keeps its original arrival stamp, so the time
        # it spent waiting for the gap to close is measured, not hidden.
        now = self._clock()
        self._arrival[int(batch.seq)] = now
        for b in ready:
            self._queue.append((b, self._arrival.pop(int(b.seq), now)))
        self.metrics.reordered = self._seq.reordered
        self.metrics.duplicates = self._seq.duplicates
        return Admission("accepted", seq=batch.seq,
                         backpressure=backpressure,
                         missing=tuple(self._seq.missing_seqs()))

    # ---- apply path ----

    def _prewarm_pad_widths(self) -> None:
        """Run every bucketed apply shape UP FRONT: pad widths are a
        small bounded set (pow-2 from ``_PAD_WIDTH_FLOOR`` to
        ``max_batch_events``).  PyTorch compiles nothing, but the first
        call of each shape pays CUDA's lazy module loads and the caching
        allocator's first blocks; paying them at construction keeps them
        out of the first measured latencies.  Each warm call runs on a
        THROWAWAY state, never the live carry."""
        # No telemetry span here on purpose: construction runs OUTSIDE
        # any serving trace root, and an orphan span would break the
        # one-trace-per-round invariant the span-chain tests pin.
        widths, E = [], _PAD_WIDTH_FLOOR
        while E < int(self.max_batch_events):
            widths.append(E)
            E *= 2
        widths.append(int(self.max_batch_events))
        for E in sorted(set(min(w, int(self.max_batch_events))
                            for w in widths)):
            dummy = init_feed_state(self.n_feeds, 0, device=self.device)
            t = np.zeros(E, np.float32)
            f = np.zeros(E, np.int32)
            read_decisions(*self._apply(dummy, t, f, np.int32(0),
                                        np.int32(0), self._s_sink,
                                        self._q)[1])
            if self._apply_many is not None:
                K = self.coalesce
                read_decisions(*self._apply_many(
                    dummy, np.zeros((K, E), np.float32),
                    np.zeros((K, E), np.int32), np.zeros((K,), np.int32),
                    np.zeros((K,), np.int32), np.int32(0),
                    self._s_sink, self._q)[1])

    def _pad(self, batch: EventBatch):
        E = _pad_width(batch.n_events, self.max_batch_events)
        _telemetry.counter("lanes.pad.real_elems", int(batch.n_events))
        _telemetry.counter("lanes.pad.padded_elems",
                           E - int(batch.n_events))
        return _pad_events(batch.times, batch.feeds, E)

    def _append_record(self, batch: EventBatch, decision: Decision,
                       new_state: FeedState) -> None:
        self._journal.append({
            "seq": int(batch.seq),
            "times": [float(t) for t in batch.times],
            "feeds": [int(f) for f in batch.feeds],
            "decision": {"post": decision.post,
                         "post_time": decision.post_time,
                         "intensity": decision.intensity},
            "state_digest": state_digest(new_state),
        })

    def _apply_one(self, batch: EventBatch, submitted_at: float) -> Decision:
        # Stage spans under the current trace (the poll round / the
        # worker request): coalesce = host-side packing, dispatch = the
        # operations' enqueue, sync = the device→host wait (on the card
        # the launches are asynchronous, so the device time surfaces
        # HERE, not in dispatch), then journal (its own span inside
        # Journal.append) and ack.
        with _telemetry.span("serving.coalesce"):
            times, feeds, n = self._pad(batch)
        with _telemetry.span("serving.dispatch"):
            new_state, (posted, t_new, lam) = self._apply(
                self._state, times, feeds, n, np.int32(batch.seq),
                self._s_sink, self._q)
        # The ONE deliberate device→host boundary of the apply path: the
        # decision must reach the caller and the journal this batch, so
        # the transfer is per-batch by CONTRACT (serving, not batch sim);
        # it is explicit and stacked into a single read.
        with _telemetry.span("serving.sync"):
            posted, t_new, lam = (
                a[0] for a in read_decisions(posted, t_new, lam))
        decision = Decision(
            seq=batch.seq, post=bool(posted), post_time=float(t_new),
            intensity=float(lam), stale_batches=self.pending)
        if self._journal is not None:
            # Journal BEFORE commit: the record is the acknowledgement.
            # digest is of the POST-apply carry — the replay witness.
            # An append failure (disk full, yanked volume) is FATAL by
            # design: the carry can no longer be made durable (and on a
            # donating backend the pre-apply buffers are already gone),
            # so continuing would silently widen the unjournaled window
            # — fail fast, restart, recover() from the last durable
            # state; the source retransmits everything un-acked.
            try:
                self._append_record(batch, decision, new_state)
            except OSError as e:
                raise RuntimeError(
                    f"journal append failed for batch {batch.seq}: {e} "
                    f"— serving state can no longer be made durable; "
                    f"restart and recover from {self.dir}") from e
            self._post_append_faults(int(batch.seq))
        with _telemetry.span("serving.ack"):
            self._state = new_state
            self._last_decision = decision
            latency = (self._clock() - submitted_at
                       if submitted_at is not None else None)
            self.metrics.observe_apply(batch.n_events, decision.post,
                                       latency)
            self._since_snapshot += 1
        if self.dir is not None and \
                self._since_snapshot >= self.snapshot_every:
            self.snapshot()
        self._post_commit_faults(int(batch.seq))
        return decision

    def _post_append_faults(self, seq: int) -> None:
        """Ingest faults that fire right after seq's journal append
        (shared by the per-batch and coalesced paths — a coalesced group
        is pre-split so the addressed batch always ENDS its record)."""
        f = self._fault
        if f is None or f.batch != seq:
            return
        if f.mode == "torn_journal":
            # Crash DURING this append: the record went out torn and
            # the process died before the commit/snapshot — the batch
            # was never acknowledged, so the journal and snapshots stay
            # mutually consistent at the previous seq and the source
            # will retransmit.  Tear the line we just wrote, then die
            # without cleanup.
            from .journal import tear_tail

            tear_tail(self._journal.path)
            os._exit(19)
        if f.mode == "crash_in_window":
            # The POWER-LOSS shape: the append was acked but its fsync
            # had not landed — drop every byte past the durability
            # watermark (what a machine crash provably keeps), then die.
            # Under flush_mode="sync"/fsync_every_n=1 the watermark IS
            # the last append and this degenerates to a plain crash;
            # under group commit it consumes the documented loss window.
            self._journal.power_loss()
            os._exit(23)

    def _post_commit_faults(self, seq: int) -> None:
        f = self._fault
        if (f is not None and f.mode == "crash_after_apply"
                and f.batch == seq):
            # The kill -9 shape: no atexit, no flush beyond the fsyncs
            # already landed — the acceptance test's mid-stream SIGKILL.
            # (Flushed-but-unfsynced group-commit bytes survive a
            # process kill in the page cache, so this stays lossless
            # under async group commit too.)
            os._exit(17)

    # The ingest fault modes that must END a coalesced group at their
    # addressed batch (so they fire at the exact seq, like the
    # per-batch path).
    _SPLIT_FAULTS = ("torn_journal", "crash_after_apply",
                     "crash_in_window")

    def _apply_group(self, group) -> List[Decision]:
        """Apply one coalesced group — ONE copy of the group to the
        device, ONE device→host transfer, ONE journal record for up to
        ``coalesce`` queued batches.  Bitwise identical to applying them
        one at a time (``state.make_coalesced_apply_fn``), so recovery and
        the chaos acceptance digests are grouping-independent."""
        K = self.coalesce
        k = len(group)
        # Bucketed pad width for the WHOLE group (one dispatch shape per
        # poll round): the widest member's bucket, not the configured
        # max — the unified lane layer's pad-waste lever, bitwise
        # invariant to the width (see _PAD_WIDTH_FLOOR).
        real = sum(int(b.n_events) for b, _ in group)
        E = _pad_width(max(int(b.n_events) for b, _ in group),
                       self.max_batch_events)
        with _telemetry.span("serving.coalesce") as csp:
            # Waste is accounted at the DISPATCH shape (K, E) — the
            # (K - k) empty group rows are padding too, and on lightly
            # loaded rounds they are the dominant term.
            csp.set(k=k, pad_width=E,
                    pad_frac=round(1.0 - real / (K * E), 4))
            _telemetry.counter("lanes.pad.real_elems", real)
            _telemetry.counter("lanes.pad.padded_elems", K * E - real)
            times = np.zeros((K, E), np.float32)
            feeds = np.zeros((K, E), np.int32)
            nvalid = np.zeros((K,), np.int32)
            seqs = np.zeros((K,), np.int32)
            for j, (b, _at) in enumerate(group):
                t, f, n = _pad_events(b.times, b.feeds, E)
                times[j], feeds[j], nvalid[j], seqs[j] = \
                    t, f, n, int(b.seq)
        with _telemetry.span("serving.dispatch"):
            new_state, (posted, t_new, lam) = self._apply_many(
                self._state, times, feeds, nvalid, seqs, np.int32(k),
                self._s_sink, self._q)
        # The ONE deliberate device→host boundary of the coalesced apply
        # path: one transfer per poll ROUND (amortized over the group),
        # not per batch.
        with _telemetry.span("serving.sync"):
            posted, t_new, lam = read_decisions(posted, t_new, lam)
        stale = self.pending
        decisions = [
            Decision(seq=int(b.seq), post=bool(posted[j]),
                     post_time=float(t_new[j]), intensity=float(lam[j]),
                     stale_batches=stale)
            for j, (b, _at) in enumerate(group)]
        if self._journal is not None:
            seqs_l = [int(b.seq) for b, _ in group]
            dec_l = [{"post": d.post, "post_time": d.post_time,
                      "intensity": d.intensity} for d in decisions]
            digest = state_digest(new_state)
            try:
                if self.journal_format == "binary":
                    # Zero-copy group record: the validated batch
                    # arrays land in the binary slot as raw bytes
                    # (journal.pack_group_body) — no per-event JSON
                    # float walk on the leader (ROADMAP residue 1(a)).
                    from .journal import pack_group_body
                    body = pack_group_body(
                        seqs_l,
                        [int(b.n_events) for b, _ in group],
                        np.concatenate(
                            [np.asarray(b.times, np.float64)
                             for b, _ in group]),
                        np.concatenate(
                            [np.asarray(b.feeds, np.int64)
                             for b, _ in group]),
                        dec_l, digest)
                    self._journal.append_raw(body, seq=seqs_l[-1])
                else:
                    rec = {
                        "seqs": seqs_l,
                        "counts": [int(b.n_events) for b, _ in group],
                        "times": [float(t) for b, _ in group
                                  for t in b.times],
                        "feeds": [int(f) for b, _ in group
                                  for f in b.feeds],
                        "decisions": dec_l,
                        "state_digest": digest,
                    }
                    self._journal.append(rec, seq=seqs_l[-1])
            except OSError as e:
                raise RuntimeError(
                    f"journal append failed for batches "
                    f"{seqs_l[0]}..{seqs_l[-1]}: {e} — serving "
                    f"state can no longer be made durable; restart and "
                    f"recover from {self.dir}") from e
            self._post_append_faults(int(group[-1][0].seq))
        with _telemetry.span("serving.ack"):
            self._state = new_state
            self._last_decision = decisions[-1]
            now = self._clock()
            for (b, at), d in zip(group, decisions):
                self.metrics.observe_apply(
                    b.n_events, d.post, None if at is None else now - at)
            self._since_snapshot += k
        if self.dir is not None and \
                self._since_snapshot >= self.snapshot_every:
            self.snapshot()
        self._post_commit_faults(int(group[-1][0].seq))
        return decisions

    def _take_group(self, limit: int):
        """Pop up to ``limit`` queued batches, cutting the group so an
        armed split-fault batch lands LAST in its record."""
        f = self._fault
        split_at = (f.batch if f is not None
                    and f.mode in self._SPLIT_FAULTS else None)
        group = []
        while self._queue and len(group) < limit:
            b, at = self._queue.popleft()
            group.append((b, at))
            if split_at is not None and int(b.seq) == split_at:
                break
        return group

    def poll(self, max_batches: Optional[int] = None) -> List[Decision]:
        """Apply up to ``max_batches`` queued batches (all, by default);
        returns their decisions.  With ``coalesce > 1`` the batches are
        applied in groups of up to ``coalesce`` — one device copy, one
        device→host transfer, and one journal record per group (the
        wire-speed ingest path).  Bounding the per-poll work is the
        overload throttle: a slow consumer polls small, the queue fills,
        and submit() starts shedding — bounded memory, no deadlock."""
        with _telemetry.span("serving.poll") as tsp:
            out: List[Decision] = []
            if self.coalesce == 1:
                while self._queue and (max_batches is None
                                       or len(out) < max_batches):
                    batch, submitted_at = self._queue.popleft()
                    out.append(self._apply_one(batch, submitted_at))
                tsp.set(applied=len(out))
                return out
            while self._queue and (max_batches is None
                                   or len(out) < max_batches):
                limit = self.coalesce
                if max_batches is not None:
                    limit = min(limit, max_batches - len(out))
                group = self._take_group(limit)
                if not group:
                    break
                out.extend(self._apply_group(group))
            tsp.set(applied=len(out))
            return out

    # ---- decision path (never blocks on the backlog) ----

    def decide(self) -> Optional[Decision]:
        """The deadline-bounded read path: the latest applied decision,
        immediately, with the unapplied backlog reported as staleness —
        stale-but-served beats blocked.  None until a first batch
        applies."""
        self.metrics.decisions_served += 1
        if self._last_decision is None:
            return None
        stale = self.pending
        if stale:
            self.metrics.stale_decisions += 1
        return self._last_decision._replace(stale_batches=stale)

    # ---- durability ----

    def snapshot(self) -> Optional[int]:
        """Land the carry as a checkpoint step (step number = applied seq),
        then rotate the live journal into a segment and prune segments
        covered by every retained snapshot — the journal's total size
        stays bounded by the retained-snapshot window instead of growing
        for the process lifetime (recovery reads segments + live).
        No-op without a serving directory.  Returns the step written."""
        if self.dir is None:
            return None
        seq = self.applied_seq
        if seq < 0:
            return None
        with _telemetry.span("serving.snapshot") as tsp:
            tsp.set(seq=seq)
            from ..utils import checkpoint as _checkpoint
            from . import journal as _journal_mod
            snap_dir = os.path.join(self.dir, _SNAPSHOTS)
            _checkpoint.save(snap_dir, seq, self._state)
            self._since_snapshot = 0
            if self._journal is not None:
                steps = [int(n) for n in os.listdir(snap_dir)
                         if n.isdigit()]
                oldest = min(steps) if steps else None
                if hasattr(self._journal, "rotate_local"):
                    # Replicated: rotate leader + replicas in stream
                    # order, keeping the follower group attached.
                    self._journal.rotate_local(seq, oldest)
                else:
                    path = self._journal.path
                    self._journal.close()
                    _journal_mod.rotate(path, seq)
                    if oldest is not None:
                        _journal_mod.prune_segments(path, oldest)
                    self._journal = Journal(
                        path, fsync_every_n=self.fsync_every_n,
                        flush_mode=self.flush_mode,
                        max_unflushed_records=self.max_unflushed_records,
                        max_flush_delay_ms=self.max_flush_delay_ms,
                        fmt=self.journal_format)
        return seq

    def durability(self) -> Dict[str, Any]:
        """The configured durability window — what an ack MEANS under
        this runtime's flush mode (committed beside every throughput
        number so bench results are never quoted without their
        durability cost; ``journal.durability_info`` is the one
        definition)."""
        from .journal import durability_info

        repl = None
        if self.replication_factor >= 1:
            repl = {"factor": self.replication_factor,
                    "quorum": (self.replication_quorum
                               if self.replication_quorum is not None
                               else self.replication_factor // 2 + 1)}
        return durability_info(self.flush_mode, self.fsync_every_n,
                               self.max_unflushed_records,
                               self.max_flush_delay_ms, self.coalesce,
                               replication=repl)

    def write_metrics(self, path: Optional[str] = None) -> Dict[str, Any]:
        """The ``rq.serving.metrics/1`` artifact (defaults into the
        serving directory)."""
        if path is None:
            if self.dir is None:
                raise ValueError("no serving directory and no path given")
            path = os.path.join(self.dir, "metrics.json")
        return self.metrics.write(
            path, pending=self.pending,
            extra={"n_feeds": self.n_feeds, "q": self.q,
                   "applied_seq": self.applied_seq,
                   "param_epoch": self._param_epoch,
                   "param_fingerprint": self._param_fingerprint,
                   "durability": self.durability(),
                   # The journal-health block (flush_errors, fsync
                   # attempts, checkpoint-lag watermark, replication
                   # follower states): a silently failing fsync thread
                   # or a lagging checkpoint is visible in every
                   # metrics artifact BEFORE a crash makes it matter.
                   "journal": (None if self._journal is None
                               else self._journal.health()),
                   "health_sick_edges": int(torch.count_nonzero(
                       self._state.health))})

    def state_digest(self) -> str:
        return state_digest(self._state)

    def gather(self) -> Tuple[np.ndarray, np.ndarray, int, float, int]:
        """The per-edge carry as host arrays — ``(rank f32[F], health
        u32[F], seq, t, n_batches)`` through ONE explicit device→host
        boundary.  The cluster's edge-digest / reshard paths drive this
        uniformly for in-process runtimes and out-of-process workers
        (``serving.worker.WorkerHandle.gather`` answers bit-identically
        over the frame protocol)."""
        a = state_to_numpy(self._state)
        return (a["rank"], a["health"], int(a["seq"]), float(a["t"]),
                int(a["n_batches"]))

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Recovery: snapshot + journal replay -> bit-identical carry
# ---------------------------------------------------------------------------

def _record_batches(rec: Dict[str, Any]
                    ) -> List[Tuple[int, list, list, Dict[str, Any]]]:
    """One journal record → its ``(seq, times, feeds, decision)`` batch
    tuples, for BOTH record shapes: a /1 record is one batch, a /2 group
    record (flat concatenated events + per-batch ``counts``) is several.
    The single flat-record parser every journal reader shares."""
    if "epoch" in rec or "topo_epoch" in rec:
        # A parameter-install record (serving.paramswap) or a migrated
        # range install (serving.topology): positional metadata for
        # replay, not a batch — contributes no decisions.
        return []
    if "seqs" not in rec:
        return [(int(rec["seq"]), rec["times"], rec["feeds"],
                 rec["decision"])]
    out = []
    at = 0
    for seq, n, d in zip(rec["seqs"], rec["counts"], rec["decisions"]):
        n = int(n)
        out.append((int(seq), rec["times"][at:at + n],
                    rec["feeds"][at:at + n], d))
        at += n
    if at != len(rec["times"]):
        raise ValueError(
            f"group record {rec['seqs'][0]}..{rec['seqs'][-1]} counts "
            f"sum to {at} but carries {len(rec['times'])} events — "
            f"corrupt group structure")
    return out


def recover(dir: str, clock=time.monotonic,
            acked_seq: Optional[int] = None,
            heal_replicas: Optional[List[str]] = None,
            device: DeviceLike = "cuda"
            ) -> Tuple[ServingRuntime, RecoveryInfo]:
    """Rebuild a runtime from its serving directory after a crash.

    Protocol: read the enveloped config; restore the newest snapshot
    that PROVES restorable (``utils.checkpoint.latest_valid_step`` —
    torn steps are quarantined, never trusted); verify-and-replay the
    journal (torn tail quarantined by ``serving.journal.replay``),
    re-applying every record past the snapshot through the same pure
    apply step — per-batch records through :func:`make_apply_fn`, group
    records through the coalesced fn (grouping-invariant bitwise, so
    both paths reconstruct the same carry).  Each replayed record's
    recomputed carry digest must equal the journaled one — the
    bit-identity witness; divergence raises ``RuntimeError`` rather than
    serving reconstructed-but-wrong state.

    ``acked_seq`` is the caller's ack high-water mark (what the source /
    router saw acknowledged before the crash): when the journal kept
    less — the async-group-commit loss window a power-style crash
    consumed — the exact lost seqs come back in
    ``RecoveryInfo.lost_acked_seqs`` so the caller can retransmit them
    deliberately instead of discovering the gap by timeout.

    ``heal_replicas`` (quorum-replicated directories): the surviving
    follower replica dirs — acked records the leader's disk lost are
    re-seeded from them (``replication.heal_from_replicas``) BEFORE the
    replay, so ``lost_acked_seqs`` shrinks to exactly the records EVERY
    holder lost.  None (the default) auto-discovers the default local
    replica root (``<dir>/replicas/replica*``) when the stored config
    says the directory ran replicated; pass ``[]`` to skip healing.

    The carry is rebuilt and replayed on ``device`` (the card unless
    ``device="cpu"``), and the returned runtime serves there.  A
    directory written by the JAX package replays here from its journal
    (same config, journal and params-log schemas); its orbax snapshots
    are not read (``utils.checkpoint`` raises
    ``ForeignCheckpointError`` and leaves them in place), so such a
    directory recovers here only with snapshots off (its whole
    journal)."""
    cfg = _integrity.read_json(os.path.join(dir, _CONFIG),
                               schema=CONFIG_SCHEMA)
    from ..utils import checkpoint as _checkpoint

    dev = resolve_device(device)
    like = init_feed_state(int(cfg["n_feeds"]), int(cfg["seed"]),
                           start_seq=int(cfg["start_seq"]), device=dev)
    snap_dir = os.path.join(dir, _SNAPSHOTS)
    step = _checkpoint.latest_valid_step(snap_dir, like=like)
    state = (like if step is None
             else _checkpoint.restore(snap_dir, step=step, like=like))
    journal_path = os.path.join(dir, _JOURNAL)
    healed: Tuple[int, ...] = ()
    if heal_replicas is None \
            and int(cfg.get("replication_factor") or 0) >= 1:
        from .replication import REPLICA_DIR_PREFIX
        root = os.path.join(dir, "replicas")
        if os.path.isdir(root):
            heal_replicas = sorted(
                os.path.join(root, n) for n in os.listdir(root)
                if n.startswith(REPLICA_DIR_PREFIX))
    if heal_replicas:
        from .replication import heal_from_replicas
        h = heal_from_replicas(journal_path, list(heal_replicas),
                               fmt=cfg.get("journal_format"))
        healed = tuple(h["healed_seqs"])
    records, torn = journal_replay(journal_path)
    apply_fn = make_apply_fn()
    co_fn = None
    s_sink = _param_tensor(cfg["s_sink"], dev)
    qv = _param_tensor(float(cfg["q"]), dev)
    E = int(cfg["max_batch_events"])
    K_cfg = int(cfg.get("coalesce", 1))
    replayed = skipped = 0
    last_decision: Optional[Decision] = None
    start_seq_state = int(state.seq)
    # Parameter-epoch base for the replay (serving.paramswap): installs
    # made BEFORE the restored snapshot may live in pruned segments, so
    # the params that were live at the snapshot come from the sidecar
    # install log — the newest entry with seq <= the restored seq
    # (pruning only drops segments covered by the OLDEST retained
    # snapshot, so any install past that point still has its journal
    # record and is replayed in stream order below).
    live_install: Optional[Dict[str, Any]] = None
    try:
        plog = _integrity.read_json(
            os.path.join(dir, PARAMS_LOG_FILENAME),
            schema=PARAMS_LOG_SCHEMA)
    except FileNotFoundError:
        plog = None
    if plog:
        base = [e for e in plog["installs"]
                if int(e["seq"]) <= start_seq_state]
        if base:
            live_install = dict(base[-1])
    if live_install is not None:
        s64 = np.asarray(live_install["s_sink"], np.float64)
        if params_digest(s64, float(live_install["q"])) \
                != live_install["digest"]:
            raise RuntimeError(
                f"params_log epoch {live_install['epoch']} digest "
                f"mismatch — the sidecar install log is corrupt; "
                f"refusing to replay under unverified parameters")
        s_sink = _param_tensor(s64, dev)
        qv = _param_tensor(float(live_install["q"]), dev)
    for rec in records:
        if "topo_epoch" in rec:
            # A migrated-range install (serving.topology): re-apply
            # the journaled scatter-set at its stream position — the
            # values come from the record itself (f32/u32 round-trip
            # exactly through JSON), so replaying it is bit-identical
            # to the live install, and re-applying an already-
            # snapshotted install would be too (pure set); we skip
            # those only because later batch records may since have
            # re-ranked the installed edges.
            if int(rec["seq"]) > start_seq_state:
                raise RuntimeError(
                    f"journal topology record (epoch "
                    f"{rec['topo_epoch']}) claims install at seq "
                    f"{rec['seq']} but replay is at {start_seq_state} "
                    f"— out-of-order install record")
            if int(rec["seq"]) == start_seq_state:
                state = _set_range(state, rec["idx"], rec["rank"],
                                   rec["health"])
                got = state_digest(state)
                if got != rec["state_digest"]:
                    raise RuntimeError(
                        f"journal replay diverged at topology epoch "
                        f"{rec['topo_epoch']} range install (seq "
                        f"{rec['seq']}): recomputed carry digest "
                        f"{got[:12]}.. != journaled "
                        f"{str(rec['state_digest'])[:12]}..")
            continue
        if "epoch" in rec:
            # A journaled install: switch the replay params from this
            # stream position on — every batch replays under the epoch
            # that decided it.  Digest-asserted twice: the params
            # against the record's own digest, and (when the install
            # falls inside the replayed range) the carry against the
            # journaled state digest at the install point.
            s64 = np.asarray(rec["s_sink"], np.float64)
            if params_digest(s64, float(rec["q"])) != rec["digest"]:
                raise RuntimeError(
                    f"journaled epoch {rec['epoch']} params digest "
                    f"mismatch — refusing to replay under unverified "
                    f"parameters")
            if int(rec["seq"]) > start_seq_state:
                raise RuntimeError(
                    f"journal epoch record {rec['epoch']} claims "
                    f"install at seq {rec['seq']} but replay is at "
                    f"{start_seq_state} — out-of-order install record")
            if int(rec["seq"]) == start_seq_state:
                got = state_digest(state)
                if got != rec["state_digest"]:
                    raise RuntimeError(
                        f"journal replay diverged at epoch "
                        f"{rec['epoch']} install (seq {rec['seq']}): "
                        f"recomputed carry digest {got[:12]}.. != "
                        f"journaled "
                        f"{str(rec['state_digest'])[:12]}..")
            s_sink = _param_tensor(s64, dev)
            qv = _param_tensor(float(rec["q"]), dev)
            live_install = dict(rec)
            continue
        batches = _record_batches(rec)
        last_seq = batches[-1][0]
        if last_seq <= start_seq_state:
            skipped += len(batches)
            seq, _, _, d = batches[-1]
            last_decision = Decision(seq=seq, post=bool(d["post"]),
                                     post_time=float(d["post_time"]),
                                     intensity=float(d["intensity"]))
            continue
        if batches[0][0] <= start_seq_state:
            # Snapshots land only at record boundaries, so a record
            # straddling the restored seq cannot come from this
            # directory's own history.
            raise RuntimeError(
                f"journal record {batches[0][0]}..{last_seq} straddles "
                f"the restored snapshot seq {start_seq_state} — mixed "
                f"directories or a foreign journal; refusing to replay")
        if len(batches) == 1 and "seqs" not in rec:
            seq, r_times, r_feeds, _ = batches[0]
            times, feeds, n = _pad_events(r_times, r_feeds, E)
            state, (posted, t_new, lam) = apply_fn(
                state, times, feeds, n, np.int32(seq), s_sink, qv)
            posted_l, t_l, lam_l = read_decisions(posted, t_new, lam)
        else:
            # Group record: replay through the coalesced fn — the bulk
            # path recovery shares with live serving (one device copy and
            # one read per journal record, so replaying a wire-speed
            # journal is as amortized as writing it was).
            if co_fn is None:
                co_fn = make_coalesced_apply_fn()
            k = len(batches)
            K = max(K_cfg, k)  # an over-wide group still replays
            g_times = np.zeros((K, E), np.float32)
            g_feeds = np.zeros((K, E), np.int32)
            g_nvalid = np.zeros((K,), np.int32)
            g_seqs = np.zeros((K,), np.int32)
            for j, (seq, r_times, r_feeds, _) in enumerate(batches):
                t, f, n = _pad_events(r_times, r_feeds, E)
                g_times[j], g_feeds[j] = t, f
                g_nvalid[j], g_seqs[j] = n, seq
            state, (posted, t_new, lam) = co_fn(
                state, g_times, g_feeds, g_nvalid, g_seqs, np.int32(k),
                s_sink, qv)
            posted_l, t_l, lam_l = (
                a[:k] for a in read_decisions(posted, t_new, lam))
        got = state_digest(state)
        if got != rec["state_digest"]:
            raise RuntimeError(
                f"journal replay diverged at seq {last_seq}: recomputed "
                f"carry digest {got[:12]}.. != journaled "
                f"{str(rec['state_digest'])[:12]}.. — the journal and the "
                f"snapshot disagree (mixed directories? code drift across "
                f"the restart?); refusing to serve reconstructed state")
        last_decision = Decision(
            seq=last_seq, post=bool(posted_l[-1]),
            post_time=float(t_l[-1]), intensity=float(lam_l[-1]))
        replayed += len(batches)
        start_seq_state = last_seq
    rt = ServingRuntime(
        n_feeds=int(cfg["n_feeds"]), q=float(cfg["q"]),
        s_sink=np.asarray(cfg["s_sink"], np.float64),
        seed=int(cfg["seed"]), dir=dir,
        start_seq=int(cfg["start_seq"]),
        snapshot_every=int(cfg["snapshot_every"]),
        reorder_window=int(cfg["reorder_window"]),
        queue_capacity=int(cfg["queue_capacity"]),
        max_batch_events=E,
        fsync_every_n=int(cfg.get("fsync_every_n", 1)),
        flush_mode=str(cfg.get("flush_mode", "sync")),
        max_unflushed_records=int(cfg.get("max_unflushed_records", 64)),
        max_flush_delay_ms=float(cfg.get("max_flush_delay_ms", 50.0)),
        coalesce=K_cfg,
        journal_format=cfg.get("journal_format"),
        replication_factor=int(cfg.get("replication_factor") or 0),
        replication_quorum=cfg.get("replication_quorum"),
        replication_mode=str(cfg.get("replication_mode", "thread")),
        clock=clock, _state=state, device=dev)
    rt._last_decision = last_decision
    if live_install is not None and int(live_install["epoch"]) > 0:
        # Re-install the last-good live parameters without re-journaling
        # (the install record is already durable); then pin the epoch
        # counter to the journaled value so post-recovery installs
        # continue the sequence instead of restarting it.
        rt._install_validated(
            np.asarray(live_install["s_sink"], np.float64),
            float(live_install["q"]),
            str(live_install["fingerprint"]),
            str(live_install["digest"]), journal=False)
        rt._param_epoch = int(live_install["epoch"])
    recovered_seq = int(state.seq)
    lost: Tuple[int, ...] = ()
    if acked_seq is not None and int(acked_seq) > recovered_seq:
        # Seqs are consecutive by the stream contract, so the lost
        # window is exactly the integer gap.
        lost = tuple(range(recovered_seq + 1, int(acked_seq) + 1))
    info = RecoveryInfo(
        snapshot_seq=step, replayed=replayed, skipped=skipped, torn=torn,
        recovered_seq=recovered_seq, lost_acked_seqs=lost,
        healed_seqs=healed)
    return rt, info


def journal_decisions(dir: str) -> List[Decision]:
    """The full decision history a serving directory's journal records —
    what the crash-recovery acceptance test compares against the
    uninterrupted run (read-only: the torn tail, if any, is skipped, not
    quarantined).  Group records contribute one decision per batch."""
    records, _ = journal_replay(os.path.join(dir, _JOURNAL),
                                quarantine_torn_tail=False)
    out = []
    for rec in records:
        for seq, _times, _feeds, d in _record_batches(rec):
            out.append(Decision(seq=seq, post=bool(d["post"]),
                                post_time=float(d["post_time"]),
                                intensity=float(d["intensity"])))
    return out
