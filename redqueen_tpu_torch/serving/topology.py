"""Elastic topology: crash-safe live resharding + follow-graph churn (the
counterpart of the JAX package's ``serving.topology``; numpy and the
stdlib only, so a topology log reads the same in both packages).

The offline :func:`serving.cluster.reshard` migrates a cluster only when it
is fully DRAINED and offline — the paper's broadcasters live in a social
graph that churns while u*(t) keeps firing, so the serving tier must
resize and rewire **under traffic**.  This module is that substrate:
a journaled topology log + a resumable per-range
migration driver, built on the same journal/epoch pattern
``serving.paramswap`` proved for live parameters.

**The topology log** (``<cluster dir>/topology.log``) is an append-only,
per-record-checksummed, fsynced JSONL file: every topology mutation —
new shard slots, range fences, ownership flips, edge adds/drops, shard
retirements — lands as a monotonically-epoch-numbered record BEFORE it
takes effect, and ``ServingCluster.recover`` replays the log exactly
like the parameter-epoch records: a crashed router reconstructs the
live ownership map bit-identically, and a torn tail (the
``reshard:torn_plan`` fault) is quarantined by truncation, never
trusted.

**Two-phase per-range handoff** (:class:`Migration.step`, one feed
range at a time while the other shards keep serving):

1. **fence** — the cluster drains to a uniform applied watermark ``W``;
   the source shard's carry slice for the range is extracted and its
   canonical :func:`range_digest` journaled in a ``fence`` record.
   From fence to flip the router refuses (status ``"fenced"``, counted
   ``fenced_retried``, retransmitted by the source later) any batch
   with ``seq > W`` touching a feed the fenced SOURCE shard still owns
   — the whole source shard is paused, because one posting decision
   resets every healthy rank on the shard and would silently mutate
   the fenced slice under the migration.  Batches for every other
   shard keep flowing (the source receives their empty sub-batches,
   which advance its seq but cannot change rank/health — the digest
   is position-independent by construction).
2. **install + flip** — the destination journals a digest-asserted
   ``topo_epoch`` record in its OWN shard journal
   (:meth:`ServingRuntime.install_range` — an idempotent scatter-set,
   replayed in stream order on recovery exactly like a param epoch)
   and snapshots; then the router journals the ``flip`` record and
   atomically rewires ownership.  No apply can land on a stale owner:
   admission routes by the flipped ownership map, and every fenced
   seq admitted pre-flip was already applied cluster-wide (the
   watermark barrier), so a post-flip retransmit is a pure duplicate
   at every shard regardless of geometry.

SIGKILL of source, destination, or router mid-migration resumes from
the last fenced range: the fence record carries the range digest, the
resumed step re-extracts from the recovered (frozen) source and asserts
bit-identity, the re-install is idempotent, and the flip lands once.

**Churn.**  ``add_edges`` assigns new feeds to the least-loaded shard
(:func:`churn_assign`, deterministic ties) and materializes the growth
as a mini-migration into a fresh pre-sized slot — growing a live
runtime's arrays in place would invalidate every journaled state
digest, so *growth is resharding*: the old slot's feeds move (digest-
asserted) into the new slot, the old slot retires.  ``drop_edges``
journals the drop and poisons the carry slice on the owning shard
(rank 0, health bit set — the edge stops contributing intensity), with
the feed excluded from routing and from :meth:`edge_digest`.

See docs/DESIGN.md "Elastic topology & live resharding".
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime import telemetry as _telemetry

__all__ = ["TopologyLog", "TopologyState", "Migration", "TopologyError",
           "MigrationInterrupted", "MigrationStalled", "read_topology_log",
           "tear_topology_tail", "range_digest", "plan_moves",
           "churn_assign", "TOPOLOGY_LOG", "TOPOLOGY_KINDS"]

#: The topology log filename inside the cluster directory.
TOPOLOGY_LOG = "topology.log"

#: Every record kind the log may carry (the recovery replay refuses an
#: unknown kind loudly — a newer writer's record must never be half-
#: understood by an older reader).
TOPOLOGY_KINDS = ("plan", "add_slot", "add_edges", "fence", "flip",
                  "retire", "complete", "drop_edges")


class TopologyError(ValueError):
    """A topology operation refused (undrained cluster, pending plan,
    unknown feed, ...) — the cluster state is untouched."""


class MigrationInterrupted(RuntimeError):
    """A migration step died mid-handoff (injected kill or torn plan):
    the fence record is durable; ``resume_migration()``/``step()``
    continues from the last fenced range after recovery."""


class MigrationStalled(RuntimeError):
    """The injected ``reshard:wedge`` stall — one counted no-progress
    step; retrying the step proceeds normally."""


def _canon(rec: Dict[str, Any]) -> bytes:
    return json.dumps(rec, sort_keys=True,
                      separators=(",", ":")).encode()


class TopologyLog:
    """Append-only fsynced topology record log.  One JSON line per
    record: ``{"rec": <record>, "sha": sha256(canonical record)}`` —
    the per-line checksum is what lets recovery tell a torn tail from
    a corrupt middle (truncate the first, refuse the second is not
    needed: any bad line truncates, because records after it were
    never acknowledged as durable to the driver)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def append(self, rec: Dict[str, Any]) -> None:
        if rec.get("kind") not in TOPOLOGY_KINDS:
            raise ValueError(f"unknown topology record kind "
                             f"{rec.get('kind')!r}")
        line = json.dumps(
            {"rec": rec,
             "sha": hashlib.sha256(_canon(rec)).hexdigest()},
            sort_keys=True, separators=(",", ":"))
        self._f.write(line.encode() + b"\n")
        self._f.flush()
        # A topology record takes effect only after it is durable —
        # same contract as the parameter-epoch records: the flip the
        # router acts on must be the flip recovery will replay.
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_topology_log(path: str, quarantine_torn_tail: bool = True
                      ) -> Tuple[List[Dict[str, Any]], bool]:
    """Read + verify every record; a torn/corrupt tail is TRUNCATED
    (when ``quarantine_torn_tail``) so the next append continues from
    the last provable record.  Returns ``(records, torn)``."""
    with _telemetry.span("serving.topo.log.verify"):
        return _read_topology_log(path, quarantine_torn_tail)


def _read_topology_log(path: str, quarantine_torn_tail: bool
                       ) -> Tuple[List[Dict[str, Any]], bool]:
    if not os.path.exists(path):
        return [], False
    records: List[Dict[str, Any]] = []
    good_end = 0
    torn = False
    with open(path, "rb") as f:
        data = f.read()
    at = 0
    while at < len(data):
        nl = data.find(b"\n", at)
        if nl < 0:
            torn = True  # unterminated tail line
            break
        line = data[at:nl]
        try:
            obj = json.loads(line)
            rec = obj["rec"]
            if obj["sha"] != hashlib.sha256(_canon(rec)).hexdigest():
                raise ValueError("checksum mismatch")
            if rec.get("kind") not in TOPOLOGY_KINDS:
                raise ValueError(f"unknown kind {rec.get('kind')!r}")
        except (ValueError, KeyError, TypeError):
            torn = True
            break
        records.append(rec)
        good_end = nl + 1
        at = nl + 1
    if torn and quarantine_torn_tail:
        with open(path, "r+b") as f:
            f.truncate(good_end)
    return records, torn


def tear_topology_tail(path: str, nbytes: int = 9) -> None:
    """Chaos helper (the ``reshard:torn_plan`` fault body): cut the
    last ``nbytes`` bytes so the final record is mid-line torn — what a
    power loss during the fence append leaves behind."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, size - nbytes))


def range_digest(feeds: Sequence[int], rank: np.ndarray,
                 health: np.ndarray) -> str:
    """Canonical digest of one moved range's carry slice — global feed
    ids + per-edge ``(rank f32, health u32)``.  Deliberately EXCLUDES
    the stream position: the fenced source keeps applying empty
    sub-batches (seq advances) while its rank/health are frozen, so
    the digest taken at fence time must equal the one re-extracted
    after a crash + recovery + catch-up."""
    feeds = np.ascontiguousarray(np.asarray(feeds, np.int64))
    rank = np.ascontiguousarray(np.asarray(rank, np.float32))
    health = np.ascontiguousarray(np.asarray(health, np.uint32))
    if not (len(feeds) == len(rank) == len(health)):
        raise ValueError(
            f"range arrays disagree: {len(feeds)} feeds, "
            f"{len(rank)} ranks, {len(health)} health words")
    h = hashlib.sha256()
    h.update(np.int64(len(feeds)).tobytes())
    h.update(feeds.tobytes())
    h.update(rank.tobytes())
    h.update(health.tobytes())
    return h.hexdigest()


def churn_assign(counts: Dict[int, int], n_add: int) -> List[int]:
    """Deal ``n_add`` new edges greedily onto the least-loaded live
    shards (ties break to the lowest shard id) — deterministic, and it
    never widens the load spread beyond ``max(initial spread, 1)``:
    each pick raises a current minimum by one."""
    if n_add < 0:
        raise ValueError(f"n_add must be >= 0, got {n_add}")
    if not counts and n_add:
        raise ValueError("no live shards to assign new edges to")
    live = dict(counts)
    out: List[int] = []
    for _ in range(int(n_add)):
        k = min(live, key=lambda i: (live[i], i))
        out.append(k)
        live[k] += 1
    return out


def _balanced_sizes(total: int, n: int) -> List[int]:
    base, rem = divmod(int(total), int(n))
    return [base + 1 if i < rem else base for i in range(n)]


def plan_moves(owned: Dict[int, np.ndarray], new_slot_ids: List[int],
               range_size: Optional[int] = None
               ) -> Tuple[Dict[int, List[int]], List[Dict[str, Any]]]:
    """Build a grow-migration plan: existing shards only SHED feeds
    (an existing runtime never receives — growing its arrays in place
    would invalidate its journaled state digests), new slots are
    created pre-sized with their full target feed set.

    Target sizes are the ±1-balanced deal of the live feed count over
    the post-migration shard count, largest targets matched to the
    currently-largest shards; each existing shard keeps its first
    ``target`` feeds in ascending feed order and sheds the tail, and
    the shed feeds fill the new slots in slot order, chunked into
    ranges of at most ``range_size`` feeds (one range per (src, dst)
    chunk by default).  Returns ``(new slot feed sets, ranges)`` where
    each range is ``{"id", "src", "dst", "feeds"}``."""
    slot_ids = sorted(owned)
    total = sum(len(owned[k]) for k in slot_ids)
    m = len(slot_ids) + len(new_slot_ids)
    if not new_slot_ids:
        raise ValueError("a grow plan needs at least one new slot")
    if total < m:
        raise TopologyError(
            f"{total} live edges cannot fill {m} shards with at least "
            f"one edge each")
    sizes = _balanced_sizes(total, m)  # descending by construction
    by_load = sorted(slot_ids, key=lambda k: (-len(owned[k]), k))
    keep: Dict[int, int] = {}
    for pos, k in enumerate(by_load):
        keep[k] = min(len(owned[k]), sizes[pos])
    surplus_total = total - sum(keep.values())
    new_sizes = _balanced_sizes(surplus_total, len(new_slot_ids))
    if min(new_sizes) < 1:
        raise TopologyError(
            f"surplus of {surplus_total} edges cannot give each of "
            f"{len(new_slot_ids)} new shards at least one edge — the "
            f"cluster is already as wide as its edge count allows")
    shed: List[Tuple[int, List[int]]] = []
    for k in slot_ids:
        feeds = sorted(int(f) for f in owned[k])
        tail = feeds[keep[k]:]
        if tail:
            shed.append((k, tail))
    new_feeds: Dict[int, List[int]] = {k: [] for k in new_slot_ids}
    ranges: List[Dict[str, Any]] = []
    di = 0
    need = new_sizes[0]
    rid = 0
    for src, tail in shed:
        at = 0
        while at < len(tail):
            while need == 0:
                di += 1
                need = new_sizes[di]
            take = need if range_size is None else min(need, range_size)
            chunk = tail[at:at + take]
            dst = new_slot_ids[di]
            new_feeds[dst].extend(chunk)
            ranges.append({"id": rid, "src": int(src), "dst": int(dst),
                           "feeds": [int(f) for f in chunk]})
            rid += 1
            need -= len(chunk)
            at += len(chunk)
    for k in new_feeds:
        new_feeds[k] = sorted(new_feeds[k])
    return new_feeds, ranges


class TopologyState:
    """The router's in-memory topology bookkeeping — epoch counter,
    pending plan, active fences — reconstructed bit-identically from
    the log on recovery (the cluster's owner/local-index arrays are the
    routing half; this is the protocol half)."""

    def __init__(self):
        self.epoch = 0
        self.plan: Optional[Dict[str, Any]] = None
        self.fences: Dict[int, Dict[str, Any]] = {}  # range id -> rec
        self.flipped: set = set()          # flipped range ids (plan)
        self.plans_completed = 0

    def next_epoch(self) -> int:
        return self.epoch + 1

    def note_epoch(self, epoch: int) -> None:
        self.epoch = max(self.epoch, int(epoch))

    def assert_fenced(self, plan_id: str, range_id: int) -> None:
        """The ownership guard: an edge-state install is only
        sanctioned for a range the CURRENT plan holds fenced — a stale
        driver (pre-crash object, wrong plan) fails here instead of
        scattering into a live shard."""
        with _telemetry.span("serving.topo.assert", kind="fenced",
                             plan=str(plan_id), range=int(range_id)):
            rec = self.fences.get(int(range_id))
            if rec is None or self.plan is None \
                    or rec.get("plan") != plan_id \
                    or self.plan.get("plan") != plan_id:
                raise TopologyError(
                    f"range {range_id} of plan {plan_id!r} is not "
                    f"fenced under the current topology epoch "
                    f"{self.epoch} — refusing an unfenced edge-state "
                    f"install")

    def assert_owner(self, owners: np.ndarray, k: int,
                     feeds: Sequence[int]) -> None:
        """The ownership guard for churn mutations: every feed
        being mutated must be owned by shard ``k`` under the current
        epoch, and no fence may be pending (a fenced source's slice is
        frozen)."""
        with _telemetry.span("serving.topo.assert", kind="owner",
                             shard=int(k)):
            owners = np.asarray(owners)
            if self.fences:
                raise TopologyError(
                    f"ranges {sorted(self.fences)} are fenced — finish "
                    f"the pending migration before mutating edge state")
            if (owners != int(k)).any():
                bad = [int(f) for f, o in zip(feeds, owners)
                       if int(o) != int(k)]
                raise TopologyError(
                    f"feeds {bad} are not owned by shard {k} under "
                    f"epoch {self.epoch} — refusing a stale-owner "
                    f"mutation")


class Migration:
    """The resumable per-range migration driver over one journaled
    plan.  ``step()`` moves exactly one range (fence → extract →
    install → flip) on a drained cluster; the caller interleaves
    traffic between steps.  Injected ``reshard:*`` faults land at
    exact range ids; after an interruption, recover the killed shard
    (or ``ServingCluster.recover`` the directory) and keep stepping —
    the fence record pins the range digest across the outage."""

    def __init__(self, cluster, plan: Dict[str, Any], fault=None):
        self.cluster = cluster
        self.plan = plan
        self._fault = fault
        self._fault_spent = False
        if fault is not None \
                and int(fault.range) >= len(plan["ranges"]):
            raise ValueError(
                f"RQ_FAULT targets reshard range {fault.range} but "
                f"this plan has {len(plan['ranges'])} range(s) (valid: "
                f"0..{len(plan['ranges']) - 1}) — the fault could "
                f"never fire")

    @property
    def plan_id(self) -> str:
        return str(self.plan["plan"])

    @property
    def ranges(self) -> List[Dict[str, Any]]:
        return list(self.plan["ranges"])

    def remaining(self) -> List[Dict[str, Any]]:
        t = self.cluster._topo
        return [r for r in self.plan["ranges"]
                if int(r["id"]) not in t.flipped]

    @property
    def done(self) -> bool:
        return self.cluster._topo.plan is None or not self.remaining()

    def run(self, max_steps: Optional[int] = None) -> int:
        """Step to completion (no interleaved traffic — the drained
        convenience path); returns the number of ranges moved."""
        moved = 0
        while not self.done:
            self.step()
            moved += 1
            if max_steps is not None and moved >= max_steps:
                break
        return moved

    def _drain(self, drain_rounds: int) -> int:
        cl = self.cluster
        for _ in range(int(drain_rounds)):
            if cl.pending == 0:
                break
            cl.poll()
        if cl.pending:
            raise TopologyError(
                f"cluster will not drain ({cl.pending} sub-batches "
                f"pending after {drain_rounds} poll rounds) — "
                f"retransmit the gap seqs, then step again")
        return cl._uniform_applied_seq(
            "a range handoff needs every shard at one watermark")

    def step(self, drain_rounds: int = 64) -> Optional[int]:
        """Move the next unflipped range; returns its id (None when the
        plan is already complete)."""
        cl = self.cluster
        t = cl._topo
        todo = self.remaining()
        if not todo:
            return None
        r = todo[0]
        rid = int(r["id"])
        watermark = self._drain(drain_rounds)
        src = cl._slots[int(r["src"])]
        dst = cl._slots[int(r["dst"])]
        for slot, role in ((src, "source"), (dst, "destination")):
            if slot.runtime is None:
                raise TopologyError(
                    f"range {rid} {role} shard {slot.k} is quarantined "
                    f"— recover_shard({slot.k}) before stepping")
        fault = None if self._fault_spent else self._fault
        fire = fault is not None and int(fault.range) == rid
        if fire and fault.mode == "wedge":
            self._fault_spent = True
            cl.metrics.observe_migration_stall()
            raise MigrationStalled(
                f"migration stalled at range {rid} (injected wedge) — "
                f"step again to proceed")
        feeds = np.asarray(r["feeds"], np.int64)
        local_src = cl._local_index[feeds]
        rank, health = src.runtime.extract_range(
            [int(i) for i in local_src])
        digest = range_digest(feeds, rank, health)
        fence = t.fences.get(rid)
        if fence is None:
            fence = {"kind": "fence", "epoch": t.next_epoch(),
                     "plan": self.plan_id, "range": rid,
                     "src": int(r["src"]), "dst": int(r["dst"]),
                     "watermark": int(watermark), "digest": digest}
            cl._append_topo(fence)
        elif fence["digest"] != digest:
            raise RuntimeError(
                f"live reshard diverged at range {rid}: re-extracted "
                f"range digest {digest[:12]}.. != fenced "
                f"{str(fence['digest'])[:12]}.. — the source carry "
                f"mutated under the fence; refusing to install")
        if fire and fault.mode == "kill_router":
            # The router process dies with the fence durable and the
            # flip unwritten — the chaos scenario recovers the
            # directory and resumes from exactly here.
            os._exit(21)
        if fire and fault.mode == "torn_plan":
            self._fault_spent = True
            if cl._topo_log is not None:
                tear_topology_tail(cl._topo_log.path)
            raise MigrationInterrupted(
                f"topology log torn at fence of range {rid} "
                f"(injected) — recover the directory to resume")
        if fire and fault.mode == "kill_src":
            self._fault_spent = True
            cl.kill_shard(src.k,
                          reason=f"reshard:kill_src at range {rid} "
                                 f"(injected)")
            raise MigrationInterrupted(
                f"source shard {src.k} killed mid-handoff of range "
                f"{rid} (injected) — recover it and step again")
        # Install: ownership-guarded, digest-asserted,
        # idempotent — a resumed step re-installs over a half-landed
        # copy bit-identically.
        local_dst = np.searchsorted(dst.feeds, feeds)
        t.assert_fenced(self.plan_id, rid)
        dst.runtime.install_range(
            [int(i) for i in local_dst], rank, health,
            feeds=[int(f) for f in feeds],
            topo_epoch=int(fence["epoch"]), digest=digest,
            plan_id=self.plan_id, range_id=rid)
        dst.runtime.snapshot()
        if fire and fault.mode == "kill_dst":
            self._fault_spent = True
            cl.kill_shard(dst.k,
                          reason=f"reshard:kill_dst at range {rid} "
                                 f"(injected)")
            raise MigrationInterrupted(
                f"destination shard {dst.k} killed after install of "
                f"range {rid} (injected) — recover it and step again")
        flip = {"kind": "flip", "epoch": t.next_epoch(),
                "plan": self.plan_id, "range": rid,
                "src": int(r["src"]), "dst": int(r["dst"]),
                "feeds": [int(f) for f in feeds], "digest": digest}
        cl._append_topo(flip)
        if not self.remaining():
            self._complete()
        return rid

    def _complete(self) -> None:
        cl = self.cluster
        t = cl._topo
        srcs = sorted({int(r["src"]) for r in self.plan["ranges"]})
        cl._append_topo({"kind": "complete",
                         "epoch": t.next_epoch(),
                         "plan": self.plan_id})
        for k in srcs:
            if not (cl._owner == k).any():
                cl._append_topo({"kind": "retire",
                                 "epoch": t.next_epoch(), "k": k})
