"""Out-of-process shard workers: real crash domains for the serving
cluster (the counterpart of the JAX package's ``serving.worker``).

In-process fault domains share one Python process, one GIL, one fsync
queue and one fate: a real SIGSEGV/OOM in any shard
still kills the whole cluster, and every "crash" is an in-process
teardown.  This module moves each shard into a
SUBPROCESS worker that owns its ``shard-KKKK/`` directory (journal,
snapshots, sequencer — unchanged on disk, so in-process and worker
placement are interchangeable and recovery stays digest-asserted and
bit-identical) and speaks the :mod:`~redqueen_tpu_torch.serving.transport`
frame protocol over its stdin/stdout pipes:

- **Child** (``python -m redqueen_tpu_torch.serving.worker --dir D --shard
  K [--device cpu]``): torch-free until the first ``open``/``recover``
  request loads its shard on ``--device`` (the card by default: each
  child holds its own CUDA context; a child that finds no card fails
  that request with the reason and never serves on the CPU); serves
  one request at a time in lockstep, emits heartbeat frames when idle
  so the router can tell idle-alive from dead, and redirects fd 1 to
  stderr at startup so no stray ``print`` can poison the frame stream.
- **Router side** (:class:`WorkerHandle`): spawn / open / recover,
  request-response with ids (stale responses from a recovered timeout
  are discarded by id, never misattributed), per-request deadlines,
  heartbeat-age tracking, pipelined ``start_poll``/``finish_poll`` for
  true fan-out parallelism, and a SIGKILL teardown for poisoned or
  quarantined workers.  The handle presents the same surface the
  cluster router drives on an in-process ``ServingRuntime`` (submit /
  poll / decide / snapshot / digest / gather), so
  ``serving.cluster.ServingCluster`` treats both placements through one
  code path and the on-disk state stays the single source of truth.

Worker-level faults (``RQ_FAULT=worker:kill|hang|eof|garbage@shardK
[,batchN]``, :mod:`runtime.faultinject`) are applied by the worker
ITSELF at exact sub-batch sequence numbers, so SIGKILL-a-real-process,
wedged-worker-timeout, torn-frame, and protocol-garbage paths all run
deterministically on CPU in CI.

**Socket mode** (``--connect HOST:PORT``, the cross-host placement):
instead of stdin/stdout pipes the worker dials the router's per-shard
:class:`~redqueen_tpu_torch.serving.transport.Listener`, authenticates with a
hello frame (token via the ``RQ_WORKER_TOKEN`` env), and serves the
SAME frame protocol over TCP.  What sockets add is link-failure
tolerance: on EOF/reset the worker REDIALS under a deterministic
``runtime.supervisor.RetryPolicy`` backoff and resumes serving with its
runtime (journal, carry, queue) fully intact — the router reattaches
the same live process and resyncs the decisions whose response frames
the dead link ate (``replay_decisions``, backed by a bounded ring
buffer).  Network faults (``RQ_FAULT=net:drop|delay|partition|
reconnect@shardK[,batchN]``) are applied by the worker itself around
the response that carries sub-batch N, so every link failure runs
deterministically on CPU in CI.

Module-level imports are stdlib + numpy + the torch-free serving pieces
only; everything that pulls torch loads lazily when a shard does.  The
child is always a fresh interpreter started with ``subprocess.Popen``,
never a fork: the router has usually initialised CUDA already.
"""

from __future__ import annotations

import argparse
import collections
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..runtime import faultinject as _faultinject
from ..runtime import telemetry as _telemetry
from ..runtime.supervisor import RetryPolicy as _RetryPolicy
from .events import EventBatch
from .transport import (ENV_WORKER_TOKEN, FrameError, FrameReader,
                        Listener, TransportEOF, TransportError,
                        TransportTimeout, attach_trace, connect_worker,
                        encode_frame, extract_trace, write_frame)

__all__ = ["WorkerHandle", "SocketWorkerHandle", "WorkerOpError", "main",
           "HANG_FIRES", "ENV_HANG_FIRES",
           "DEFAULT_REQUEST_TIMEOUT_S", "DEFAULT_OPEN_TIMEOUT_S",
           "DEFAULT_HEARTBEAT_EVERY_S", "DEFAULT_READ_TIMEOUT_S",
           "RECONNECT_POLICY", "RECENT_DECISIONS",
           "NET_DELAY_S", "NET_PARTITION_S",
           "ENV_NET_DELAY_S", "ENV_NET_PARTITION_S"]

# An injected hang drops (never answers) this many requests targeting
# its batch, then the worker serves normally — bounded like the
# router's WEDGE_FIRES so the stream reconverges: fires < the router's
# QUARANTINE_AFTER means degrade+backoff+heal; the env override drives
# the quarantine->SIGKILL->restart path in tests.
HANG_FIRES = 2
ENV_HANG_FIRES = "RQ_WORKER_HANG_FIRES"

DEFAULT_REQUEST_TIMEOUT_S = 60.0
# open/recover pay the torch import + CUDA start; a crashed
# worker's replacement pays it again mid-serve, so the bound is its own.
DEFAULT_OPEN_TIMEOUT_S = 300.0
DEFAULT_HEARTBEAT_EVERY_S = 1.0
# The cheap read ops (decide / status) get their own, much shorter
# deadline: they are the cluster's never-blocks read path — a wedged
# worker must cost a read milliseconds-to-seconds, not the full apply
# budget.
DEFAULT_READ_TIMEOUT_S = 5.0

# Socket-mode link recovery: a worker that loses its connection redials
# under this schedule (seed=0: the redial timeline — and with it the
# whole net-chaos acceptance — is deterministic in CI), then gives up
# and exits (the router's crash path takes over: respawn + journal
# recovery).
RECONNECT_POLICY = _RetryPolicy(max_attempts=6, base_delay_s=0.2,
                                multiplier=2.0, max_delay_s=5.0,
                                jitter=0.1, seed=0)

# Bounded ring of recently-applied decisions kept for the router's
# ``replay_decisions`` resync (a lost response frame must not lose
# journaled facts from the router's ledger).  Far above any poll
# round's batch count; memory stays bounded per worker.
RECENT_DECISIONS = 8192

# net:delay sleeps this long before answering (must exceed the router's
# request deadline in the chaos tests — they shrink the deadline, not
# this); net:partition holds the link down this long before redialing.
NET_DELAY_S = 2.0
NET_PARTITION_S = 0.75
ENV_NET_DELAY_S = "RQ_NET_DELAY_S"
ENV_NET_PARTITION_S = "RQ_NET_PARTITION_S"


class _LinkDown(Exception):
    """Socket-mode internal: the connection died mid-serve (read EOF or
    write failure) — the serve loop must redial, not exit."""


class WorkerOpError(TransportError):
    """The worker answered a request with ``ok=false`` — its runtime
    raised (journal-append failure, open/recover error, ...).  The
    shard's fault domain can no longer be trusted mid-stream; the
    router treats it like a crash."""

    def __init__(self, op: str, error: str, message: str):
        self.op = op
        self.error = error
        super().__init__(f"worker {op} failed: {error}: {message}")


# ---------------------------------------------------------------------------
# The worker child
# ---------------------------------------------------------------------------


def _decision_dict(d) -> Dict[str, Any]:
    return {"seq": int(d.seq), "post": bool(d.post),
            "post_time": float(d.post_time),
            "intensity": float(d.intensity)}


def _close_quietly(sock) -> None:
    """Best-effort socket close — link teardown must never raise (both
    the worker child and the router handle share this)."""
    if sock is not None:
        try:
            sock.close()
        except OSError:
            pass


def _spawn_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The worker child's environment: the minimal-import flag plus the
    package root on PYTHONPATH — the child runs ``python -m
    redqueen_tpu_torch...`` and must find THIS package even when the parent
    imported it through a ``sys.path`` insert from another working
    directory (plain library usage, not just repo-cwd tests)."""
    env = dict(os.environ)
    env["RQ_SERVING_WORKER"] = "1"
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    prev = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (pkg_root if not prev
                         else pkg_root + os.pathsep + prev)
    if extra:
        env.update(extra)
    return env


class _Worker:
    """One shard's serving loop behind the frame protocol.  Owns the
    runtime from ``open``/``recover`` on; one request at a time.

    Pipe mode: ``in_fd``/``out_fd`` are stdin / the dup'd stdout.
    Socket mode: both are the connected socket's fd, ``connect_to`` is
    set, and a dead link redials + re-hellos instead of exiting — the
    runtime (journal, carry, queue) survives the partition."""

    def __init__(self, dir: str, shard: int, in_fd: int, out_fd: int,
                 heartbeat_every_s: float,
                 connect_to: Optional[str] = None,
                 token: Optional[str] = None, sock=None,
                 device: str = "cuda"):
        self.dir = dir
        self.shard = int(shard)
        # Resolved (and checked against the card) when a shard opens or
        # recovers, so a child without a card fails that request.
        self.device = str(device)
        self.in_fd = in_fd
        self.out_fd = out_fd
        self.hb_every = float(heartbeat_every_s)
        self.connect_to = connect_to
        self.token = token
        self._sock = sock  # keeps the socket object (and its fd) alive
        self.rt = None
        self._reader = FrameReader(in_fd)
        fault = _faultinject.worker_fault()
        self._fault = (fault if fault is not None
                       and fault.shard == self.shard else None)
        nf = _faultinject.net_fault()
        self._net_fault = (nf if nf is not None and connect_to is not None
                           and nf.shard == self.shard else None)
        self._net_armed: Optional[str] = None
        self._net_delay_s = float(os.environ.get(ENV_NET_DELAY_S,
                                                 NET_DELAY_S))
        self._net_partition_s = float(os.environ.get(
            ENV_NET_PARTITION_S, NET_PARTITION_S))
        self._hang_left = int(os.environ.get(ENV_HANG_FIRES, HANG_FIRES))
        self._poison_response = False  # garbage fault armed this reply
        # Recently applied decisions for the router's resync after a
        # lost response frame (replay_decisions).
        self._recent: collections.deque = collections.deque(
            maxlen=RECENT_DECISIONS)
        # Flight recorder: when tracing is on (RQ_TRACE / RQ_TRACE_FLIGHT
        # inherited through the spawn env), this process mirrors its
        # spans into a fixed-size ring INSIDE the shard directory — the
        # evidence a SIGKILL leaves behind, salvaged by the router's
        # crash path (cluster._crash_slot) and readable by any operator.
        tel = _telemetry.get()
        if tel.enabled and tel.flight_path is None and dir:
            tel.configure(
                flight=os.path.join(dir, _telemetry.FLIGHT_FILENAME))

    # -- link management (socket mode) --

    def _drop_link(self) -> None:
        _close_quietly(self._sock)
        self._sock = None

    def _redial(self) -> bool:
        """Reconnect under the deterministic RetryPolicy; True on a new
        live link, False when the budget is spent (the caller exits and
        the router's crash path takes over)."""
        if self.connect_to is None:
            return False
        self._drop_link()
        rng = RECONNECT_POLICY.rng()
        for attempt in range(1, RECONNECT_POLICY.max_attempts + 1):
            try:
                sock = connect_worker(self.connect_to, self.shard,
                                      self.token or "")
            except OSError as e:
                print(f"worker {self.shard}: redial attempt {attempt} "
                      f"failed: {e}", file=sys.stderr, flush=True)
                time.sleep(RECONNECT_POLICY.delay(attempt, rng))
                continue
            self._sock = sock
            self.in_fd = self.out_fd = sock.fileno()
            self._reader = FrameReader(self.in_fd)
            print(f"worker {self.shard}: reconnected to "
                  f"{self.connect_to} (attempt {attempt})",
                  file=sys.stderr, flush=True)
            return True
        return False

    # -- protocol plumbing --

    def _write(self, frame: Dict[str, Any]) -> None:
        try:
            write_frame(self.out_fd, frame)
        except OSError as e:
            if self.connect_to is not None:
                raise _LinkDown(str(e)) from e
            raise

    def _beat(self) -> None:
        self._write({"kind": "beat", "pid": os.getpid()})

    def _respond(self, req_id: int, value: Any, op: str) -> None:
        # ``op`` is echoed so the router can salvage a STALE poll
        # response (one that answered a request the router already timed
        # out on) instead of dropping applied decisions on the floor.
        frame = {"kind": "resp", "id": req_id, "op": op, "ok": True,
                 "value": value}
        if self._poison_response:
            # The garbage fault: non-protocol bytes instead of the
            # response — no magic, no checksum; the router's FrameReader
            # must refuse them and kill this (still running) process.
            self._poison_response = False
            os.write(self.out_fd, b"\x00\xffGARBAGE-NOT-A-FRAME" * 16)
            return
        armed, self._net_armed = self._net_armed, None
        if armed == "drop":
            # One response frame eaten by the network: the router's
            # deadline expires; the applied decisions resync later.
            print(f"worker {self.shard}: net:drop ate response "
                  f"{req_id}", file=sys.stderr, flush=True)
            return
        if armed == "delay":
            # Late past the router's deadline but salvageable by id.
            time.sleep(self._net_delay_s)
        elif armed == "partition":
            # Hard link loss with the response UNSENT, a dead interval,
            # then a redial: the router must reattach this same live
            # process and resync the decisions the link ate.
            print(f"worker {self.shard}: net:partition dropping link "
                  f"for {self._net_partition_s}s", file=sys.stderr,
                  flush=True)
            self._drop_link()
            time.sleep(self._net_partition_s)
            raise _LinkDown("injected net:partition")
        elif armed == "reconnect":
            # Clean link flap: redial immediately, answer on the new
            # connection.
            print(f"worker {self.shard}: net:reconnect flapping link",
                  file=sys.stderr, flush=True)
            self._drop_link()
            if not self._redial():
                raise _LinkDown("injected net:reconnect could not "
                                "redial")
        self._write(frame)

    def _fail(self, req_id: int, op: str, e: BaseException) -> None:
        self._write({
            "kind": "resp", "id": req_id, "op": op, "ok": False,
            "error": type(e).__name__, "message": str(e)})

    # -- fault helpers --

    def _fires(self, seq: int) -> bool:
        f = self._fault
        return f is not None and (f.batch is None or f.batch == int(seq))

    # -- request handlers --

    def _handle_open(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from .service import ServingRuntime

        cfg = req["config"]
        self.rt = ServingRuntime(
            n_feeds=int(cfg["n_feeds"]), q=float(cfg["q"]),
            s_sink=np.asarray(cfg["s_sink"], np.float64),
            seed=int(cfg["seed"]), dir=self.dir,
            start_seq=int(cfg["start_seq"]),
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
            journal_format=cfg.get("journal_format"),
            replication_factor=int(cfg.get("replication_factor") or 0),
            replication_quorum=cfg.get("replication_quorum"),
            replication_mode=str(cfg.get("replication_mode", "thread")),
            device=self.device)
        return {"applied_seq": self.rt.applied_seq, "pid": os.getpid(),
                "device": str(self.rt.device)}

    def _handle_recover(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from .service import recover

        acked = req.get("acked_seq")
        self.rt, info = recover(
            self.dir, acked_seq=None if acked is None else int(acked),
            heal_replicas=req.get("heal_replicas"), device=self.device)
        return {"applied_seq": self.rt.applied_seq, "pid": os.getpid(),
                "device": str(self.rt.device),
                "info": {"snapshot_seq": info.snapshot_seq,
                         "replayed": info.replayed,
                         "skipped": info.skipped,
                         "torn": info.torn,
                         "recovered_seq": info.recovered_seq,
                         "lost_acked_seqs":
                             list(info.lost_acked_seqs),
                         "healed_seqs": list(info.healed_seqs)}}

    def _adm_dict(self, adm) -> Dict[str, Any]:
        return {"status": adm.status, "seq": adm.seq,
                "backpressure": adm.backpressure, "reason": adm.reason,
                "missing": list(adm.missing)}

    def _handle_submit(self, req: Dict[str, Any]) -> Dict[str, Any]:
        batch = EventBatch(int(req["seq"]),
                           np.asarray(req["times"], np.float64),
                           np.asarray(req["feeds"], np.int32))
        return self._adm_dict(self.rt.submit(batch, _validated=True))

    def _handle_submit_many(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """One frame per ROUND: a whole list of sub-batches admitted in
        one request/response — the frame-protocol half of the wire-speed
        ingest path (the per-request round-trip was the measured
        overhead, not the admission work)."""
        admissions = []
        for b in req["batches"]:
            batch = EventBatch(int(b["seq"]),
                               np.asarray(b["times"], np.float64),
                               np.asarray(b["feeds"], np.int32))
            admissions.append(
                self._adm_dict(self.rt.submit(batch, _validated=True)))
        return {"admissions": admissions}

    def _handle_replay_decisions(self, req: Dict[str, Any]
                                 ) -> Dict[str, Any]:
        """The router's post-reattach resync: decisions with seq >
        ``after_seq`` from the bounded recent-ring.  ``complete`` is the
        no-gap witness (per-shard seqs are consecutive, so the expected
        count is exact); an incomplete answer sends the router to the
        journal-recovery path instead of trusting a hole."""
        after = int(req.get("after_seq", -1))
        ds = [d for d in self._recent if int(d["seq"]) > after]
        applied = self.rt.applied_seq
        expected = max(applied - after, 0)
        return {"decisions": ds, "applied_seq": applied,
                "complete": len(ds) == expected}

    def _handle_poll(self, req: Dict[str, Any]
                     ) -> Optional[Dict[str, Any]]:
        """Apply queued sub-batches one at a time so worker faults land
        at exact sequence numbers.  Returns None when the request must
        be DROPPED (the injected hang: the router's deadline expires)."""
        max_b = req.get("max_batches")
        decisions: List[Dict[str, Any]] = []
        if self._fault is None and self._net_fault is None:
            # No fault armed: drain in COALESCED groups (one dispatch +
            # one journal record per group — the wire-speed path).  The
            # per-batch stepping below exists only to land injected
            # faults at exact sub-batch seqs.
            ds = self.rt.poll(
                max_batches=None if max_b is None else int(max_b))
            return self._poll_value([_decision_dict(d) for d in ds])
        while max_b is None or len(decisions) < int(max_b):
            nq = self.rt.next_queued_seq()
            if nq is None:
                break
            f = self._fault
            if f is not None and f.mode == "hang" and self._fires(nq) \
                    and self._hang_left > 0:
                if decisions:
                    # Report the progress already applied; wedge on the
                    # next request, when the target batch heads the
                    # queue — a dropped request never hides applied
                    # decisions from the router's ledger.
                    break
                self._hang_left -= 1
                if self._hang_left == 0:
                    self._fault = None
                print(f"worker {self.shard}: injected hang at sub-batch "
                      f"{nq} (dropping the request)", file=sys.stderr,
                      flush=True)
                return None
            ds = self.rt.poll(max_batches=1)
            if not ds:
                break
            d = ds[0]
            decisions.append(_decision_dict(d))
            if f is not None and self._fires(d.seq):
                if f.mode == "kill":
                    # Batch d.seq is applied + journaled; the ack frame
                    # never leaves — a REAL process crash domain.
                    os.kill(os.getpid(), signal.SIGKILL)
                elif f.mode == "eof":
                    self._fault = None
                    torn = encode_frame({
                        "kind": "resp", "id": int(req["id"]),
                        "op": "poll", "ok": True,
                        "value": self._poll_value(decisions)})
                    os.write(self.out_fd, torn[:len(torn) // 2])
                    os._exit(0)
                elif f.mode == "garbage":
                    self._fault = None
                    self._poison_response = True
        nf = self._net_fault
        if nf is not None and decisions and (
                nf.batch is None
                or any(int(d["seq"]) == nf.batch for d in decisions)):
            # Arm the link fault on THIS response — it carries the
            # addressed sub-batch's decision, so the chaos timeline is
            # pinned to an exact stream position.
            self._net_fault = None
            self._net_armed = nf.mode
        return self._poll_value(decisions)

    def _poll_value(self, decisions: List[Dict[str, Any]]
                    ) -> Dict[str, Any]:
        self._recent.extend(decisions)
        return {"decisions": decisions, "pending": self.rt.pending,
                "applied_seq": self.rt.applied_seq}

    def _handle_install_range(self, req: Dict[str, Any]
                              ) -> Dict[str, Any]:
        """The worker-side mirror of the migrated-range install.  The
        topology-epoch ownership fence is asserted ROUTER-side
        (``serving.topology.Migration`` guards before sending this
        frame — the worker has no topology view); the payload digest is
        still re-asserted here against the fence digest in the frame."""
        self.rt.install_range(
            [int(i) for i in req["idx"]],
            np.asarray(req["rank"], np.float32),
            np.asarray(req["health"], np.uint32),
            feeds=[int(f) for f in req["feeds"]],
            topo_epoch=int(req["topo_epoch"]),
            digest=str(req["digest"]),
            plan_id=str(req["plan"]),
            range_id=int(req["range"]))
        return {}

    def _handle(self, req: Dict[str, Any]) -> Tuple[bool, Any]:
        """Dispatch one request; returns ``(respond, value)``."""
        op = req.get("op")
        if op == "open":
            return True, self._handle_open(req)
        if op == "recover":
            return True, self._handle_recover(req)
        if op == "submit":
            return True, self._handle_submit(req)
        if op == "submit_many":
            return True, self._handle_submit_many(req)
        if op == "replay_decisions":
            return True, self._handle_replay_decisions(req)
        if op == "poll":
            value = self._handle_poll(req)
            return value is not None, value
        if op == "decide":
            d = self.rt.decide()
            return True, {"decision": None if d is None
                          else _decision_dict(d),
                          "pending": self.rt.pending}
        if op == "status":
            return True, {"pending": self.rt.pending,
                          "applied_seq": self.rt.applied_seq,
                          "next_queued_seq": self.rt.next_queued_seq()}
        if op == "snapshot":
            return True, {"step": self.rt.snapshot()}
        if op == "digest":
            return True, {"digest": self.rt.state_digest()}
        if op == "gather":
            r, h, sq, t, nb = self.rt.gather()
            return True, {"rank": [float(x) for x in r],
                          "health": [int(x) for x in h],
                          "seq": sq, "t": t, "n_batches": nb}
        if op == "extract_range":
            r, h = self.rt.extract_range(
                [int(i) for i in req["idx"]])
            return True, {"rank": [float(x) for x in r],
                          "health": [int(x) for x in h]}
        if op == "install_range":
            return True, self._handle_install_range(req)
        if op == "reset_metrics":
            self.rt.reset_metrics()
            return True, {}
        if op == "telemetry":
            # The router's live-forensics read: this process's recent
            # spans + counters (the crash path reads the on-disk ring
            # instead — a dead process answers no ops).
            tel = _telemetry.get()
            return True, {"spans": tel.recent_spans(
                              int(req.get("limit", 512))),
                          "counters": dict(tel.counters),
                          "pid": os.getpid()}
        raise ValueError(f"unknown worker op {op!r}")

    def serve(self) -> int:
        """The outer loop: serve the link until it dies; in socket mode
        a dead link redials (runtime intact) instead of exiting — the
        partition-tolerance contract."""
        while True:
            try:
                return self._serve_link()
            except (_LinkDown, TransportEOF) as e:
                if self.connect_to is None:
                    # Pipe mode: the router went away — release the
                    # journal and exit clean.
                    if self.rt is not None:
                        self.rt.close()
                    return 0
                print(f"worker {self.shard}: link down ({e}); "
                      f"redialing", file=sys.stderr, flush=True)
                if not self._redial():
                    # Redial budget spent: the router is really gone (or
                    # unreachable past the policy horizon).  Exit with
                    # the journal synced — the respawn/recovery path
                    # owns what happens next.
                    if self.rt is not None:
                        self.rt.close()
                    return 3

    def _serve_link(self) -> int:
        """The main loop: requests in lockstep, heartbeats when idle."""
        while True:
            try:
                req = self._reader.read_frame(timeout_s=self.hb_every)
            except TransportTimeout:
                self._beat()
                continue
            req_id = int(req.get("id", -1))
            op = str(req.get("op"))
            if op == "shutdown":
                if self.rt is not None:
                    self.rt.close()
                self._respond(req_id, {}, op)
                return 0
            # Adopt the request's trace context (when the frame carries
            # one): this worker's spans chain under the router's span,
            # so one request's timeline stitches across the process —
            # and across hosts in socket mode (same frames).
            with _telemetry.attach(extract_trace(req)):
                with _telemetry.span("worker." + op) as tsp:
                    tsp.set(shard=self.shard)
                    try:
                        respond, value = self._handle(req)
                    except Exception as e:  # noqa: BLE001 — classified
                        # router-side
                        self._fail(req_id, op, e)
                        continue
            if respond:
                self._respond(req_id, value, op)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m redqueen_tpu_torch.serving.worker",
        description="one shard fault domain as a subprocess worker "
                    "(frame protocol on stdin/stdout; spawned by "
                    "ServingCluster in worker placement)")
    ap.add_argument("--dir", required=True,
                    help="this shard's serving directory "
                         "(<cluster>/shard-KKKK)")
    ap.add_argument("--shard", type=int, required=True,
                    help="shard index (worker:* fault addressing)")
    ap.add_argument("--heartbeat-every", type=float,
                    default=DEFAULT_HEARTBEAT_EVERY_S,
                    help="idle heartbeat-frame interval, seconds")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="SOCKET mode: dial the router's per-shard "
                         "listener instead of speaking frames on "
                         "stdin/stdout — the cross-host placement "
                         "(token via the RQ_WORKER_TOKEN env; a lost "
                         "link redials under RetryPolicy backoff)")
    ap.add_argument("--device", default="cuda",
                    help="where the shard's carry lives and its applies "
                         "run (default: the card; an open or recover "
                         "without one fails)")
    args = ap.parse_args(argv)

    # Point everything that thinks it is printing to stdout at stderr —
    # one stray print() (torch, a library, a debug line) must not poison
    # the frame stream (socket mode keeps the discipline: logs belong
    # on stderr either way).
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    if args.connect:
        token = os.environ.get(ENV_WORKER_TOKEN, "")
        try:
            sock = connect_worker(args.connect, args.shard, token)
        except OSError as e:
            print(f"worker {args.shard}: cannot reach router at "
                  f"{args.connect}: {e}", file=sys.stderr, flush=True)
            return 2
        worker = _Worker(args.dir, args.shard, sock.fileno(),
                         sock.fileno(), args.heartbeat_every,
                         connect_to=args.connect, token=token, sock=sock,
                         device=args.device)
    else:
        worker = _Worker(args.dir, args.shard, sys.stdin.fileno(),
                         proto_fd, args.heartbeat_every,
                         device=args.device)
    worker._beat()  # birth announcement: the router's first liveness
    return worker.serve()


# ---------------------------------------------------------------------------
# Router-side handle
# ---------------------------------------------------------------------------


class WorkerHandle:
    """The router's end of one worker: spawn, lockstep request/response
    with ids and deadlines, heartbeat-age tracking, SIGKILL teardown.
    Presents the ``ServingRuntime`` surface the cluster router drives
    (submit / poll / decide / snapshot / digest / gather / ...), plus
    ``start_*``/``finish_*`` split calls so the router can fan a request
    out to every worker before collecting any response — that overlap
    IS the parallel-serving win."""

    def __init__(self, proc: subprocess.Popen, shard: int,
                 request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
                 open_timeout_s: float = DEFAULT_OPEN_TIMEOUT_S,
                 read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                 clock=time.monotonic):
        self.proc = proc
        self.shard = int(shard)
        self.request_timeout_s = float(request_timeout_s)
        self.open_timeout_s = float(open_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        self._clock = clock
        if proc is not None and proc.stdout is not None:
            # Pipe placement; the socket subclass installs its own
            # reader/write-fd over the accepted connection.
            self._reader = FrameReader(proc.stdout.fileno(), clock=clock)
            self._wfd = proc.stdin.fileno()
        self._next_id = 0
        # The device the child's shard serves on, as it reported at
        # open/recover (None until then).
        self.device: Optional[str] = None
        self._last_frame_t = clock()
        # applied_seq the worker reported on its latest poll response —
        # the router's resync trigger (outstanding seqs at or below it
        # were applied but their response frame never arrived).
        self.last_polled_seq: Optional[int] = None
        # Salvaged values of poll responses that answered a request the
        # router already timed out on — their decisions were APPLIED and
        # JOURNALED by the worker, so dropping them would desync the
        # router's outstanding ledger.  The router drains these after
        # every poll round (drain_stale_polls).
        self._stale_polls: List[Dict[str, Any]] = []

    @classmethod
    def spawn(cls, dir: str, shard: int,
              heartbeat_every_s: float = DEFAULT_HEARTBEAT_EVERY_S,
              request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
              open_timeout_s: float = DEFAULT_OPEN_TIMEOUT_S,
              read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
              env: Optional[Dict[str, str]] = None,
              clock=time.monotonic,
              device: str = "cuda") -> "WorkerHandle":
        """Start the child process (it stays torch-free and cheap until
        ``start_open``/``start_recover`` loads the shard on ``device``,
        the card unless ``"cpu"``).  ``env`` entries override the
        inherited environment."""
        cmd = [sys.executable, "-m", "redqueen_tpu_torch.serving.worker",
               "--dir", str(dir), "--shard", str(int(shard)),
               "--heartbeat-every", str(float(heartbeat_every_s)),
               "--device", str(device)]
        # RQ_SERVING_WORKER=1 (the minimal-import flag: the child's
        # package imports skip the eager torch-pulling re-exports, PEP
        # 562 lazy fallbacks keep the surface whole, so a worker spawns
        # cheap and stays torch-free until open/recover loads its shard)
        # + the package root on PYTHONPATH (library usage).  A fresh
        # interpreter, never a fork of this (CUDA-initialised) process.
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                env=_spawn_env(env))
        return cls(proc, shard, request_timeout_s=request_timeout_s,
                   open_timeout_s=open_timeout_s,
                   read_timeout_s=read_timeout_s, clock=clock)

    # -- low-level protocol --

    def _send(self, op: str, **fields) -> int:
        self._next_id += 1
        req_id = self._next_id
        # attach_trace stamps the current telemetry context (when
        # tracing is on) so the worker's spans chain under this
        # request's span — the cross-process half of one trace.
        frame = attach_trace(
            {"kind": "req", "id": req_id, "op": op, **fields})
        try:
            write_frame(self._wfd, frame)
        except (OSError, ValueError) as e:
            raise TransportEOF(
                f"worker {self.shard} link closed on send: {e}") from e
        return req_id

    def _note_stale(self, frame: Dict[str, Any]) -> None:
        """A response to a request the router gave up on: keep applied
        poll results (their decisions are journaled facts the ledger
        must see), drop everything else (a retried request re-answers)."""
        if frame.get("op") == "poll" and frame.get("ok") \
                and isinstance(frame.get("value"), dict):
            self._stale_polls.append(frame["value"])

    def drain_stale_polls(self) -> List[Dict[str, Any]]:
        """Salvaged poll values observed since the last drain (oldest
        first); clears the buffer."""
        out, self._stale_polls = self._stale_polls, []
        return out

    def _wait(self, req_id: int, timeout_s: float, op: str) -> Any:
        deadline = self._clock() + timeout_s
        while True:
            remaining = deadline - self._clock()
            frame = self._reader.read_frame(timeout_s=max(remaining, 0))
            self._last_frame_t = self._clock()
            kind = frame.get("kind")
            if kind == "beat":
                continue
            if kind != "resp":
                raise FrameError(
                    f"worker {self.shard} sent frame kind {kind!r} "
                    f"(want resp/beat) — protocol desync")
            resp_id = int(frame.get("id", -1))
            if resp_id < req_id:
                self._note_stale(frame)  # answer to a timed-out request
                continue
            if resp_id > req_id:
                raise FrameError(
                    f"worker {self.shard} answered request {resp_id} "
                    f"while {req_id} is outstanding — protocol desync")
            if not frame.get("ok"):
                raise WorkerOpError(op, str(frame.get("error")),
                                    str(frame.get("message")))
            return frame.get("value")

    # The cheap read ops: never touch the journal or the apply,
    # so they run on the short read deadline — the cluster's
    # never-blocks read path must cost a wedged worker seconds, not the
    # full apply budget.
    READ_OPS = ("decide", "status")

    def request(self, op: str, timeout_s: Optional[float] = None,
                **fields) -> Any:
        if timeout_s is None:
            timeout_s = (self.read_timeout_s if op in self.READ_OPS
                         else self.request_timeout_s)
        return self._wait(self._send(op, **fields), timeout_s, op)

    # -- liveness --

    def alive(self) -> bool:
        return self.proc.poll() is None

    def drain_beats(self) -> None:
        """Consume any frames already buffered (heartbeats pile up
        while the router is busy elsewhere) without blocking, so
        :meth:`beat_age` reflects the worker, not the router.  A resp
        frame found here is by construction stale (nothing is
        outstanding when the router drains) — salvaged like
        :meth:`_wait` does, never silently eaten."""
        while True:
            try:
                frame = self._reader.read_frame(timeout_s=0)
            except TransportTimeout:
                return
            except TransportError:
                return  # poisoned/dead: the next real request classifies
            self._last_frame_t = self._clock()
            if frame.get("kind") == "resp":
                self._note_stale(frame)

    def beat_age(self) -> float:
        """Seconds since the last frame observed from this worker."""
        return self._clock() - self._last_frame_t

    # -- teardown --

    def kill(self) -> None:
        """SIGKILL + reap + close pipes — the teardown for a crashed,
        wedged-past-quarantine, or protocol-poisoned worker.  Never
        raises."""
        try:
            self.proc.kill()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10.0)
        except (subprocess.TimeoutExpired, OSError):
            pass
        for f in (self.proc.stdin, self.proc.stdout):
            if f is None:
                continue  # socket placement: no pipe pair to close
            try:
                f.close()
            except OSError:
                pass

    def close(self, timeout_s: float = 10.0) -> None:
        """Graceful shutdown: ask, wait, then SIGKILL stragglers."""
        if self.alive():
            try:
                self.request("shutdown", timeout_s=timeout_s)
            except TransportError:
                pass
        self.kill()

    # -- the ServingRuntime surface the cluster router drives --

    def start_open(self, config: Dict[str, Any]) -> int:
        return self._send("open", config=config)

    def finish_open(self, req_id: int) -> int:
        value = self._wait(req_id, self.open_timeout_s, "open")
        self.device = value.get("device")
        return int(value["applied_seq"])

    def start_recover(self, acked_seq: Optional[int] = None) -> int:
        return self._send("recover", acked_seq=acked_seq)

    def finish_recover(self, req_id: int):
        from .service import RecoveryInfo

        value = self._wait(req_id, self.open_timeout_s, "recover")
        self.device = value.get("device")
        i = value["info"]
        return RecoveryInfo(
            snapshot_seq=i["snapshot_seq"], replayed=int(i["replayed"]),
            skipped=int(i["skipped"]), torn=i["torn"],
            recovered_seq=int(i["recovered_seq"]),
            lost_acked_seqs=tuple(
                int(s) for s in i.get("lost_acked_seqs", ())),
            healed_seqs=tuple(
                int(s) for s in i.get("healed_seqs", ())))

    def start_submit(self, batch: EventBatch) -> int:
        return self._send("submit", seq=int(batch.seq),
                          times=[float(t) for t in batch.times],
                          feeds=[int(f) for f in batch.feeds])

    def finish_submit(self, req_id: int):
        from .service import Admission

        value = self._wait(req_id, self.request_timeout_s, "submit")
        return Admission(status=value["status"], seq=value["seq"],
                         backpressure=bool(value["backpressure"]),
                         reason=value["reason"],
                         missing=tuple(value["missing"]))

    def submit(self, batch: EventBatch, _validated: bool = False):
        return self.finish_submit(self.start_submit(batch))

    def start_submit_many(self, batches: List[EventBatch]) -> int:
        """One frame for a whole ROUND of sub-batches (the batched frame
        protocol: admission round-trips were the measured ingest tax,
        not the admission work)."""
        return self._send("submit_many", batches=[
            {"seq": int(b.seq),
             "times": [float(t) for t in b.times],
             "feeds": [int(f) for f in b.feeds]} for b in batches])

    def finish_submit_many(self, req_id: int) -> List[Any]:
        from .service import Admission

        value = self._wait(req_id, self.request_timeout_s,
                           "submit_many")
        return [Admission(status=v["status"], seq=v["seq"],
                          backpressure=bool(v["backpressure"]),
                          reason=v["reason"],
                          missing=tuple(v["missing"]))
                for v in value["admissions"]]

    def start_poll(self, max_batches: Optional[int] = None) -> int:
        return self._send("poll", max_batches=max_batches)

    def finish_poll(self, req_id: int,
                    timeout_s: Optional[float] = None) -> List[Any]:
        """``timeout_s`` overrides the request deadline — the cluster's
        post-reattach retry passes a SHORT one (the response usually
        died with the link; resync heals that case, so the retry must
        not stall the whole round on the full apply budget)."""
        value = self._wait(req_id,
                           self.request_timeout_s if timeout_s is None
                           else float(timeout_s), "poll")
        self.last_polled_seq = int(value["applied_seq"])
        return [self._decision(d) for d in value["decisions"]]

    def replay_decisions(self, after_seq: int
                         ) -> Tuple[List[Any], bool]:
        """Resync: the worker's applied decisions with seq >
        ``after_seq`` from its recent-ring, plus the no-gap witness.
        Used after a lost response frame (net drop / partition /
        reconnect) so journaled facts re-enter the router's ledger."""
        value = self.request("replay_decisions", after_seq=int(after_seq))
        return ([self._decision(d) for d in value["decisions"]],
                bool(value["complete"]))

    def poll(self, max_batches: Optional[int] = None) -> List[Any]:
        return self.finish_poll(self.start_poll(max_batches))

    @staticmethod
    def _decision(d: Dict[str, Any]):
        from .state import Decision

        return Decision(seq=int(d["seq"]), post=bool(d["post"]),
                        post_time=float(d["post_time"]),
                        intensity=float(d["intensity"]))

    def decide(self):
        value = self.request("decide")
        d = value["decision"]
        if d is None:
            return None
        return self._decision(d)._replace(
            stale_batches=int(value["pending"]))

    @property
    def pending(self) -> int:
        return int(self.request("status")["pending"])

    @property
    def applied_seq(self) -> int:
        return int(self.request("status")["applied_seq"])

    def next_queued_seq(self) -> Optional[int]:
        nq = self.request("status")["next_queued_seq"]
        return None if nq is None else int(nq)

    def snapshot(self) -> Optional[int]:
        step = self.request("snapshot")["step"]
        return None if step is None else int(step)

    def state_digest(self) -> str:
        return str(self.request("digest")["digest"])

    def reset_metrics(self) -> None:
        self.request("reset_metrics")

    def telemetry(self, limit: int = 512) -> Dict[str, Any]:
        """The worker process's recent telemetry: ``{"spans": [...],
        "counters": {...}, "pid": ...}`` (empty when tracing is off in
        the child).  The live counterpart of the crash path's on-disk
        flight-ring salvage."""
        return self.request("telemetry", limit=int(limit))

    def gather(self) -> Tuple[np.ndarray, np.ndarray, int, float, int]:
        """The shard's per-edge carry for the cluster's edge-digest /
        reshard gather: ``(rank f32[F], health u32[F], seq, t,
        n_batches)``.  Python floats round-trip float32 values exactly
        through JSON (NaN/Inf included), so the gathered digest is
        bit-identical to an in-process gather."""
        v = self.request("gather")
        return (np.asarray(v["rank"], np.float32),
                np.asarray(v["health"], np.uint32),
                int(v["seq"]), float(v["t"]), int(v["n_batches"]))

    def extract_range(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """The fenced carry slice over the frame protocol — same f32-
        exact JSON round-trip as :meth:`gather`, so the range digest
        the router computes matches an in-process extract bitwise."""
        v = self.request("extract_range",
                         idx=[int(i) for i in idx])
        return (np.asarray(v["rank"], np.float32),
                np.asarray(v["health"], np.uint32))

    def install_range(self, idx, rank, health, *, feeds, topo_epoch,
                      digest, plan_id, range_id) -> None:
        """Stream one fenced range into the worker's carry (journaled
        + fsynced in the worker before the reply frame — the reply IS
        the durable-receipt ack the router's flip waits on)."""
        self.request("install_range",
                     idx=[int(i) for i in idx],
                     rank=[float(x) for x in np.asarray(rank,
                                                        np.float32)],
                     health=[int(x) for x in np.asarray(health,
                                                        np.uint32)],
                     feeds=[int(f) for f in feeds],
                     topo_epoch=int(topo_epoch), digest=str(digest),
                     plan=str(plan_id), range=int(range_id))

    @property
    def journal_path(self) -> Optional[str]:
        return None  # the journal lives in the worker process

    def try_reattach(self, grace_s: float = 5.0) -> bool:
        """Pipe transports cannot reattach — a dead pipe is a dead
        worker.  The socket handle overrides this with the real
        re-accept protocol."""
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SocketWorkerHandle(WorkerHandle):
    """A :class:`WorkerHandle` whose frames ride a TCP connection —
    the cross-host placement.  The router owns one
    :class:`~redqueen_tpu_torch.serving.transport.Listener` per shard; the
    worker child dials it (``--connect``) and authenticates with the
    cluster token.  Two things differ from the pipe handle:

    - **Spawn is detachable from locality.**  :meth:`spawn_socket`
      starts the child locally; :meth:`remote_command` returns the
      exact argv + env to start the SAME worker on any host that can
      reach the listener, and :meth:`await_external` just waits for it
      to dial in — `placement="sockets"` spans hosts by running one
      printed command per shard.
    - **A dead link is not a dead worker.**  :meth:`try_reattach`
      re-accepts a redialing worker (hello must carry the same shard,
      token, AND pid — only the same live process may resume), after
      which the router resyncs the decisions the dead link ate
      (``replay_decisions``) instead of paying a journal recovery."""

    def __init__(self, proc: Optional[subprocess.Popen], shard: int,
                 listener: Listener, token: str, sock, reader,
                 request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
                 open_timeout_s: float = DEFAULT_OPEN_TIMEOUT_S,
                 read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                 clock=time.monotonic):
        super().__init__(proc, shard,
                         request_timeout_s=request_timeout_s,
                         open_timeout_s=open_timeout_s,
                         read_timeout_s=read_timeout_s, clock=clock)
        self.listener = listener
        self.token = token
        self._sock = sock
        self._reader = reader  # owns bytes buffered past the hello
        self._wfd = sock.fileno()
        self.worker_pid: Optional[int] = (
            None if proc is None else proc.pid)

    # -- spawn / remote spawn --

    @staticmethod
    def worker_argv(dir: str, shard: int, address: str,
                    heartbeat_every_s: float = DEFAULT_HEARTBEAT_EVERY_S,
                    device: str = "cuda") -> List[str]:
        """The worker command line for ``--connect`` mode — what a
        remote host runs (plus ``RQ_WORKER_TOKEN`` in its env) to serve
        this shard across the network, on ``device``."""
        return [sys.executable, "-m", "redqueen_tpu_torch.serving.worker",
                "--dir", str(dir), "--shard", str(int(shard)),
                "--heartbeat-every", str(float(heartbeat_every_s)),
                "--connect", str(address), "--device", str(device)]

    @classmethod
    def remote_command(cls, dir: str, shard: int, address: str,
                       heartbeat_every_s: float =
                       DEFAULT_HEARTBEAT_EVERY_S,
                       device: str = "cuda") -> Dict[str, Any]:
        """The remote-spawn recipe: ``{"argv": [...], "env":
        {"RQ_WORKER_TOKEN": ...}}`` minus the token value (the operator
        supplies it out of band).  ``dir`` must name the shard
        directory AS THE REMOTE HOST SEES IT (shared filesystem or a
        synced copy — the journal lives with the worker).  The argv
        names ``device``: the remote worker serves there."""
        return {"argv": cls.worker_argv(dir, shard, address,
                                        heartbeat_every_s, device=device),
                "env": [ENV_WORKER_TOKEN]}

    @classmethod
    def launch(cls, dir: str, shard: int, listener: Listener,
               token: str,
               heartbeat_every_s: float = DEFAULT_HEARTBEAT_EVERY_S,
               env: Optional[Dict[str, str]] = None,
               device: str = "cuda") -> subprocess.Popen:
        """Start the child WITHOUT waiting for its dial-in — the
        cluster launches all N children first and then accepts each
        hello, so interpreter start + package import + dial overlap
        across shards instead of serializing."""
        cmd = cls.worker_argv(dir, shard, listener.address,
                              heartbeat_every_s, device=device)
        child_env = _spawn_env(env)
        child_env[ENV_WORKER_TOKEN] = token
        return subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                                env=child_env)

    @classmethod
    def from_child(cls, proc: subprocess.Popen, shard: int,
                   listener: Listener, token: str,
                   request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
                   open_timeout_s: float = DEFAULT_OPEN_TIMEOUT_S,
                   read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                   accept_timeout_s: float = 30.0,
                   clock=time.monotonic) -> "SocketWorkerHandle":
        """Accept a :meth:`launch`-ed child's hello (pid-matched) into
        a handle; SIGKILLs the child when nothing authentic dials in."""
        try:
            sock, hello, reader = listener.accept(
                token, shard, timeout_s=accept_timeout_s,
                expect_pid=proc.pid)
        except TransportError:
            try:
                proc.kill()
            except OSError:
                pass
            raise
        try:
            return cls(proc, shard, listener, token, sock, reader,
                       request_timeout_s=request_timeout_s,
                       open_timeout_s=open_timeout_s,
                       read_timeout_s=read_timeout_s, clock=clock)
        except BaseException:
            _close_quietly(sock)  # never leak the accepted fd
            raise

    @classmethod
    def spawn_socket(cls, dir: str, shard: int, listener: Listener,
                     token: str,
                     heartbeat_every_s: float = DEFAULT_HEARTBEAT_EVERY_S,
                     request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
                     open_timeout_s: float = DEFAULT_OPEN_TIMEOUT_S,
                     read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                     accept_timeout_s: float = 30.0,
                     env: Optional[Dict[str, str]] = None,
                     clock=time.monotonic,
                     device: str = "cuda") -> "SocketWorkerHandle":
        """Start the child locally and wait for it to dial the
        listener (:meth:`launch` + :meth:`from_child`).  (For a REMOTE
        worker, run :meth:`worker_argv`'s command on the other host and
        use :meth:`await_external` /
        ``ServingCluster.adopt_external_worker``.)"""
        proc = cls.launch(dir, shard, listener, token,
                          heartbeat_every_s=heartbeat_every_s, env=env,
                          device=device)
        return cls.from_child(proc, shard, listener, token,
                              request_timeout_s=request_timeout_s,
                              open_timeout_s=open_timeout_s,
                              read_timeout_s=read_timeout_s,
                              accept_timeout_s=accept_timeout_s,
                              clock=clock)

    @classmethod
    def await_external(cls, shard: int, listener: Listener, token: str,
                       accept_timeout_s: float = 300.0,
                       request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
                       open_timeout_s: float = DEFAULT_OPEN_TIMEOUT_S,
                       read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                       clock=time.monotonic) -> "SocketWorkerHandle":
        """Adopt a worker someone ELSE spawned (another host, a
        container scheduler): wait for its authenticated hello.  The
        handle has no child process to SIGKILL — ``kill()`` degrades to
        closing the link (the remote supervisor owns the process)."""
        sock, hello, reader = listener.accept(
            token, shard, timeout_s=accept_timeout_s)
        try:
            h = cls(None, shard, listener, token, sock, reader,
                    request_timeout_s=request_timeout_s,
                    open_timeout_s=open_timeout_s,
                    read_timeout_s=read_timeout_s, clock=clock)
            h.worker_pid = int(hello.get("pid", -1))
        except BaseException:
            _close_quietly(sock)  # never leak the accepted fd
            raise
        return h

    # -- liveness / link management --

    def alive(self) -> bool:
        if self.proc is None:
            return self._sock is not None  # external: the link is all
        return self.proc.poll() is None    # we can observe

    def _drop_link(self) -> None:
        _close_quietly(self._sock)
        self._sock = None

    def sever_link(self) -> None:
        """CHAOS HOOK (the router side of a network partition): shut the
        connection down abruptly — the worker process stays alive and
        will redial; the router heals through :meth:`try_reattach` +
        resync.  What ``ServingCluster.partition_shard`` drives."""
        if self._sock is not None:
            import socket as _socket

            try:
                self._sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass

    def try_reattach(self, grace_s: float = 5.0) -> bool:
        """Accept the SAME worker's redial (hello pid must match) and
        swap the link in; False when nothing authentic dials back
        within ``grace_s`` (then the worker really is gone — crash
        path).  In-flight requests on the old link are lost: the caller
        must resync (``replay_decisions``) before trusting its ledger."""
        self._drop_link()
        # Externally-adopted workers (proc is None) pin the pid learned
        # from the FIRST hello — only the same live process may resume,
        # never a second worker racing the journal's single writer.
        expect = (self.worker_pid if self.proc is None
                  else self.proc.pid)
        try:
            sock, hello, reader = self.listener.accept(
                self.token, self.shard, timeout_s=grace_s,
                expect_pid=expect)
        except TransportError:
            return False
        try:
            wfd = sock.fileno()
        except (OSError, ValueError):
            _close_quietly(sock)  # torn down under us: treat as no-show
            return False
        self._sock = sock
        self._reader = reader
        self._wfd = wfd
        self._last_frame_t = self._clock()
        if self.proc is None:
            self.worker_pid = int(hello.get("pid", -1))
        return True

    def kill(self) -> None:
        """SIGKILL (when the process is ours) + close the link.  The
        per-shard listener is NOT closed — it belongs to the cluster
        slot and a replacement worker reuses the address."""
        if self.proc is not None:
            try:
                self.proc.kill()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=10.0)
            except (subprocess.TimeoutExpired, OSError):
                pass
        self._drop_link()


if __name__ == "__main__":
    raise SystemExit(main())
