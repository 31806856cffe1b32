"""The open-loop serving driver: micro-batches of feed events arrive on a
schedule drawn from the seed, whatever the service is doing, and each
batch's decision latency runs from when it was due.

One thread plays the feeds and the client: it submits every batch that
has come due (in order; a batch the service sheds is sent again after the
next poll, and counts as failed), then asks the service for one group of
decisions, and sleeps when nothing is due and nothing is queued.  A
decision counts as returned when ``poll`` hands it back.  At that moment
the driver reads how many journal records the followers have
acknowledged (the replication layer's watermark), so that a decision
handed back before a quorum held its record shows.  Batches due in the
window are drained after it; one still undecided a minute later counts
as failed.

Once the window has closed the reference judges every decision, the
final carry, the journals, and each decision's watermark against the
number of the leader's record that holds it (see
``reference.serving``)."""

from __future__ import annotations

import collections
import contextlib
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from ..common import GcPauses, Record, host_probe_ms, rng, seed_words
from ..reference import serving as ref
from ..trace import DeviceTrace, Phases

__all__ = ["Program", "Control", "control", "stream", "run"]

#: Seconds past the window that batches due in it may take to be decided.
DRAIN_S = 60.0


def stream(seed: int, n: int, n_feeds: int, events_per_batch: float,
           span: float):
    """``n`` batches ``(seq, times, feeds)``: a Poisson number of wall
    events each, uniform over the batch's ``span`` of serving time (the
    batches tile the time axis) and over the feeds."""
    g = rng(seed, 3)
    counts = g.poisson(events_per_batch, n)
    out = []
    for i, c in enumerate(counts):
        times = np.sort(g.uniform(i * span, (i + 1) * span, int(c)))
        feeds = g.integers(0, n_feeds, int(c)).astype(np.int32)
        out.append((i, times, feeds))
    return out


def arrivals(seed: int, n: int, rate: float) -> np.ndarray:
    """Due times (seconds from the window's start) of ``n`` batches with
    exponential gaps at ``rate`` batches a second."""
    return np.cumsum(rng(seed, 4).exponential(1.0 / rate, n))


class Program:
    """The port's ``ServingRuntime`` on the card, its journal replicated
    to in-process followers."""

    def __init__(self, config: Dict, n_feeds: int, seed: int, dir: str,
                 device):
        import torch

        from redqueen_tpu_torch import serving

        self.torch, self.serving, self.dev = torch, serving, device
        self.dir = dir
        kw = {k: config[k] for k in (
            "snapshot_every", "queue_capacity", "reorder_window",
            "max_batch_events", "coalesce", "flush_mode",
            "max_unflushed_records", "max_flush_delay_ms", "journal_format",
            "replication_factor", "replication_quorum")}
        self.rt = serving.ServingRuntime(
            n_feeds, q=float(config["q"]),
            s_sink=np.full(n_feeds, float(config["s_sink"])),
            seed=seed, dir=dir, device=device, **kw)
        self.coalesce = int(config["coalesce"])
        self.quorum = int(config["replication_quorum"])
        # The replicated journal's follower view (``followers()``): each
        # follower's count of acknowledged records.
        self._followers = getattr(getattr(self.rt, "_journal", None),
                                  "followers", None)
        self.held_at: Dict[int, int] = {}
        self.closed = False

    def submit(self, batch) -> str:
        seq, times, feeds = batch
        return self.rt.submit(self.serving.EventBatch(seq, times, feeds)
                              ).status

    def poll(self):
        got = self.rt.poll(max_batches=self.coalesce)
        held = self.held()
        for d in got:
            self.held_at[d.seq] = held
        return [(d.seq, d.post, d.post_time, d.intensity) for d in got]

    def held(self) -> int:
        """Journal records acknowledged by at least ``quorum`` followers
        now (0 where the program shows no follower view)."""
        if self._followers is None:
            return 0
        acked = sorted((int(f["acked_batches"]) for f in self._followers()),
                       reverse=True)
        return acked[self.quorum - 1] if len(acked) >= self.quorum else 0

    @property
    def pending(self) -> int:
        return self.rt.pending

    def carry(self) -> Dict[str, np.ndarray]:
        from redqueen_tpu_torch.serving.state import state_to_numpy

        return state_to_numpy(self.rt.carry)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.dev))

    def close(self):
        if not self.closed:
            self.closed = True
            self.rt.close()


class Control:
    """The reference put in the service's place, every operation rounded
    to ``precision`` (the control runs it in bfloat16); it keeps no
    journal."""

    def __init__(self, config: Dict, n_feeds: int, seed: int, precision):
        self.coalesce = int(config["coalesce"])
        self.apply = ref.Apply(n_feeds, float(config["q"]),
                               float(config["s_sink"]), seed, precision)
        self.queue: List = []
        self.dir = None
        self.held_at: Dict[int, int] = {}

    def submit(self, batch) -> str:
        self.queue.append(batch)
        return "accepted"

    def poll(self):
        group = self.queue[:self.coalesce]
        del self.queue[:len(group)]
        return [self.apply.step(*b) for b in group]

    @property
    def pending(self) -> int:
        return len(self.queue)

    def carry(self):
        return self.apply.carry()

    def sync(self):
        pass

    def memory_peak(self) -> int:
        return 0

    def close(self):
        pass


def control(config: Dict, traffic: Dict, precision: str):
    """The control in the program's place, as ``run`` takes it: made
    once the run knows its feeds and its key."""
    return lambda n_feeds, key: Control(config, n_feeds, key, precision)


def run(ctx) -> Record:
    cfg, tr = ctx.config, ctx.traffic
    rec = Record("serve")
    n_feeds = int(tr["feeds"])
    rate = float(tr["rate_batches_per_s"])
    warm = int(tr["warmup_batches"])
    seconds = float(ctx.seconds)
    n_window = int(rate * (seconds + float(tr["trace_seconds"])) * 1.25) + 64
    batches = stream(ctx.seed, warm + n_window, n_feeds,
                     float(tr["events_per_batch"]), float(tr["batch_span"]))
    due = arrivals(ctx.seed, n_window, rate)
    key = int(seed_words(ctx.seed, 5)[0])
    d = tempfile.mkdtemp(prefix="portbench-serve-")
    try:
        svc = ctx.system(n_feeds, key) if ctx.system else Program(
            cfg, n_feeds, key, os.path.join(d, "serving"), ctx.device)
        try:
            return _drive(ctx, rec, svc, cfg, tr, batches, due, warm, key,
                          n_feeds, seconds)
        finally:
            svc.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _drive(ctx, rec, svc, cfg, tr, batches, due, warm, key, n_feeds,
           seconds) -> Record:
    decided: Dict[int, tuple] = {}

    # Warm-up: batches one at a time, then in whole groups.
    for i in range(warm):
        svc.submit(batches[i])
        if i < 8 or svc.pending >= int(cfg["coalesce"]):
            for r in svc.poll():
                decided[r[0]] = r
    while svc.pending:
        for r in svc.poll():
            decided[r[0]] = r
    svc.sync()

    tel = None
    if ctx.trace:
        from redqueen_tpu_torch.runtime import telemetry

        tel = telemetry.get()
        tel.configure(enabled=True, reset=True)
    n_due = int(np.searchsorted(due, seconds))
    probe = [host_probe_ms()]
    pauses = GcPauses()
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_process
    with pauses:
        failed, at, late, polls = _open_loop(svc, batches, warm, due, 0,
                                             n_due, t0, decided, None)
    window_end = time.perf_counter()
    probe.append(host_probe_ms())
    rec.notes.update(_poll_notes(polls, seconds), gc=pauses.notes(),
                     host_probe_ms=probe,
                     generator_late_ms=round(1e3 * late, 2))
    svc.sync()
    rec.memory_peak_bytes = svc.memory_peak()
    if tel is not None:
        rec.spans = tel.drain_spans()
        tel.configure(enabled=False, reset=True)
        # The device trace: the open loop goes on for ``trace_seconds``
        # more under the profiler, after the window, so that the
        # profiler's cost stays out of the window's numbers.
        trace, phases = DeviceTrace(ctx.device), Phases()
        n_end = int(np.searchsorted(
            due, due[n_due - 1] + float(tr["trace_seconds"])))
        trace.start()
        t1 = time.perf_counter() - due[n_due]
        _open_loop(svc, batches, warm, due, n_due, n_end, t1, decided,
                   phases)
        trace.stop()
        trace.collect()
        rec.trace, rec.phases = trace, phases

    lat = np.full(n_due, np.inf)
    for j in range(n_due):
        seq = warm + j
        if seq in at and not failed[j]:
            lat[j] = at[seq] - (t0 + due[j])
    rec.attempted = n_due
    rec.failed = int(np.sum(~np.isfinite(lat)))
    rec.values.update(latencies_s=lat, window_s=window_end - t0,
                      generator_late_s=late)
    carry = svc.carry()
    svc.close()

    # The comparison with the reference, once the window has closed.
    limits = tr["limits"]
    applied = sorted(decided)
    want, r_carry = ref.apply_stream(
        [batches[s] for s in applied], n_feeds, float(cfg["q"]),
        float(cfg["s_sink"]), key, "float32")
    got = np.array([decided[s] for s in applied], np.float64)
    # Per decision, the widest of: a post flag that differs (1), the gap
    # of its post time, and the gap of its intensity over max(1, the
    # reference's); a sound run reads each exactly.
    gaps = np.maximum.reduce([
        np.abs(got[:, 1] - want[:, 1]), np.abs(got[:, 2] - want[:, 2]),
        np.abs(got[:, 3] - want[:, 3]) / np.maximum(np.abs(want[:, 3]),
                                                    1.0)])
    rec.check("decision_gap", float(np.max(gaps, initial=0.0)), limits)
    rec.check("carry_mismatch", _carry_mismatch(carry, r_carry), limits)
    missing, early = _journal_checks(svc.dir, cfg, batches, decided,
                                     svc.held_at)
    rec.check("journal_missing", missing, limits)
    rec.check("quorum_late", early, limits)
    return rec


def _poll_notes(polls, seconds) -> Dict:
    """Diagnostics of the window's polls for standard error: how many,
    their batches, the median poll in each tenth of the window (a host
    that drifts shows there), and the five slowest."""
    if not polls:
        return {"polls": 0}
    start = np.array([p[0] for p in polls])
    ms = 1e3 * np.array([p[1] for p in polls])
    tenth = np.minimum((10 * start / seconds).astype(int), 9)
    slow = sorted(polls, key=lambda p: -p[1])[:5]
    return {"polls": len(polls),
            "batches_per_poll": round(float(np.mean([p[2] for p in polls])),
                                      2),
            "poll_ms_p50": round(float(np.median(ms)), 3),
            "poll_ms_p50_by_tenth": [
                round(float(np.median(ms[tenth == k])), 3)
                if np.any(tenth == k) else None for k in range(10)],
            "slowest_polls": [[round(a, 3), round(1e3 * b, 2), k]
                              for a, b, k in slow]}


def _open_loop(svc, batches, warm, due, lo, hi, t0, decided, phases):
    """Offer batches ``lo..hi-1`` of the window (stream index ``warm +
    j``, due at ``t0 + due[j]``) and collect their decisions, until all
    are decided or ``DRAIN_S`` past the last one's due time.  Returns
    ``(failed [hi - lo] bool, {seq: time returned}, how late the
    generator noticed a batch at worst)``."""
    failed = np.zeros(hi - lo, bool)
    at: Dict[int, float] = {}
    polls: List = []
    outbox: collections.deque = collections.deque()
    nxt, late = lo, 0.0
    give_up = t0 + (due[hi - 1] if hi > lo else 0.0) + DRAIN_S
    while True:
        now = time.perf_counter()
        if now > give_up:
            break
        while nxt < hi and t0 + due[nxt] <= now:
            outbox.append(nxt)
            late = max(late, now - (t0 + due[nxt]))
            nxt += 1
        with _mark(phases, "submit"):
            while outbox:
                status = svc.submit(batches[warm + outbox[0]])
                if status == "shed":
                    failed[outbox[0] - lo] = True
                    break
                if status == "rejected":
                    failed[outbox[0] - lo] = True
                outbox.popleft()
        if svc.pending:
            t_poll = time.perf_counter()
            with _mark(phases, "poll"):
                got = svc.poll()
            t_ret = time.perf_counter()
            polls.append((t_poll - t0, t_ret - t_poll, len(got)))
            for r in got:
                decided[r[0]] = r
                at[r[0]] = t_ret
            continue
        if nxt >= hi and not outbox:
            break
        if outbox:
            continue
        with _mark(phases, "idle"):
            wait = t0 + due[nxt] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
    return failed, at, late, polls


def _mark(phases, name):
    return phases.mark(name) if phases is not None else \
        contextlib.nullcontext()


def _carry_mismatch(got, want) -> int:
    """Elements of the final carry that differ from the reference's."""
    if got is None:
        return 1
    bad = int(np.sum(np.asarray(got["rank"], np.float64) != want["rank"]))
    bad += int(np.sum(np.asarray(got["health"], np.int64)
                      != want["health"]))
    for k in ("t", "seq", "n_batches", "n_events", "n_posts"):
        bad += int(float(got[k]) != float(want[k]))
    return bad


def _journal_checks(root, cfg, batches, decided, held_at):
    """``(missing, early)``.  ``missing``: decided batches not found, with
    their events and decision, in the leader's journal under ``root`` and
    in at least ``replication_quorum`` replicas (all of them, with no
    journal).  ``early``: decided batches whose decision was handed back
    while fewer than ``replication_quorum`` followers had acknowledged
    the leader's record that holds it (records count from 1 in the order
    written; all of them, with no journal or no watermark)."""
    if root is None:
        return len(decided), len(decided)
    leader = ref.read_journal(os.path.join(root, "journal.jsonl"))
    reps = [ref.read_journal(os.path.join(root, "replicas", f"replica{k}",
                                          "journal.jsonl"))
            for k in range(int(cfg["replication_factor"]))]
    quorum = int(cfg["replication_quorum"])

    def holds(j, seq):
        if seq not in j:
            return False
        times, feeds, dec, _ = j[seq]
        _, t_in, f_in = batches[seq]
        return (np.array_equal(times, t_in) and np.array_equal(feeds, f_in)
                and bool(dec["post"]) == bool(decided[seq][1])
                and float(dec["post_time"]) == float(decided[seq][2])
                and float(dec["intensity"]) == float(decided[seq][3]))

    missing = sum(1 for seq in decided
                  if not (holds(leader, seq)
                          and sum(holds(r, seq) for r in reps) >= quorum))
    early = sum(1 for seq in decided
                if seq not in leader or seq not in held_at
                or held_at[seq] < leader[seq][3])
    return missing, early
