"""Unified telemetry: structured spans, counters/histograms, and the
per-process flight-recorder ring — the port's copy of the JAX package's
``runtime.telemetry``, whole (same spans, schemas and summaries; a span
here also carries its start in integer nanoseconds, ``t_ns``).

Every diagnosis this repo has shipped — the 4000x sim-vs-serve gap, the
42ms/round worker-poll bottleneck, the 21x launch amortization — was
done with ad-hoc ``perf_counter`` pairs scattered through bench scripts.
This module is the ONE instrumentation layer behind all of them: the
serving hot path, the batch engines, and the learn solvers emit
**spans** (monotonic-clock intervals with parent ids and a trace id),
**events** (point annotations on the current span), and
**counters/histograms** through it, and ``tools/rqtrace.py`` renders the
where-did-the-time-go breakdown from the exported artifacts.

Design contract, in decreasing order of importance:

- **Near-zero cost when disabled.**  Tracing is off by default; a
  disabled ``span()``/``event()``/``counter()`` call is one attribute
  read, one branch, and a shared no-op singleton — no allocation
  survives the call (pinned by the zero-allocation test).  Hot paths
  therefore instrument unconditionally.
- **Monotonic spans, wall anchors.**  A span reads
  ``time.perf_counter_ns`` once at entry and once at exit; its start on
  the wall clock (``t_ns``, integer nanoseconds, with ``t`` in seconds
  derived from it) is the entry read plus an anchor, ``time.time_ns()
  - time.perf_counter_ns()``, taken when telemetry is enabled.  So spans
  from DIFFERENT processes order on one host, and they share
  ``torch.profiler``'s clock, whose records carry ``time.time_ns()``
  nanoseconds.  Under async dispatch a span around a device call
  measures *enqueue* time — the wait surfaces in the explicit ``*.sync``
  span at the device→host boundary (the same honesty rule RQ601 enforces
  on benchmarks).
- **Trace ids cross processes.**  ``context()`` exports the current
  ``{"tid", "sid"}``; ``attach(ctx)`` adopts it as the parent, so a
  request's spans stitch across the worker frame protocol and the
  socket transport (``serving.transport.attach_trace`` /
  ``extract_trace`` carry it in a reserved frame field).
- **The flight recorder survives SIGKILL.**  Finished spans (all but
  the scan engine's per-step ones) mirror into a fixed-size ring FILE
  of fixed-width slots (``os.pwrite``, no fsync — page-cache durability
  is exactly what a process kill preserves), so a SIGKILL'd worker
  leaves its last ~N spans as evidence.
  ``read_flight`` never raises: torn or stale slots are skipped.
- **Sampling is a trace-level decision.**  ``sample < 1`` keeps or
  drops WHOLE traces (deterministic hash of the trace id, so every
  process in a distributed trace agrees); counters/histograms are never
  sampled.
- **One histogram implementation.**  ``latency_percentiles`` (raw /
  trimmed / windowed p99 views) lives HERE; ``serving.metrics`` is a
  consumer, not a second definition.

Import-time dependencies are stdlib only (numpy loads lazily inside the
percentile math), so the module is safe in every torch-free context —
watchdog processes, the rqlint engine, a worker child before its shard
loads.

Artifacts export as enveloped ``rq.telemetry.trace/1`` via
``runtime.integrity`` (checksummed, atomic); ``python -m tools.rqtrace``
renders the per-stage breakdown and critical path from one or many.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

__all__ = [
    "TRACE_SCHEMA",
    "ENV_TRACE",
    "ENV_TRACE_SAMPLE",
    "ENV_TRACE_FLIGHT",
    "FLIGHT_FILENAME",
    "FLIGHT_SLOT_BYTES",
    "FLIGHT_DEFAULT_CAPACITY",
    "FLIGHT_SALVAGE_SPANS",
    "Telemetry",
    "FlightRecorder",
    "Histogram",
    "NULL_SPAN",
    "get",
    "configure",
    "span",
    "trace",
    "event",
    "counter",
    "observe",
    "context",
    "wire_context",
    "attach",
    "adopt_spans",
    "export_trace",
    "read_flight",
    "summarize",
    "latency_percentiles",
    "TRIM_FRACTION",
    "PCTL_WINDOW",
]

TRACE_SCHEMA = "rq.telemetry.trace/1"

#: ``RQ_TRACE=1`` enables the default telemetry instance at import-free
#: first use (inherited by spawned workers, so one env var traces the
#: whole process tree).
ENV_TRACE = "RQ_TRACE"
#: Trace sampling fraction in [0, 1]; whole traces are kept or dropped.
ENV_TRACE_SAMPLE = "RQ_TRACE_SAMPLE"
#: Path of the flight-recorder ring file (setting it implies enabled —
#: the supervisor's salvage contract: point a child here, read the ring
#: after it dies).
ENV_TRACE_FLIGHT = "RQ_TRACE_FLIGHT"

#: The on-disk ring filename inside a worker/shard directory — a
#: cross-layer contract: the worker child writes it, the cluster router
#: salvages it after a crash.
FLIGHT_FILENAME = "flight.ring"
#: Fixed slot width.  One serialized span must fit in ``slot - 1`` bytes
#: (the writer degrades detail — events first, then attrs — to fit);
#: fixed width is what makes a torn concurrent write skip-able instead
#: of poisoning every later slot.
FLIGHT_SLOT_BYTES = 768
FLIGHT_DEFAULT_CAPACITY = 256
#: How many salvaged ring spans a crash report RETAINS — the one
#: definition both salvage paths share (the cluster's per-shard
#: metrics block and the supervisor's RunReport attempts), so the two
#: never drift on how much evidence a dead child leaves behind.
FLIGHT_SALVAGE_SPANS = 32
#: Spans kept out of the flight ring: the scan engine's, one set a step
#: (four spans), which would push a dead child's superchunk and sync
#: spans, the ones that say where it stopped, out of its ring and its
#: salvage within a few steps.  The export buffer still records them.
_FLIGHT_UNMIRRORED = frozenset(
    {"scan.step", "scan.panel", "scan.fire", "scan.react"})

#: Export-buffer bound: completed spans kept in memory for export.
#: Bounded like every other long-lived ledger in the repo — a serving
#: process tracing for hours must not grow without bound; the artifact
#: flags the truncation via ``spans_dropped``.
MAX_BUFFERED_SPANS = 65536

# Trimmed/windowed percentile parameters (moved here from
# serving.metrics — see latency_percentiles): TRIM_FRACTION of the
# slowest samples is excluded from the *_trimmed view; the windowed view
# takes the MEDIAN of per-window p99s over windows of PCTL_WINDOW
# samples.
TRIM_FRACTION = 0.005
PCTL_WINDOW = 512


def latency_percentiles(latencies) -> Dict[str, Optional[float]]:
    """THE percentile definition (one implementation — serving's /1 and
    /2 ``decision_latency`` blocks and every telemetry histogram must
    never drift apart).

    Three views of the same samples, all committed so none can be
    quoted without the others:

    - **raw** p50/p99/max — the honest tail, IO-stall waves included;
    - **trimmed** p99 over the fastest ``1 - TRIM_FRACTION`` of samples
      — the tail with the top 0.5% outliers excluded;
    - **windowed** p99: the MEDIAN of per-window p99s (windows of
      ``PCTL_WINDOW`` samples).  IO-stall waves on a shared host
      land in a few windows and move a single global p99 by 10×
      run-to-run; the median-of-windows statistic is stable across
      runs while still a genuine 99th percentile within each window —
      the number to COMPARE across runs, never the number to hide the
      raw tail behind."""
    import numpy as np

    if not latencies:
        return {"p50_ms": None, "p99_ms": None, "max_ms": None,
                "p99_trimmed_ms": None, "p99_window_median_ms": None,
                "windows": 0}
    lat = np.asarray(latencies, np.float64)
    out = {
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
        "max_ms": round(float(lat.max()) * 1e3, 3),
    }
    keep = max(1, int(np.ceil(len(lat) * (1.0 - TRIM_FRACTION))))
    trimmed = np.sort(lat)[:keep]
    out["p99_trimmed_ms"] = round(
        float(np.percentile(trimmed, 99)) * 1e3, 3)
    n_win = max(1, len(lat) // PCTL_WINDOW)
    if n_win == 1:
        wins = [lat]  # fewer than two full windows: use every sample
    else:
        wins = [lat[i * PCTL_WINDOW:(i + 1) * PCTL_WINDOW]
                for i in range(n_win)]
        if len(lat) % PCTL_WINDOW:
            # the remainder merges into the last window — every sample
            # is in exactly one window, none silently dropped
            wins[-1] = lat[(n_win - 1) * PCTL_WINDOW:]
    p99s = [float(np.percentile(w, 99)) for w in wins if len(w)]
    out["p99_window_median_ms"] = round(
        float(np.median(p99s)) * 1e3, 3)
    out["windows"] = len(p99s)
    return out


class Histogram:
    """Bounded-window sample store with exact lifetime count/sum.  The
    window holds the most recent ``window`` observations (percentiles
    describe recent behavior; ``count``/``total`` stay exact for the
    process lifetime)."""

    __slots__ = ("samples", "count", "total")

    def __init__(self, window: int = 8192):
        import collections

        self.samples: Any = collections.deque(maxlen=int(window))
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.samples.append(v)
        self.count += 1
        self.total += v

    def percentiles(self) -> Dict[str, Optional[float]]:
        return latency_percentiles(self.samples)

    def report(self) -> Dict[str, Any]:
        out = {"count": self.count, "total": self.total,
               "window": len(self.samples)}
        out.update(self.percentiles())
        return out


# ---------------------------------------------------------------------------
# Flight recorder: the fixed-size on-disk ring
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Fixed-size ring of fixed-width slots on disk.  Slot 0 holds the
    meta record; span ``n`` (1-based write sequence) lands in slot
    ``1 + (n - 1) % capacity`` via one ``os.pwrite`` — no fsync, no
    locks beyond the owning telemetry instance's.  A SIGKILL at any
    instruction boundary leaves every completed pwrite readable (page
    cache survives the process); a machine-level crash may lose the
    tail, which is acceptable for a forensic ring."""

    def __init__(self, path: str,
                 capacity: int = FLIGHT_DEFAULT_CAPACITY,
                 slot_bytes: int = FLIGHT_SLOT_BYTES):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if int(slot_bytes) < 64:
            raise ValueError(
                f"slot_bytes must be >= 64, got {slot_bytes}")
        self.path = path
        self.capacity = int(capacity)
        self.slot = int(slot_bytes)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC,
                           0o644)
        self._n = 0
        self._write_slot(0, {"kind": "rq.flight/1", "slot": self.slot,
                             "capacity": self.capacity,
                             "pid": os.getpid()})

    def _write_slot(self, idx: int, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, separators=(",", ":")).encode("utf-8")
        if len(line) >= self.slot:
            return  # caller pre-fits spans; an unfittable meta is a bug
        data = line + b" " * (self.slot - 1 - len(line)) + b"\n"
        try:
            os.pwrite(self._fd, data, idx * self.slot)
        except OSError:
            pass  # forensics must never take the serving path down

    def record(self, span_dict: Dict[str, Any]) -> None:
        self._n += 1
        obj = dict(span_dict)
        obj["n"] = self._n
        # Degrade detail until the slot fits: full -> no events -> no
        # attrs -> skeleton.  A ring slot that dropped detail is still
        # evidence; a span silently skipped is not.
        for strip in ((), ("events",), ("events", "attrs")):
            trial = {k: v for k, v in obj.items() if k not in strip}
            if len(json.dumps(trial, separators=(",", ":"))
                   .encode("utf-8")) < self.slot:
                self._write_slot(1 + (self._n - 1) % self.capacity,
                                 trial)
                return
        self._write_slot(1 + (self._n - 1) % self.capacity,
                         {"n": self._n, "name": str(obj.get("name"))[:64],
                          "truncated": True})

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


def read_flight(path: str) -> List[Dict[str, Any]]:
    """Salvage a flight ring: every parseable span slot, oldest first
    (by write sequence ``n``).  Never raises — a missing file is ``[]``,
    torn or stale slots are skipped (fixed-width slots localize
    damage)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    if not data:
        return []
    # Slot width from the meta record when readable, default otherwise.
    slot = FLIGHT_SLOT_BYTES
    try:
        meta = json.loads(data[:data.index(b"\n")].decode("utf-8"))
        if isinstance(meta, dict) and int(meta.get("slot", 0)) >= 64:
            slot = int(meta["slot"])
    except (ValueError, KeyError, TypeError):
        pass
    out = []
    for at in range(slot, len(data), slot):
        chunk = data[at:at + slot].strip(b"\x00 \n")
        if not chunk:
            continue
        try:
            obj = json.loads(chunk.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue  # torn slot: skip, keep salvaging
        if isinstance(obj, dict) and "n" in obj:
            out.append(obj)
    out.sort(key=lambda o: int(o.get("n", 0)))
    return out


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """The shared no-op span/scope: every disabled-path call returns
    THIS singleton, so the disabled cost is one branch and zero
    allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self


NULL_SPAN = _NullSpan()

#: Context-stack sentinel for an UNSAMPLED trace: children must also be
#: dropped (and must not start fresh root traces of their own).
_UNSAMPLED = ("", -1)


class _Span:
    """A live span.  Context-manager protocol: ``__enter__`` stamps the
    clocks and pushes (tid, sid) onto the thread-local context stack;
    ``__exit__`` pops, computes the duration, and hands the finished
    record to the owning telemetry instance."""

    __slots__ = ("_tel", "name", "tid", "parent", "sid", "attrs",
                 "events", "_t0", "t_ns", "dur_raw")

    def __init__(self, tel: "Telemetry", name: str, tid: str,
                 parent: Optional[int], attrs: Optional[Dict[str, Any]]):
        self._tel = tel
        self.name = name
        self.tid = tid
        self.parent = parent
        self.sid = 0
        self.attrs = attrs or None
        self.events: Optional[List[Any]] = None
        self._t0 = 0       # monotonic entry read
        self.t_ns = 0      # entry on the wall clock, set at exit
        self.dur_raw = 0   # in the clock's unit

    def __enter__(self):
        tel = self._tel
        self.sid = next(tel._sid)
        tel._stack().append((self.tid, self.sid))
        if tel._clock_s is not None:
            self.t_ns = time.time_ns()
            self._t0 = tel._clock_s()
        else:
            self._t0 = tel._clock()
        return self

    def __exit__(self, et, ev, tb):
        tel = self._tel
        if tel._clock_s is not None:
            self.dur_raw = tel._clock_s() - self._t0
        else:
            self.dur_raw = tel._clock() - self._t0
            self.t_ns = self._t0 + tel._anchor_ns
        stack = tel._stack()
        if stack and stack[-1] == (self.tid, self.sid):
            stack.pop()
        if et is not None:
            self.set(error=et.__name__)
        tel._finish(self)
        return False

    def set(self, **attrs):
        """Attach/overwrite attributes on this span."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def event(self, name, **attrs):
        """Point annotation at the current offset into this span."""
        if self.events is None:
            self.events = []
        tel = self._tel
        off = (tel._clock_s() - self._t0 if tel._clock_s is not None
               else (tel._clock() - self._t0) / 1e9)
        self.events.append([str(name), round(off, 9), attrs or None])
        return self

    def _dur_s(self) -> float:
        if self._tel._clock_s is not None:
            return self.dur_raw
        return self.dur_raw / 1e9

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"tid": self.tid, "sid": self.sid,
                             "name": self.name,
                             "t": round(self.t_ns / 1e9, 6),
                             "t_ns": self.t_ns,
                             "dur": round(self._dur_s(), 9),
                             "pid": self._tel._pid}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = self.events
        return d


class _Scope:
    """Context-stack push/pop without a recorded span — the body of an
    unsampled trace (children see ``_UNSAMPLED`` and drop) and the
    remote-context adoption (children chain under the remote parent)."""

    __slots__ = ("_tel", "_entry")

    def __init__(self, tel: "Telemetry", entry):
        self._tel = tel
        self._entry = entry

    def __enter__(self):
        self._tel._stack().append(self._entry)
        return NULL_SPAN if self._entry is _UNSAMPLED else self

    def __exit__(self, *exc):
        stack = self._tel._stack()
        if stack and stack[-1] is self._entry:
            stack.pop()
        elif self._entry in stack:
            stack.remove(self._entry)
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self


# ---------------------------------------------------------------------------
# The telemetry instance
# ---------------------------------------------------------------------------


class Telemetry:
    """One process's telemetry state: enabled flag, sampling knob, the
    span buffer, counters/histograms, the thread-local context stack,
    and (optionally) the flight-recorder ring.  The module-level
    functions drive one env-configured default instance; tests build
    their own."""

    def __init__(self, enabled: bool = False, sample: float = 1.0,
                 flight: Optional[str] = None,
                 flight_capacity: int = FLIGHT_DEFAULT_CAPACITY,
                 max_spans: int = MAX_BUFFERED_SPANS,
                 clock=None):
        self._lock = threading.Lock()
        # ``clock`` is the reference's: a monotonic clock in seconds,
        # which a span reads at entry and exit (its start on the wall
        # clock is then ``time.time_ns()`` at entry).  By default the
        # spans read integer nanoseconds and anchor them to the wall.
        self._clock_s = clock
        self._clock = time.perf_counter_ns
        self._anchor_ns = 0
        self._pid = os.getpid()
        # Span ids must be unique across PROCESSES within one trace (a
        # worker span's parent is a router sid): a plain 1-based counter
        # collides the instant two processes join a trace — and a span
        # whose (tid, sid) equals its parent's reads as a cycle.  Base
        # the counter in a random 32-bit block (shifted to keep every
        # sid under 2^53 — exact in any double-based JSON reader); one
        # process exhausting its 2^20 block before colliding with
        # another's random block is astronomically unlikely.
        self._sid = itertools.count(
            (int.from_bytes(os.urandom(4), "big") << 20) + 1)
        self._tid_n = itertools.count(1)
        self._tid_prefix = f"{self._pid:x}-{os.urandom(4).hex()}-"
        self._local = threading.local()
        self._flight: Optional[FlightRecorder] = None
        self.enabled = False
        self.sample = 1.0
        # Finished spans: _Span objects (hot path) and/or adopted dicts
        # (salvage) — materialized to dicts by _materialize at read
        # time, never on the recording path.
        self.spans: List[Any] = []
        self.spans_dropped = 0
        self.counters: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.max_spans = int(max_spans)
        self.configure(enabled=enabled, sample=sample, flight=flight,
                       flight_capacity=flight_capacity)

    # -- configuration --

    def configure(self, enabled: Optional[bool] = None,
                  sample: Optional[float] = None,
                  flight: Optional[str] = None,
                  flight_capacity: Optional[int] = None,
                  max_spans: Optional[int] = None,
                  reset: bool = False) -> "Telemetry":
        """Re-point the instance (tests, bench phases).  ``reset`` drops
        buffered spans/counters/histograms; ``flight`` replaces the ring
        (closing the previous one)."""
        with self._lock:
            if reset:
                self.spans = []
                self.spans_dropped = 0
                self.counters = {}
                self.histograms = {}
            if max_spans is not None:
                self.max_spans = int(max_spans)
            if enabled is not None:
                self.enabled = bool(enabled)
            if sample is not None:
                s = float(sample)
                if not 0.0 <= s <= 1.0:
                    raise ValueError(
                        f"sample must be in [0, 1], got {sample!r}")
                self.sample = s
            if flight is not None:
                if self._flight is not None:
                    self._flight.close()
                cap = (FLIGHT_DEFAULT_CAPACITY if flight_capacity is None
                       else int(flight_capacity))
                self._flight = FlightRecorder(flight, capacity=cap)
                self.enabled = True  # a ring without spans records nothing
            if self.enabled:
                # Spans' starts on the wall clock: t_ns = entry + anchor.
                self._anchor_ns = time.time_ns() - self._clock()
        return self

    def configure_from_env(self) -> "Telemetry":
        flight = os.environ.get(ENV_TRACE_FLIGHT) or None
        enabled = (os.environ.get(ENV_TRACE, "") not in ("", "0")
                   or flight is not None)
        sample = float(os.environ.get(ENV_TRACE_SAMPLE, "1.0") or 1.0)
        return self.configure(enabled=enabled, sample=sample,
                              flight=flight)

    @property
    def flight_path(self) -> Optional[str]:
        return None if self._flight is None else self._flight.path

    # -- context plumbing --

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_tid(self) -> str:
        # One urandom syscall per PROCESS (the prefix), not per trace:
        # a root span is hot-path in the serving drive loop, and the
        # syscall was the measured cost of trace creation.
        return f"{self._tid_prefix}{next(self._tid_n):x}"

    def _sampled(self, tid: str) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = zlib.crc32(tid.encode("utf-8")) & 0xFFFFFFFF
        return h < self.sample * 4294967296.0

    # -- the hot-path API --

    def span(self, name: str, **attrs):
        """A child span of the current context (a fresh root trace when
        there is none).  Returns the shared no-op singleton when
        disabled or inside an unsampled trace."""
        if not self.enabled:
            return NULL_SPAN
        stack = self._stack()
        if not stack:
            return self.trace(name, **attrs)
        cur = stack[-1]
        if cur is _UNSAMPLED:
            return NULL_SPAN
        return _Span(self, name, cur[0], cur[1], attrs or None)

    def trace(self, name: str, trace_id: Optional[str] = None, **attrs):
        """A ROOT span starting (or adopting) a trace id — the sampling
        decision point.  An unsampled trace returns a scope that
        suppresses every span beneath it (so a sampled-out request costs
        a push/pop, not a partial trace)."""
        if not self.enabled:
            return NULL_SPAN
        tid = trace_id if trace_id is not None else self._new_tid()
        if not self._sampled(tid):
            return _Scope(self, _UNSAMPLED)
        return _Span(self, name, tid, None, attrs or None)

    def attach(self, ctx: Optional[Dict[str, Any]]):
        """Adopt a REMOTE context (from :meth:`wire_context` /
        :meth:`context` on the other side): spans opened inside the
        scope chain under the remote parent, stitching one request's
        spans across processes.  A ``{"drop": 1}`` marker — the sender
        is inside a sampled-OUT trace — suppresses the subtree here
        too, keeping the sampling decision trace-global.  No-op scope
        when disabled or ``ctx`` is falsy/malformed."""
        if not self.enabled or not ctx or not isinstance(ctx, dict):
            return NULL_SPAN
        if ctx.get("drop"):
            return _Scope(self, _UNSAMPLED)
        try:
            entry = (str(ctx["tid"]), int(ctx["sid"]))
        except (KeyError, TypeError, ValueError):
            return NULL_SPAN
        return _Scope(self, entry)

    def context(self) -> Optional[Dict[str, Any]]:
        """The current propagation context, or None (disabled, no span
        open, or inside an unsampled trace — the receiver then records
        nothing either, keeping the sampling decision trace-global)."""
        if not self.enabled:
            return None
        stack = self._stack()
        if not stack or stack[-1] is _UNSAMPLED:
            return None
        tid, sid = stack[-1]
        return {"tid": tid, "sid": sid}

    def wire_context(self) -> Optional[Dict[str, Any]]:
        """What an outgoing FRAME should carry: the live context, the
        explicit ``{"drop": 1}`` marker inside an unsampled trace (so
        the receiver drops the subtree instead of minting orphan root
        traces of its own), or None when there is simply no trace to
        propagate (the receiver's own tracing policy then applies)."""
        if not self.enabled:
            return None
        stack = self._stack()
        if not stack:
            return None
        if stack[-1] is _UNSAMPLED:
            return {"drop": 1}
        tid, sid = stack[-1]
        return {"tid": tid, "sid": sid}

    def event(self, name: str, **attrs):
        """A point annotation, recorded as a zero-duration span: a
        child of the current span when one is open, else a root of its
        own (sampling applies) — provenance events (engine dispatch
        choice, VMEM plan) must reach the trace even from a directly-
        traced call with no enclosing span.  Dropped only inside an
        unsampled trace."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack:
            cur = stack[-1]
            if cur is _UNSAMPLED:
                return
            tid, parent = cur
        else:
            tid = self._new_tid()
            if not self._sampled(tid):
                return
            parent = None
        s = _Span(self, name, tid, parent, attrs or None)
        s.sid = next(self._sid)
        if self._clock_s is not None:
            s._t0 = self._clock_s()
            s.t_ns = time.time_ns()
        else:
            s._t0 = self._clock()
            s.t_ns = s._t0 + self._anchor_ns
        self._finish(s)

    def counter(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, name: str, value: Optional[float],
                window: int = 8192) -> None:
        """One histogram observation (None values are dropped — callers
        pass optional latencies straight through)."""
        if not self.enabled or value is None:
            return
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(window=window)
            h.observe(value)

    # -- record keeping --

    def _finish(self, s: _Span) -> None:
        # The per-span hot path: the buffer holds the span OBJECT
        # (dict materialization is deferred to export/read time — it
        # was the measured majority of the per-span cost), and
        # list.append is GIL-atomic, so the lock is paid only when a
        # flight ring is mirroring (its seq counter needs the mutual
        # exclusion — and the ring needs the dict NOW: a SIGKILL won't
        # wait for an export).
        if len(self.spans) < self.max_spans:
            self.spans.append(s)
        else:
            # COLD path (buffer already full): the += is a non-atomic
            # read-modify-write, and spans finish on every thread (the
            # journal flusher among them) — unlocked, concurrent drops
            # under-count and the truncation flag lies.  The hot path
            # above stays lock-free.
            with self._lock:
                self.spans_dropped += 1
        if self._flight is not None and s.name not in _FLIGHT_UNMIRRORED:
            with self._lock:
                if self._flight is not None:
                    self._flight.record(s.to_dict())

    def adopt_spans(self, spans: List[Dict[str, Any]]) -> int:
        """Append span dicts recorded by ANOTHER process (a salvaged
        flight ring, a worker's telemetry response) into this buffer so
        one export stitches the distributed trace.  Returns how many
        were adopted (malformed entries are skipped, never raised)."""
        n = 0
        with self._lock:
            for s in spans:
                if not (isinstance(s, dict) and "name" in s
                        and "tid" in s and "sid" in s):
                    continue
                if len(self.spans) < self.max_spans:
                    self.spans.append({k: v for k, v in s.items()
                                       if k != "n"})
                    n += 1
                else:
                    self.spans_dropped += 1
        return n

    @staticmethod
    def _materialize(spans: List[Any]) -> List[Dict[str, Any]]:
        return [s.to_dict() if isinstance(s, _Span) else s
                for s in spans]

    def drain_spans(self) -> List[Dict[str, Any]]:
        """Snapshot + clear the span buffer as dicts (counters and
        histograms stay)."""
        with self._lock:
            out, self.spans = self.spans, []
        return self._materialize(out)

    def recent_spans(self, limit: int = 512) -> List[Dict[str, Any]]:
        """The most recent ``limit`` finished spans as dicts (the
        worker-protocol ``telemetry`` op's read)."""
        if int(limit) <= 0:
            return []  # [-0:] would slice the WHOLE buffer
        with self._lock:
            tail = list(self.spans[-int(limit):])
        return self._materialize(tail)

    # -- export --

    def payload(self, extra: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        with self._lock:
            snap = list(self.spans)
            out: Dict[str, Any] = {
                "process": {"pid": self._pid,
                            "sample": self.sample},
                "n_spans": len(snap),
                "spans_dropped": self.spans_dropped,
                "counters": dict(self.counters),
                "histograms": {k: h.report()
                               for k, h in self.histograms.items()},
            }
        out["spans"] = self._materialize(snap)
        if extra:
            out.update(extra)
        return out

    def export(self, path: Optional[str] = None,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The ``rq.telemetry.trace/1`` artifact (enveloped + atomic via
        ``runtime.integrity``); returns the payload."""
        payload = self.payload(extra=extra)
        if path is not None:
            from . import integrity as _integrity

            _integrity.write_json(path, payload, schema=TRACE_SCHEMA)
        return payload

    def close(self) -> None:
        if self._flight is not None:
            self._flight.close()
            self._flight = None


# ---------------------------------------------------------------------------
# The default instance + module-level API (what hot paths import)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Telemetry] = None
_GLOBAL_LOCK = threading.Lock()


def get() -> Telemetry:
    """The process-default instance, env-configured on first touch."""
    global _GLOBAL
    t = _GLOBAL
    if t is None:
        with _GLOBAL_LOCK:
            t = _GLOBAL
            if t is None:
                t = Telemetry()
                t.configure_from_env()
                _GLOBAL = t
    return t


def configure(**kw) -> Telemetry:
    """Configure the default instance (see :meth:`Telemetry.configure`)."""
    return get().configure(**kw)


def span(name: str, **attrs):
    t = _GLOBAL
    return (t if t is not None else get()).span(name, **attrs)


def trace(name: str, trace_id: Optional[str] = None, **attrs):
    t = _GLOBAL
    return (t if t is not None else get()).trace(name, trace_id, **attrs)


def event(name: str, **attrs) -> None:
    t = _GLOBAL
    (t if t is not None else get()).event(name, **attrs)


def counter(name: str, n: float = 1) -> None:
    t = _GLOBAL
    (t if t is not None else get()).counter(name, n)


def observe(name: str, value: Optional[float]) -> None:
    t = _GLOBAL
    (t if t is not None else get()).observe(name, value)


def context() -> Optional[Dict[str, Any]]:
    t = _GLOBAL
    return (t if t is not None else get()).context()


def wire_context() -> Optional[Dict[str, Any]]:
    t = _GLOBAL
    return (t if t is not None else get()).wire_context()


def attach(ctx: Optional[Dict[str, Any]]):
    t = _GLOBAL
    return (t if t is not None else get()).attach(ctx)


def adopt_spans(spans: List[Dict[str, Any]]) -> int:
    t = _GLOBAL
    return (t if t is not None else get()).adopt_spans(spans)


def export_trace(path: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    t = _GLOBAL
    return (t if t is not None else get()).export(path, extra=extra)


# ---------------------------------------------------------------------------
# Analysis: the where-did-the-time-go breakdown (shared by tools/rqtrace
# and the bench stage_breakdown blocks — ONE aggregation definition)
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (stdlib-only: the
    rqtrace CLI must not require numpy for a quick terminal read)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def summarize(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a span set into the per-stage time breakdown:

    - ``stages``: per span NAME — count, total time, SELF time (total
      minus direct children), share of root wall time, p50/p99 of the
      individual durations;
    - ``wall_s``: summed duration of the ROOT spans (parent absent or
      unresolvable — salvaged orphans count as roots);
    - ``coverage``: the fraction of root wall time inside named child
      stages — the "does the instrumentation account for the time"
      number (the serving-bench acceptance gate requires >= 0.9);
    - ``critical_path``: from the single longest root, the chain of
      largest-child descents with each hop's share of the root.

    Roots are assumed sequential within a process (the bench/serving
    drive loops); concurrent multi-process traces aggregate per-stage
    totals correctly but ``wall_s`` is then a sum of per-root walls,
    not an elapsed interval — documented, not guessed at."""
    by_id: Dict[Any, Dict[str, Any]] = {}
    for s in spans:
        by_id[(s.get("tid"), s.get("sid"))] = s
    children: Dict[Any, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for s in spans:
        p = s.get("parent")
        key = (s.get("tid"), p)
        # A self-parenting span (corrupt data, or colliding ids from a
        # pre-unique-sid writer) must not become a cycle: treat it as a
        # root instead of its own child.
        if p is not None and key in by_id and p != s.get("sid"):
            children.setdefault(key, []).append(s)
        else:
            roots.append(s)

    def kid_dur(s) -> float:
        return sum(float(c.get("dur", 0.0))
                   for c in children.get((s.get("tid"), s.get("sid")), ()))

    stages: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        dur = float(s.get("dur", 0.0))
        st = stages.setdefault(str(s.get("name")), {
            "count": 0, "total_s": 0.0, "self_s": 0.0, "_durs": []})
        st["count"] += 1
        st["total_s"] += dur
        st["self_s"] += max(dur - kid_dur(s), 0.0)
        st["_durs"].append(dur)
    wall = sum(float(r.get("dur", 0.0)) for r in roots)
    covered = sum(kid_dur(r) for r in roots)
    for name, st in stages.items():
        durs = sorted(st.pop("_durs"))
        st["total_s"] = round(st["total_s"], 6)
        st["self_s"] = round(st["self_s"], 6)
        st["pct_of_wall"] = (round(100.0 * st["total_s"] / wall, 2)
                             if wall > 0 else None)
        st["p50_ms"] = round(_percentile(durs, 50) * 1e3, 4)
        st["p99_ms"] = round(_percentile(durs, 99) * 1e3, 4)
    # Critical path: greedy largest-child descent from the longest
    # root.  The visited set is the cycle backstop — an analysis tool
    # must never hang on adversarial span data.
    path = []
    if roots:
        node = max(roots, key=lambda r: float(r.get("dur", 0.0)))
        root_dur = max(float(node.get("dur", 0.0)), 1e-12)
        visited = set()
        while node is not None and id(node) not in visited:
            visited.add(id(node))
            path.append({
                "name": str(node.get("name")),
                "dur_s": round(float(node.get("dur", 0.0)), 6),
                "pct_of_root": round(
                    100.0 * float(node.get("dur", 0.0)) / root_dur, 2),
            })
            kids = children.get((node.get("tid"), node.get("sid")))
            node = (max(kids, key=lambda c: float(c.get("dur", 0.0)))
                    if kids else None)
    return {
        "n_spans": len(spans),
        "n_roots": len(roots),
        "wall_s": round(wall, 6),
        "coverage": (round(min(covered / wall, 1.0), 4)
                     if wall > 0 else None),
        "stages": dict(sorted(stages.items(),
                              key=lambda kv: -kv[1]["total_s"])),
        "critical_path": path,
    }
