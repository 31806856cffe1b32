"""Supervised, deadline-bounded execution with retry, backoff and a
recorded CUDA to CPU degradation: the counterpart of
``redqueen_tpu.runtime.supervisor``, the execution layer of the port's
sweeps and experiments.

- :class:`Supervisor` / :func:`run_resilient` run a target (an argv
  command or a picklable callable) in a SUBPROCESS under a wall-clock
  deadline and an optional heartbeat-staleness bound (an in-process
  ``try`` cannot catch a hang), classify every failure (timeout, crash,
  transient, OOM, error), retry with exponential backoff and seedable
  jitter, and, where allowed, degrade to the CPU when the failure
  implicates the card.  Every attempt, backoff and degradation lands in
  a :class:`RunReport`; ``backend_used`` reads ``"cuda"`` or ``"cpu"``,
  so a CPU run never passes as a card run.
- :func:`supervised_run` is the one-shot argv form (rc 124 on a timeout,
  the partial stdout kept, a durable capture log).
- :func:`probe_backend` / :func:`backend_alive` / :func:`ensure_backend`
  put ``utils.backend``'s liveness policy behind the runtime API.

Stated differences from the JAX package: ``backend="default"`` means the
card; a degraded child runs with ``RQ_BACKEND=cpu`` only (no
``JAX_PLATFORMS``), and the port's :func:`ensure_backend` then returns
``"cpu"`` for the caller to pass as ``device=`` and sets nothing.  A
callable target is pickled into a fresh interpreter that imports
``redqueen_tpu_torch``.  Failure paths run deterministically through
``runtime.faultinject``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from . import faultinject
from .artifacts import atomic_write_json, atomic_write_text

__all__ = [
    "RetryPolicy",
    "Attempt",
    "RunReport",
    "Supervisor",
    "SupervisorError",
    "run_resilient",
    "supervised_run",
    "heartbeat",
    "probe_backend",
    "backend_alive",
    "ensure_backend",
    "ENV_HEARTBEAT",
    "ENV_BACKEND",
    "ENV_SUPERVISED",
]

# Env contract between the supervisor and its children.
ENV_HEARTBEAT = "RQ_HEARTBEAT_FILE"   # child touches this to prove progress
ENV_BACKEND = "RQ_BACKEND"            # "cpu" after degradation
ENV_SUPERVISED = "RQ_SUPERVISED"      # "1" inside any supervised child

# Attempt outcomes.
OK = "ok"
TIMEOUT = "timeout"        # wall deadline or stale heartbeat -> killed
CRASH = "crash"            # nonzero exit, no recognized failure marker
TRANSIENT = "transient"    # child said retry-me (TransientError marker)
OOM = "oom"                # resource exhaustion marker
ERROR = "error"            # child raised a non-transient, non-OOM error

_STREAM_TAIL = 2000  # chars of each stream kept in the JSON report


def _stderr_log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def heartbeat() -> None:
    """Touch the supervisor-provided heartbeat file (no-op when not
    supervised).  Long-running children call this at progress points —
    e.g. the chunked sweep after each landed chunk — so the supervisor's
    staleness bound can tell 'slow but alive' from 'wedged'."""
    path = os.environ.get(ENV_HEARTBEAT)
    if not path:
        return
    try:
        with open(path, "w") as f:
            f.write(f"{time.time():.3f}\n")
    except OSError:
        pass


# --------------------------------------------------------------------------
# Policy / report records
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter.  ``seed`` makes the jitter — and with
    it the whole backoff schedule — deterministic for tests; None draws
    from the process RNG.  ``delay(n)`` is the sleep after the n-th failed
    attempt (1-based): ``base * multiplier**(n-1)``, capped, then
    stretched by up to ``jitter`` fraction."""

    max_attempts: int = 3
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 60.0
    jitter: float = 0.5
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")

    def rng(self) -> random.Random:
        return random.Random(self.seed)

    def delay(self, failed_attempt: int, rng: random.Random) -> float:
        base = min(self.base_delay_s * self.multiplier ** (failed_attempt - 1),
                   self.max_delay_s)
        if self.jitter > 0:
            base *= 1.0 + self.jitter * rng.random()
        return base

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Attempt:
    """One supervised execution of the target.  Full streams stay
    in-memory only; the JSON report carries bounded tails."""

    index: int
    backend: str
    deadline_s: float
    outcome: str = ""
    returncode: Optional[int] = None
    wall_s: float = 0.0
    detail: str = ""
    backoff_s: Optional[float] = None  # sleep applied AFTER this attempt
    stdout: str = dataclasses.field(default="", repr=False)
    stderr: str = dataclasses.field(default="", repr=False)
    # Flight-recorder salvage (Supervisor(flight_path=...)): the failed
    # child's last spans, read from its on-disk ring — evidence a
    # SIGKILL/timeout cannot erase.  Bounded like the stream tails.
    flight: list = dataclasses.field(default_factory=list, repr=False)

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in
             ("index", "backend", "deadline_s", "outcome", "returncode",
              "wall_s", "detail", "backoff_s")}
        d["stdout_tail"] = self.stdout[-_STREAM_TAIL:]
        d["stderr_tail"] = self.stderr[-_STREAM_TAIL:]
        if self.flight:
            d["flight_spans"] = list(self.flight)
        return d


@dataclasses.dataclass
class RunReport:
    """The structured per-run artifact: every attempt, the backoff
    schedule actually slept, every degradation, and the final
    disposition.  ``backend_used`` is the backend of the attempt that
    produced ``result`` (or of the last attempt on failure)."""

    name: str
    target: str
    backend_requested: str
    retry_policy: dict
    ok: bool = False
    disposition: str = "failed"          # "ok" | "failed"
    failure_kind: Optional[str] = None   # outcome of the fatal attempt
    backend_used: Optional[str] = None
    degraded: bool = False
    degradations: List[dict] = dataclasses.field(default_factory=list)
    attempts: List[Attempt] = dataclasses.field(default_factory=list)
    result: Any = None
    total_wall_s: float = 0.0
    report_path: Optional[str] = None

    @property
    def backoff_schedule(self) -> List[float]:
        return [a.backoff_s for a in self.attempts if a.backoff_s is not None]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "target": self.target,
            "ok": self.ok,
            "disposition": self.disposition,
            "failure_kind": self.failure_kind,
            "backend_requested": self.backend_requested,
            "backend_used": self.backend_used,
            "degraded": self.degraded,
            "degradations": self.degradations,
            "retry_policy": self.retry_policy,
            "n_attempts": len(self.attempts),
            "attempts": [a.to_dict() for a in self.attempts],
            "backoff_schedule_s": self.backoff_schedule,
            "result": _jsonable(self.result),
            "total_wall_s": round(self.total_wall_s, 3),
        }

    def write(self, path: str) -> str:
        atomic_write_json(path, self.to_dict(), indent=1)
        self.report_path = path
        return path


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        return repr(x)


class SupervisorError(RuntimeError):
    """All attempts exhausted; carries the full report."""

    def __init__(self, report: RunReport):
        self.report = report
        a = report.attempts[-1] if report.attempts else None
        detail = f": {a.detail}" if a and a.detail else ""
        super().__init__(
            f"supervised run {report.name!r} failed "
            f"({report.failure_kind}) after {len(report.attempts)} "
            f"attempt(s){detail}"
        )


# --------------------------------------------------------------------------
# Low-level attempt runners (one subprocess each, deadline + heartbeat)
# --------------------------------------------------------------------------

def _check_hang(t0: float, deadline_s: float, hb_path: Optional[str],
                heartbeat_timeout_s: Optional[float]) -> Optional[str]:
    """Reason string when the child must be declared hung, else None."""
    now = time.monotonic()
    if now - t0 > deadline_s:
        return f"wall deadline {deadline_s:.1f}s exceeded"
    if heartbeat_timeout_s and hb_path and os.path.exists(hb_path):
        stale = time.time() - os.path.getmtime(hb_path)
        if stale > heartbeat_timeout_s:
            return (f"heartbeat stale {stale:.1f}s > "
                    f"{heartbeat_timeout_s:.1f}s bound")
    return None


def _popen_capture(cmd: Sequence[str], deadline_s: float, env: dict,
                   cwd: Optional[str], hb_path: Optional[str],
                   poll_s: float, heartbeat_timeout_s: Optional[float],
                   ) -> Tuple[int, str, str, float, str]:
    """Run argv under the deadline/heartbeat watch.  Returns
    ``(rc, stdout, stderr, wall_s, hang_reason)`` with rc=124 and the
    PARTIAL stdout preserved on a kill — a child that printed its result
    line before wedging must not lose it (bench.py's whole protocol)."""
    t0 = time.monotonic()
    p = subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)
    hang = ""
    while True:
        try:
            out, err = p.communicate(timeout=poll_s)
            break
        except subprocess.TimeoutExpired:
            reason = _check_hang(t0, deadline_s, hb_path, heartbeat_timeout_s)
            if reason is not None:
                hang = reason
                p.kill()
                out, err = p.communicate()
                break
    wall = time.monotonic() - t0
    rc = 124 if hang else p.returncode
    return rc, out or "", err or "", wall, hang


def _child_call(fn: Callable, args: tuple, kwargs: dict,
                result_path: str) -> None:
    """Spawned-child wrapper around a callable target: heartbeat once,
    apply any env-configured fault, run, and leave a JSON verdict the
    supervisor classifies from (exceptions don't cross process
    boundaries; this file does)."""
    heartbeat()
    try:
        faultinject.maybe_inject("start")
        value = fn(*args, **(kwargs or {}))
        atomic_write_json(result_path, {"ok": True, "value": _jsonable(value)})
    except BaseException as e:  # noqa: BLE001 — classified by the parent
        atomic_write_json(result_path, {
            "ok": False,
            "error": type(e).__name__,
            "message": str(e),
            "transient": isinstance(e, faultinject.TransientError),
            "oom": any(m in str(e) for m in faultinject.OOM_MARKERS),
        })
        raise


def _run_callable(fn: Callable, args: tuple, kwargs: dict, deadline_s: float,
                  extra_env: dict, hb_path: str, poll_s: float,
                  heartbeat_timeout_s: Optional[float],
                  ) -> Tuple[Optional[int], Optional[dict], float, str]:
    """Run a picklable callable in a spawned process (spawn, not fork:
    a forked child sharing an initialized CUDA context is exactly the
    state-corruption this layer exists to avoid).  Returns
    ``(exitcode, verdict_dict_or_None, wall_s, hang_reason)``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    fd, result_path = tempfile.mkstemp(prefix="rq_result_", suffix=".json")
    os.close(fd)
    os.remove(result_path)  # child creates it atomically
    saved = {k: os.environ.get(k) for k in extra_env}
    os.environ.update(extra_env)  # spawn child inherits os.environ
    t0 = time.monotonic()
    hang = ""
    try:
        p = ctx.Process(target=_child_call, args=(fn, args, kwargs or {},
                                                  result_path))
        p.start()
        while True:
            p.join(poll_s)
            if p.exitcode is not None:
                break
            reason = _check_hang(t0, deadline_s, hb_path, heartbeat_timeout_s)
            if reason is not None:
                hang = reason
                p.terminate()
                p.join(5.0)
                if p.exitcode is None:
                    p.kill()
                    p.join()
                break
        exitcode = p.exitcode
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.monotonic() - t0
    verdict = None
    if os.path.exists(result_path):
        try:
            with open(result_path) as f:
                verdict = json.load(f)
        except (OSError, ValueError):
            verdict = None
        finally:
            os.remove(result_path)
    return exitcode, verdict, wall, hang


def _backend_used(backend: str, value) -> str:
    """What an attempt on ``backend`` ran on.  A degraded (or forced)
    attempt is a CPU run whatever its child says; otherwise the child's
    ``"platform"`` (``"cuda"`` or ``"cpu"``) where it reports one, and
    the requested backend, unconfirmed, where it does not (the JAX
    package's rule): a card run is named only on the child's word."""
    if backend == "cpu":
        return "cpu"
    if isinstance(value, dict) and value.get("platform") in ("cuda", "cpu"):
        return value["platform"]
    return backend


# --------------------------------------------------------------------------
# The supervisor
# --------------------------------------------------------------------------

_SEQ = {"n": 0}


class Supervisor:
    """Policy container + dispatcher.  One instance may supervise many
    runs; each ``run()`` produces one :class:`RunReport` (and one JSON
    artifact when ``report_dir`` is set).

    ``backend`` is the backend the run WANTS ("default" = the card;
    "cpu" = forced CPU).  On failures in ``degrade_on`` (default: timeout
    and OOM — the two shapes where the card itself is implicated), when
    ``allow_degrade`` is set, remaining attempts run with
    ``RQ_BACKEND=cpu`` in the child env; entry points built on
    :func:`ensure_backend` get ``"cpu"`` from it and pass it as
    ``device=``.  Every degradation is recorded; ``backend_used`` is
    ``"cuda"`` only when the child reports it and ``"cpu"`` for every
    degraded attempt (:func:`_backend_used`), so artifacts are never
    mislabeled.
    """

    def __init__(self, name: str = "run",
                 retry: Optional[RetryPolicy] = None,
                 deadline_s: float = 600.0,
                 backend: str = "default",
                 allow_degrade: bool = True,
                 degrade_on: Sequence[str] = (TIMEOUT, OOM),
                 retry_on: Sequence[str] = (TIMEOUT, TRANSIENT, OOM, CRASH),
                 heartbeat_timeout_s: Optional[float] = None,
                 poll_s: float = 0.1,
                 report_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 probe_first: bool = False,
                 raise_on_failure: bool = False,
                 flight_path: Optional[str] = None,
                 log: Callable = _stderr_log):
        if backend not in ("default", "cpu"):
            raise ValueError(f"backend must be 'default' or 'cpu', "
                             f"got {backend!r}")
        self.name = name
        self.retry = retry or RetryPolicy()
        self.deadline_s = deadline_s
        self.backend = backend
        self.allow_degrade = allow_degrade
        self.degrade_on = tuple(degrade_on)
        self.retry_on = tuple(retry_on)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.poll_s = poll_s
        self.report_dir = report_dir
        self.env = dict(env or {})
        self.cwd = cwd
        self.probe_first = probe_first
        self.raise_on_failure = raise_on_failure
        # Flight-recorder salvage (runtime.telemetry): when set, the
        # child's telemetry mirrors its spans into this ring file
        # (RQ_TRACE_FLIGHT in the attempt env — setting it implies
        # tracing on), and every FAILED attempt's last ~N spans are
        # salvaged into the RunReport — a SIGKILL'd/timed-out child
        # still testifies about where it spent its final moments.
        # Absolute-ized: a relative path under a cwd= override would
        # have the child write one file and the parent salvage another.
        self.flight_path = (None if flight_path is None
                            else os.path.abspath(flight_path))
        self.log = log or (lambda *a: None)

    # -- helpers -----------------------------------------------------------

    def _attempt_env(self, backend: str, hb_path: str) -> dict:
        env = dict(os.environ)
        env.update(self.env)
        env[ENV_SUPERVISED] = "1"
        env[ENV_HEARTBEAT] = hb_path
        if self.flight_path:
            from . import telemetry as _telemetry

            env[_telemetry.ENV_TRACE_FLIGHT] = self.flight_path
        if backend == "cpu":
            env[ENV_BACKEND] = "cpu"
        return env

    def _classify_argv(self, rc: int, stderr: str, hang: str) -> Tuple[str, str]:
        if hang:
            return TIMEOUT, hang
        if rc == 0:
            return OK, ""
        if faultinject.TRANSIENT_MARKER in stderr:
            return TRANSIENT, f"rc={rc}, transient marker on stderr"
        if any(m in stderr for m in faultinject.OOM_MARKERS):
            return OOM, f"rc={rc}, OOM marker on stderr"
        return CRASH, f"rc={rc}"

    def _classify_callable(self, exitcode: Optional[int],
                           verdict: Optional[dict], hang: str,
                           ) -> Tuple[str, str, Any]:
        if hang:
            return TIMEOUT, hang, None
        if verdict is not None and verdict.get("ok"):
            return OK, "", verdict.get("value")
        if verdict is not None:
            msg = f"{verdict.get('error')}: {verdict.get('message')}"
            if verdict.get("transient"):
                return TRANSIENT, msg, None
            if verdict.get("oom"):
                return OOM, msg, None
            return ERROR, msg, None
        return CRASH, f"exitcode={exitcode}, no result written", None

    # -- the main loop -----------------------------------------------------

    def run(self, target: Union[Sequence[str], Callable], *,
            args: tuple = (), kwargs: Optional[dict] = None) -> RunReport:
        """Supervise ``target`` to completion or attempt exhaustion."""
        is_callable = callable(target)
        _SEQ["n"] += 1
        report = RunReport(
            name=self.name,
            target=(getattr(target, "__qualname__", repr(target))
                    if is_callable else " ".join(map(str, target))),
            backend_requested=self.backend,
            retry_policy=self.retry.to_dict(),
        )
        rng = self.retry.rng()
        backend = self.backend
        t_run = time.monotonic()

        if (self.probe_first and backend == "default"
                and self.allow_degrade):
            alive, _, _ = backend_alive(log=self.log)
            if not alive:
                report.degradations.append(
                    {"after_attempt": 0, "from": backend, "to": "cpu",
                     "reason": "liveness probe: default backend down"})
                report.degraded = True
                backend = "cpu"
                self.log(f"[{self.name}] default backend down at probe; "
                         f"degrading to CPU before attempt 1")

        for i in range(1, self.retry.max_attempts + 1):
            fd, hb_path = tempfile.mkstemp(prefix="rq_hb_")
            os.close(fd)
            os.remove(hb_path)  # only a child that heartbeats creates it
            att = Attempt(index=i, backend=backend,
                          deadline_s=self.deadline_s)
            report.attempts.append(att)
            try:
                if is_callable:
                    extra = {k: v for k, v in
                             self._attempt_env(backend, hb_path).items()
                             if os.environ.get(k) != v}
                    rc, verdict, wall, hang = _run_callable(
                        target, args, kwargs or {}, self.deadline_s, extra,
                        hb_path, self.poll_s, self.heartbeat_timeout_s)
                    att.returncode, att.wall_s = rc, wall
                    att.outcome, att.detail, value = self._classify_callable(
                        rc, verdict, hang)
                else:
                    env = self._attempt_env(backend, hb_path)
                    rc, out, err, wall, hang = _popen_capture(
                        list(map(str, target)), self.deadline_s, env,
                        self.cwd, hb_path, self.poll_s,
                        self.heartbeat_timeout_s)
                    att.returncode, att.wall_s = rc, wall
                    att.stdout, att.stderr = out, err
                    att.outcome, att.detail = self._classify_argv(
                        rc, err, hang)
                    value = None
                    if att.outcome == OK:
                        from ..utils import backend as _b

                        value = _b.parse_last_json_line(out)
            finally:
                if os.path.exists(hb_path):
                    os.remove(hb_path)

            if self.flight_path and att.outcome != OK:
                # Salvage the dead/timed-out child's flight ring into
                # the report (read_flight never raises; the ring is
                # consumed so the NEXT attempt's ring starts clean —
                # stale evidence never attributes to a later attempt).
                from . import telemetry as _telemetry

                att.flight = _telemetry.read_flight(
                    self.flight_path)[-_telemetry.FLIGHT_SALVAGE_SPANS:]
                try:
                    os.remove(self.flight_path)
                except OSError:
                    pass

            if att.outcome == OK:
                report.ok = True
                report.disposition = "ok"
                report.result = value
                report.backend_used = _backend_used(backend, value)
                break

            self.log(f"[{self.name}] attempt {i}/{self.retry.max_attempts} "
                     f"on {backend}: {att.outcome} ({att.detail})")
            if att.outcome not in self.retry_on or i == self.retry.max_attempts:
                report.failure_kind = att.outcome
                report.backend_used = _backend_used(backend, None)
                break

            if (self.allow_degrade and backend != "cpu"
                    and att.outcome in self.degrade_on):
                report.degradations.append(
                    {"after_attempt": i, "from": backend, "to": "cpu",
                     "reason": att.outcome})
                report.degraded = True
                backend = "cpu"
                self.log(f"[{self.name}] degrading to CPU for the "
                         f"remaining attempts (reason: {att.outcome})")

            att.backoff_s = round(self.retry.delay(i, rng), 3)
            self.log(f"[{self.name}] backing off {att.backoff_s:.2f}s "
                     f"before attempt {i + 1}")
            time.sleep(att.backoff_s)

        report.total_wall_s = time.monotonic() - t_run
        if self.report_dir:
            os.makedirs(self.report_dir, exist_ok=True)
            fname = (f"{self.name}.{os.getpid()}.{_SEQ['n']:04d}"
                     f".report.json")
            report.write(os.path.join(self.report_dir, fname))
        if not report.ok and self.raise_on_failure:
            raise SupervisorError(report)
        return report


def run_resilient(target: Union[Sequence[str], Callable], *,
                  args: tuple = (), kwargs: Optional[dict] = None,
                  name: str = "run", **supervisor_kw) -> RunReport:
    """One-call form: ``run_resilient(fn_or_argv, deadline_s=...,
    retry=RetryPolicy(...), report_dir=...)`` -> :class:`RunReport`."""
    return Supervisor(name=name, **supervisor_kw).run(
        target, args=args, kwargs=kwargs)


def supervised_run(cmd: Sequence[str], timeout_s: float,
                   log_path: Optional[str] = None,
                   cwd: Optional[str] = None,
                   name: str = "cmd",
                   heartbeat_timeout_s: Optional[float] = None,
                   report_dir: Optional[str] = None,
                   ) -> Tuple[int, str, str, float]:
    """One supervised attempt of an argv command (no retry): returns
    ``(rc, stdout, stderr, wall_s)`` with rc=124 and partial output kept
    on a deadline kill, and writes the durable capture log to
    ``log_path`` — the ``proc_util.run_logged`` contract, now served by
    the runtime layer."""
    sup = Supervisor(name=name, retry=RetryPolicy(max_attempts=1),
                     deadline_s=timeout_s, allow_degrade=False,
                     heartbeat_timeout_s=heartbeat_timeout_s,
                     report_dir=report_dir, cwd=cwd)
    report = sup.run(list(cmd))
    att = report.attempts[-1]
    rc = att.returncode if att.returncode is not None else 1
    if log_path:
        atomic_write_text(
            log_path,
            f"$ {' '.join(map(str, cmd))}\nrc={rc} wall={att.wall_s:.1f}s\n"
            f"--- stdout ---\n{att.stdout}\n--- stderr ---\n{att.stderr}\n")
    return rc, att.stdout, att.stderr, att.wall_s


# --------------------------------------------------------------------------
# Backend liveness policy behind the runtime API.  Delegation happens at
# CALL time, so that tests patching utils.backend reach it;
# utils/backend.py stays the one implementation.
# --------------------------------------------------------------------------

def probe_backend(deadline_s: float = 120.0, log: Optional[Callable] = None):
    """Probe the card in a deadline-bounded subprocess.  Returns
    ``(alive, n_devices, platform)``."""
    from ..utils import backend as _backend

    return _backend.probe_default_backend(deadline_s, log=log)


def backend_alive(log: Optional[Callable] = None,
                  deadlines: Sequence[float] = (90.0, 40.0)):
    """The shared retrying liveness policy (one policy, one place)."""
    from ..utils import backend as _backend

    return _backend.default_backend_alive(log=log, deadlines=deadlines)


def ensure_backend(log: Callable = _stderr_log,
                   deadlines: Sequence[float] = (90.0, 40.0)) -> str:
    """The device an entry point should use: ``"cpu"`` without a probe
    when a supervisor degraded this child (``RQ_BACKEND=cpu``), else the
    probe's answer (``"cuda"``, or ``"cpu"`` when the card did not
    answer).  Sets nothing: pass the result as ``device=``, and record it
    in every artifact written."""
    if os.environ.get(ENV_BACKEND, "").strip().lower() == "cpu":
        if log:
            log("ensure_backend: supervisor-imposed CPU degradation "
                f"({ENV_BACKEND}=cpu); skipping the probe")
        return "cpu"
    from ..utils import backend as _backend

    return _backend.ensure_live_backend(log=log, deadlines=deadlines)
