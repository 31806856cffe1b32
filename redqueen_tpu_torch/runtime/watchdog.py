"""Self-healing supervision loop: a lease lock, crash-loop backoff,
budget renewal and a heartbeat artifact the outside can read.  A
standard-library copy of ``redqueen_tpu.runtime.watchdog`` on the port's
own ``artifacts``, ``integrity`` and ``supervisor``.

- :class:`Lease`: a single-instance lock as a lease FILE (JSON: pid,
  host, expiry).  Acquisition is exclusive; a lease whose expiry passed
  or whose owner pid is dead is STOLEN (atomic replace and a read-back
  confirmation) rather than honoured forever, so a SIGKILLed owner does
  not wedge its successor.
- :class:`Watchdog`: runs a child (any ``spawn_child() -> rc``
  callable) in a loop.  rc 0 ends the watch; rc
  :data:`EXIT_BUDGET_EXHAUSTED` means the child's work budget expired
  and the watchdog renews it (up to ``budget_renewals`` times); any other
  rc is a crash, restarted under exponential crash-loop backoff
  (``RetryPolicy``; a child that stayed healthy past ``healthy_after_s``
  resets the streak, and a tight crash loop gives up after
  ``max_crash_restarts`` consecutive crashes).
- Every state change lands in an enveloped heartbeat artifact
  (``runtime.integrity``), so liveness, restarts and renewals are seen
  from outside the process, and a torn heartbeat is detected like any
  other artifact.

``clock``/``sleep`` default to wall time; tests drive the whole loop on
a fake clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from .artifacts import atomic_write_text
from .integrity import write_json as _write_envelope
from .supervisor import RetryPolicy, _stderr_log

__all__ = [
    "EXIT_BUDGET_EXHAUSTED",
    "LeaseHeldError",
    "Lease",
    "Watchdog",
    "HEARTBEAT_SCHEMA",
]

# The child->watchdog verdict for "my probe/work budget expired with the
# job not done" — distinct from 0 (done) and from crash rcs, so renewal
# is never confused with failure.  71 = EX_OSERR region, unused by the
# tools here and by the supervisor's 124-on-timeout convention.
EXIT_BUDGET_EXHAUSTED = 71

HEARTBEAT_SCHEMA = "rq.watchdog.heartbeat/1"

_EVENT_KEEP = 50  # most-recent events kept in the heartbeat artifact


class LeaseHeldError(RuntimeError):
    """Another live instance holds the lease."""


class Lease:
    """Single-instance lock as a lease file.

    The file holds ``{"pid", "host", "acquired_at", "expires_at"}``.
    :meth:`acquire` serializes every acquisition/steal under an
    ``flock``'d critical section; an existing lease is honored only
    while it is FRESH (expiry in the future) and its owner looks alive
    (same-host pid probe) — otherwise it is replaced atomically, with a
    pid+host read-back as a second guard, so two concurrent acquirers
    cannot both win.  ``ttl_s`` bounds
    how long a SIGKILLed owner can block a successor; :meth:`renew`
    pushes the expiry while working.
    """

    def __init__(self, path: str, ttl_s: float = 300.0, clock=time.time):
        self.path = path
        self.ttl_s = float(ttl_s)
        self.clock = clock
        self.held = False

    # -- file content ------------------------------------------------------

    def _ours(self) -> dict:
        import platform

        now = self.clock()
        return {"pid": os.getpid(), "host": platform.node(),
                "acquired_at": now, "expires_at": now + self.ttl_s}

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                obj = json.load(f)
            return obj if isinstance(obj, dict) else None
        except (OSError, ValueError):
            return None  # missing/torn lease = stale

    def _stale(self, info: Optional[dict]) -> bool:
        if not info:
            return True  # unreadable — a lease that can't be verified
        try:
            if float(info["expires_at"]) < self.clock():
                return True
            pid = int(info["pid"])
        except (KeyError, TypeError, ValueError):
            return True
        import platform

        if info.get("host") == platform.node():
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True  # owner died without releasing
            except PermissionError:
                pass  # alive, different user
        return False

    # -- protocol ----------------------------------------------------------

    def acquire(self) -> None:
        """Take the lease (fresh or stolen-stale) or raise
        :class:`LeaseHeldError`.

        The WHOLE check-and-write runs under an ``flock`` on a sibling
        ``.lock`` file, so concurrent acquirers and stealers serialize —
        the loser re-reads the winner's fresh lease inside the critical
        section and loses cleanly.  The lease file itself is only ever
        written atomically (temp + rename), never created-then-filled:
        an exclusive-create that writes the body afterwards leaves a
        momentarily-EMPTY lease a racing stealer would read as torn and
        steal.  A pid+host read-back still guards the flock-less case of
        a filesystem that drops the advisory lock (NFS)."""
        import fcntl
        import platform

        lock_fd = os.open(self.path + ".lock", os.O_CREAT | os.O_WRONLY)
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            info = self._read()  # check UNDER the lock
            if os.path.exists(self.path) and not self._stale(info):
                raise LeaseHeldError(
                    f"lease {self.path} held by pid "
                    f"{(info or {}).get('pid')} on "
                    f"{(info or {}).get('host')} until "
                    f"{(info or {}).get('expires_at')}")
            atomic_write_text(self.path, json.dumps(self._ours()) + "\n")
            back = self._read()
            if (not back or int(back.get("pid", -1)) != os.getpid()
                    or back.get("host") != platform.node()):
                raise LeaseHeldError(
                    f"lease {self.path} lost acquisition race to pid "
                    f"{(back or {}).get('pid')} on "
                    f"{(back or {}).get('host')}")
            self.held = True
        finally:
            fcntl.flock(lock_fd, fcntl.LOCK_UN)
            os.close(lock_fd)

    def renew(self) -> None:
        if not self.held:
            raise RuntimeError(f"cannot renew unheld lease {self.path}")
        atomic_write_text(self.path, json.dumps(self._ours()) + "\n")

    def release(self) -> None:
        if not self.held:
            return
        self.held = False
        info = self._read()
        if info and info.get("pid") == os.getpid():
            try:
                os.remove(self.path)
            except OSError:
                pass


class Watchdog:
    """The self-healing loop around a restartable child.

    ``spawn_child()`` runs ONE child lifetime to completion and returns
    its exit code; the watchdog owns everything around it — the lease,
    the restart policy, the renewal budget, and the heartbeat artifact
    at ``heartbeat_path`` (enveloped JSON: state, counters, the last
    events).  ``run()`` returns the final disposition code: 0 on child
    success, :data:`EXIT_BUDGET_EXHAUSTED` when renewals ran out, else
    the last crash rc.
    """

    def __init__(self, name: str, lease_path: str, heartbeat_path: str,
                 backoff: Optional[RetryPolicy] = None,
                 max_crash_restarts: int = 8,
                 healthy_after_s: float = 300.0,
                 budget_renewals: int = 3,
                 lease_ttl_s: float = 600.0,
                 renew_interval_s: float = 120.0,
                 clock=time.time, sleep=time.sleep,
                 log: Callable = _stderr_log):
        self.name = name
        self.lease = Lease(lease_path, ttl_s=lease_ttl_s, clock=clock)
        self.heartbeat_path = heartbeat_path
        self.backoff = backoff or RetryPolicy(
            max_attempts=1, base_delay_s=5.0, multiplier=2.0,
            max_delay_s=600.0, jitter=0.0)
        self.max_crash_restarts = max_crash_restarts
        self.healthy_after_s = healthy_after_s
        self.budget_renewals = budget_renewals
        self.renew_interval_s = renew_interval_s
        self.clock = clock
        self.sleep = sleep
        self.log = log or (lambda *a: None)
        self._events: List[Dict] = []
        self._counters = {"restarts": 0, "renewals": 0, "crash_streak": 0}

    # -- heartbeat ---------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        self._events.append({"event": kind, "time": self.clock(), **fields})
        del self._events[:-_EVENT_KEEP]

    def beat(self, state: str, **fields) -> None:
        """Land the liveness artifact (atomic + checksummed): another
        process polls this file to see the chain is alive without
        attaching to it."""
        try:
            _write_envelope(self.heartbeat_path, {
                "name": self.name,
                "pid": os.getpid(),
                "state": state,
                "time": self.clock(),
                **self._counters,
                **fields,
                "events": self._events,
            }, schema=HEARTBEAT_SCHEMA)
        except OSError as e:  # liveness must never kill the loop
            self.log(f"[{self.name}] heartbeat write failed: {e}")

    # -- the loop ----------------------------------------------------------

    def run(self, spawn_child: Callable[[], int]) -> int:
        self.lease.acquire()
        rng = self.backoff.rng()
        stop = threading.Event()
        renewer = None
        if self.renew_interval_s and self.renew_interval_s > 0:
            # Background renewal: spawn_child may block for hours (a
            # staged capture), far past the lease ttl.  Real-time wait on
            # purpose — the injected clock/sleep drive POLICY, not this
            # IO-keepalive.
            def _renew_loop():
                while not stop.wait(self.renew_interval_s):
                    try:
                        self.lease.renew()
                    except Exception as e:  # noqa: BLE001
                        self.log(f"[{self.name}] lease renew failed: {e}")

            renewer = threading.Thread(target=_renew_loop, daemon=True,
                                       name=f"{self.name}-lease-renew")
            renewer.start()
        try:
            self._event("started", pid=os.getpid())
            while True:
                self.lease.renew()
                self.beat("running")
                t0 = self.clock()
                rc = spawn_child()
                lifetime = self.clock() - t0
                if rc == 0:
                    self._event("child-done", rc=0, lifetime_s=lifetime)
                    self.beat("done", rc=0)
                    return 0
                if rc == EXIT_BUDGET_EXHAUSTED:
                    if self._counters["renewals"] >= self.budget_renewals:
                        self._event("budget-final", rc=rc)
                        self.beat("budget-exhausted", rc=rc)
                        self.log(f"[{self.name}] probe budget exhausted "
                                 f"after {self._counters['renewals']} "
                                 f"renewal(s); giving up")
                        return EXIT_BUDGET_EXHAUSTED
                    self._counters["renewals"] += 1
                    self._event("budget-renewed",
                                renewal=self._counters["renewals"])
                    self.beat("renewed")
                    self.log(f"[{self.name}] probe budget expired; renewal "
                             f"{self._counters['renewals']}/"
                             f"{self.budget_renewals} — restarting with a "
                             f"fresh budget")
                    continue  # an expired budget is not a crash: no backoff
                # crash path.  The give-up bound is on the STREAK, not
                # the lifetime total: an isolated crash every few hours
                # (each after a healthy run) must never accumulate into
                # a permanent death — only a tight crash LOOP gives up.
                self._counters["restarts"] += 1
                self._counters["crash_streak"] = (
                    1 if lifetime >= self.healthy_after_s
                    else self._counters["crash_streak"] + 1)
                if self._counters["crash_streak"] > self.max_crash_restarts:
                    self._event("gave-up", rc=rc)
                    self.beat("gave-up", rc=rc)
                    self.log(f"[{self.name}] child crashed (rc={rc}) past "
                             f"{self.max_crash_restarts} restarts; giving up")
                    return rc if rc else 1
                delay = round(self.backoff.delay(
                    self._counters["crash_streak"], rng), 3)
                self._event("crash-restart", rc=rc,
                            streak=self._counters["crash_streak"],
                            backoff_s=delay, lifetime_s=lifetime)
                self.beat("backoff", rc=rc, backoff_s=delay)
                self.log(f"[{self.name}] child crashed (rc={rc}, lived "
                         f"{lifetime:.1f}s); restart "
                         f"{self._counters['restarts']} in {delay:.1f}s")
                self.sleep(delay)
        finally:
            stop.set()
            if renewer is not None:
                renewer.join(timeout=5.0)
            self.lease.release()
