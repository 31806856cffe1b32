"""The port's ``runtime.watchdog`` (a standard-library copy of the JAX
package's): the 13 cases of ``tests/test_watchdog.py`` on the port's
modules — lease lock, crash-loop backoff, budget renewal and the
heartbeat, on a deterministic fake clock — and the heartbeat artifact
read by both packages' ``integrity``.  Exact: no tolerance."""

import json
import os

import pytest

from redqueen_tpu.runtime import integrity as jintegrity
from redqueen_tpu_torch.runtime import integrity
from redqueen_tpu_torch.runtime.supervisor import RetryPolicy
from redqueen_tpu_torch.runtime.watchdog import (
    EXIT_BUDGET_EXHAUSTED,
    HEARTBEAT_SCHEMA,
    Lease,
    LeaseHeldError,
    Watchdog,
)
from redqueen_tpu.runtime import watchdog as jwatchdog


class FakeClock:
    """time.time/time.sleep stand-ins sharing one timeline."""

    def __init__(self, t0: float = 1_000.0):
        self.t = t0
        self.sleeps = []

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(round(s, 3))
        self.t += s


def make_dog(tmp_path, clock, **kw):
    kw.setdefault("backoff", RetryPolicy(max_attempts=1, base_delay_s=2.0,
                                         multiplier=2.0, max_delay_s=64.0,
                                         jitter=0.0))
    kw.setdefault("renew_interval_s", 0)  # deterministic: no bg thread
    return Watchdog("dog", str(tmp_path / "dog.lease"),
                    str(tmp_path / "dog.heartbeat.json"),
                    clock=clock, sleep=clock.sleep, log=lambda *a: None,
                    **kw)


def read_heartbeat(dog):
    return integrity.read_json(dog.heartbeat_path, schema=HEARTBEAT_SCHEMA)


# --------------------------------------------------------------------------
# Lease
# --------------------------------------------------------------------------

def test_lease_exclusive_acquire(tmp_path):
    clock = FakeClock()
    a = Lease(str(tmp_path / "l"), ttl_s=100, clock=clock)
    b = Lease(str(tmp_path / "l"), ttl_s=100, clock=clock)
    a.acquire()
    with pytest.raises(LeaseHeldError):
        b.acquire()
    a.release()
    assert not os.path.exists(a.path)
    b.acquire()  # free after release


def test_lease_expired_is_stolen(tmp_path):
    clock = FakeClock()
    a = Lease(str(tmp_path / "l"), ttl_s=100, clock=clock)
    a.acquire()
    clock.t += 101  # the owner went silent past its ttl
    b = Lease(str(tmp_path / "l"), ttl_s=100, clock=clock)
    b.acquire()
    info = json.loads(open(b.path).read())
    assert info["pid"] == os.getpid()
    assert info["expires_at"] == clock.t + 100


def test_lease_dead_pid_is_stolen(tmp_path):
    import platform

    clock = FakeClock()
    path = str(tmp_path / "l")
    # a lease with a FRESH expiry but a pid that no longer exists —
    # SIGKILLed owner, the case the pid probe exists for
    with open(path, "w") as f:
        json.dump({"pid": 2 ** 22 + 1234, "host": platform.node(),
                   "acquired_at": clock.t, "expires_at": clock.t + 1e6}, f)
    b = Lease(path, ttl_s=100, clock=clock)
    b.acquire()
    assert b.held


def test_lease_torn_file_is_stolen(tmp_path):
    clock = FakeClock()
    path = str(tmp_path / "l")
    with open(path, "w") as f:
        f.write('{"pid": 12')  # torn write from a killed owner
    b = Lease(path, ttl_s=100, clock=clock)
    b.acquire()
    assert b.held


def test_lease_renew_pushes_expiry(tmp_path):
    clock = FakeClock()
    a = Lease(str(tmp_path / "l"), ttl_s=100, clock=clock)
    with pytest.raises(RuntimeError, match="unheld"):
        a.renew()
    a.acquire()
    clock.t += 50
    a.renew()
    assert json.loads(open(a.path).read())["expires_at"] == clock.t + 100


# --------------------------------------------------------------------------
# Watchdog loop
# --------------------------------------------------------------------------

def test_crash_loop_backs_off_exponentially_then_succeeds(tmp_path):
    clock = FakeClock()
    dog = make_dog(tmp_path, clock)
    rcs = iter([3, 3, 3, 0])
    rc = dog.run(lambda: next(rcs))
    assert rc == 0
    # three tight crashes: geometric backoff 2, 4, 8 (jitter 0)
    assert clock.sleeps == [2.0, 4.0, 8.0]
    hb = read_heartbeat(dog)
    assert hb["state"] == "done" and hb["restarts"] == 3
    kinds = [e["event"] for e in hb["events"]]
    assert kinds.count("crash-restart") == 3 and "child-done" in kinds
    # the loop released its lease on the way out
    assert not os.path.exists(dog.lease.path)


def test_healthy_run_resets_crash_streak(tmp_path):
    clock = FakeClock()
    dog = make_dog(tmp_path, clock, healthy_after_s=100.0)
    script = iter([(1.0, 4), (1.0, 4), (500.0, 4), (1.0, 0)])

    def child():
        lifetime, rc = next(script)
        clock.t += lifetime
        return rc

    assert dog.run(child) == 0
    # two tight crashes back off 2, 4; the HEALTHY run's crash restarts
    # the schedule at the base delay instead of compounding to 8
    assert clock.sleeps == [2.0, 4.0, 2.0]


def test_gives_up_after_max_restarts(tmp_path):
    clock = FakeClock()
    dog = make_dog(tmp_path, clock, max_crash_restarts=2)
    rc = dog.run(lambda: 9)
    assert rc == 9
    hb = read_heartbeat(dog)
    assert hb["state"] == "gave-up" and hb["restarts"] == 3


def test_isolated_healthy_crashes_never_accumulate_to_give_up(tmp_path):
    """The give-up bound is on the crash STREAK: a long-lived watcher
    that crashes once every few (healthy) hours must keep healing
    forever — only a tight crash loop may end the chain."""
    clock = FakeClock()
    dog = make_dog(tmp_path, clock, max_crash_restarts=2,
                   healthy_after_s=100.0)
    # 6 isolated crashes (each after a healthy 500s run) — more than
    # 2x max_crash_restarts — then success
    script = iter([(500.0, 7)] * 6 + [(500.0, 0)])

    def child():
        lifetime, rc = next(script)
        clock.t += lifetime
        return rc

    assert dog.run(child) == 0
    hb = read_heartbeat(dog)
    assert hb["restarts"] == 6 and hb["state"] == "done"
    assert clock.sleeps == [2.0] * 6, "healthy crashes stay at base delay"


def test_budget_renewal_then_success(tmp_path):
    clock = FakeClock()
    dog = make_dog(tmp_path, clock, budget_renewals=2)
    rcs = iter([EXIT_BUDGET_EXHAUSTED, EXIT_BUDGET_EXHAUSTED, 0])
    assert dog.run(lambda: next(rcs)) == 0
    assert clock.sleeps == [], "renewal is not a crash: no backoff"
    hb = read_heartbeat(dog)
    assert hb["renewals"] == 2 and hb["restarts"] == 0
    assert [e["event"] for e in hb["events"]].count("budget-renewed") == 2


def test_budget_renewals_exhausted(tmp_path):
    clock = FakeClock()
    dog = make_dog(tmp_path, clock, budget_renewals=1)
    rc = dog.run(lambda: EXIT_BUDGET_EXHAUSTED)
    assert rc == EXIT_BUDGET_EXHAUSTED
    hb = read_heartbeat(dog)
    assert hb["state"] == "budget-exhausted" and hb["renewals"] == 1


def test_single_instance_via_lease(tmp_path):
    clock = FakeClock()
    a = make_dog(tmp_path, clock)
    a.lease.acquire()  # someone already running
    b = make_dog(tmp_path, clock)
    with pytest.raises(LeaseHeldError):
        b.run(lambda: 0)


def test_heartbeat_is_verifiable_and_survives_corruption_detection(tmp_path):
    """The heartbeat is an enveloped artifact: a reader can PROVE it is
    whole, and a torn one is detected like any other artifact."""
    from redqueen_tpu_torch.runtime import faultinject

    clock = FakeClock()
    dog = make_dog(tmp_path, clock)
    assert dog.run(lambda: 0) == 0
    assert read_heartbeat(dog)["name"] == "dog"
    faultinject.corrupt_file(dog.heartbeat_path, "truncate")
    with pytest.raises(integrity.CorruptArtifactError):
        integrity.read_json(dog.heartbeat_path)


def test_constants_and_heartbeat_match_the_reference(tmp_path):
    """The exit code and schema are the JAX package's, and the port's
    heartbeat verifies under the reference's integrity reader."""
    assert EXIT_BUDGET_EXHAUSTED == jwatchdog.EXIT_BUDGET_EXHAUSTED
    assert HEARTBEAT_SCHEMA == jwatchdog.HEARTBEAT_SCHEMA
    clock = FakeClock()
    dog = make_dog(tmp_path, clock)
    assert dog.run(lambda: 0) == 0
    ours = read_heartbeat(dog)
    theirs = jintegrity.read_json(dog.heartbeat_path,
                                  schema=HEARTBEAT_SCHEMA)
    assert ours == theirs and ours["state"] == "done"
