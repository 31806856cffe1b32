"""The port's ``runtime.supervisor`` (``redqueen_tpu_torch``): the
supervisor cases of ``tests/test_runtime.py`` on the port's modules —
retry and backoff, deadline and heartbeat kills, the classification of
hangs, crashes, transient faults and OOMs through ``runtime.faultinject``,
the recorded degradation, the report artifact, one-shot ``supervised_run``
and callable targets in a spawned child — plus the port's own contract:
a degraded run reports ``backend_used == "cpu"`` (never a card run), and
``ensure_backend`` under ``RQ_BACKEND=cpu`` returns ``"cpu"`` without a
probe and sets nothing.  Exact: no tolerance."""

import json
import os
import sys
import textwrap

import pytest

from redqueen_tpu.runtime import supervisor as jsupervisor
from redqueen_tpu_torch.runtime import (
    RetryPolicy,
    SupervisorError,
    faultinject,
    run_resilient,
    supervised_run,
)
from redqueen_tpu_torch.runtime import supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Stdlib-only child bodies (no jax import: each runs in well under a
# second, so the whole module stays cheap).
HANG = "import time; time.sleep(60)"
OK_LINE = 'print(\'{"ok": true, "platform": "cpu"}\')'


def _argv(body):
    return [sys.executable, "-c", body]


def _fast_retry(n, seed=0):
    return RetryPolicy(max_attempts=n, base_delay_s=0.02, multiplier=2.0,
                       jitter=0.5, seed=seed)


# -------------------------------------------------------------------------
# RetryPolicy: exponential backoff + deterministic jitter
# -------------------------------------------------------------------------

class TestRetryPolicy:
    def test_deterministic_schedule_with_seed(self):
        p = RetryPolicy(base_delay_s=1.0, multiplier=2.0, max_delay_s=60.0,
                        jitter=0.5, seed=123)
        a = [p.delay(i, p.rng()) for i in (1, 2, 3)]
        b = [p.delay(i, p.rng()) for i in (1, 2, 3)]
        assert a == b, "same seed must give the same backoff schedule"

    def test_exponential_growth_jitter_bounds_and_cap(self):
        p = RetryPolicy(base_delay_s=1.0, multiplier=2.0, max_delay_s=5.0,
                        jitter=0.5, seed=7)
        rng = p.rng()
        for n, base in [(1, 1.0), (2, 2.0), (3, 4.0), (4, 5.0), (5, 5.0)]:
            d = p.delay(n, rng)
            assert base <= d <= base * 1.5, (n, d)

    def test_no_jitter_is_exact(self):
        p = RetryPolicy(base_delay_s=0.5, multiplier=3.0, jitter=0.0)
        rng = p.rng()
        assert [p.delay(n, rng) for n in (1, 2)] == [0.5, 1.5]

    def test_rejects_zero_attempts(self):
        with pytest.raises(ValueError, match="max_attempts"):
            RetryPolicy(max_attempts=0)


# -------------------------------------------------------------------------
# Fault classification + retry/degradation (argv children, stdlib-only)
# -------------------------------------------------------------------------

def test_injected_hang_triggers_deadline_kill_and_retry():
    """Acceptance: an injected hang is killed at the deadline, retried
    with backoff, and the default->cpu degradation is recorded."""
    rep = run_resilient(_argv(HANG), name="hang", deadline_s=0.75,
                        retry=_fast_retry(2), poll_s=0.05)
    assert not rep.ok and rep.failure_kind == "timeout"
    assert [a.outcome for a in rep.attempts] == ["timeout", "timeout"]
    assert all(a.returncode == 124 for a in rep.attempts)
    # one backoff slept between the two attempts, from the seeded policy
    assert len(rep.backoff_schedule) == 1 and rep.backoff_schedule[0] > 0
    # hang on the default backend implicates the accelerator: degrade
    assert rep.degraded and rep.degradations == [
        {"after_attempt": 1, "from": "default", "to": "cpu",
         "reason": "timeout"}]
    assert rep.attempts[1].backend == "cpu"


def test_injected_transient_succeeds_on_retry_with_backoff(tmp_path):
    """Acceptance: a transiently-failing child succeeds on retry; the
    TransientError marker on stderr classifies it retryable (not crash),
    and no degradation happens (the backend is not implicated)."""
    state = str(tmp_path / "count")
    body = textwrap.dedent(f"""
        import os, sys
        p = {state!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n < 1:
            print("TransientError: injected flake", file=sys.stderr)
            sys.exit(1)
        {OK_LINE}
        """)
    rep = run_resilient(_argv(body), name="transient", deadline_s=30.0,
                        retry=_fast_retry(3))
    assert rep.ok and rep.disposition == "ok"
    assert [a.outcome for a in rep.attempts] == ["transient", "ok"]
    assert len(rep.backoff_schedule) == 1
    assert not rep.degraded
    assert rep.result == {"ok": True, "platform": "cpu"}
    assert rep.backend_used == "cpu"  # child-reported platform wins


def test_injected_crash_after_degradation_yields_failure_report(tmp_path):
    """Acceptance: hang -> degrade to CPU -> crash -> attempts exhausted;
    one structured JSON failure report lands with the whole history.

    The wedging attempt dies fast via HEARTBEAT staleness (it heartbeats
    once, then stalls) while the wall deadline stays generous — a tight
    wall deadline would race interpreter startup of the healthy attempt
    on a loaded box (observed flake)."""
    state = str(tmp_path / "count")
    body = textwrap.dedent(f"""
        import os, time
        p = {state!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n < 1:
            open(os.environ["RQ_HEARTBEAT_FILE"], "w").write("x")
            time.sleep(60)   # first attempt: wedge (stale heartbeat)
        os._exit(3)          # after degradation: crash
        """)
    rep = run_resilient(_argv(body), name="crash-after-degrade",
                        deadline_s=60.0, heartbeat_timeout_s=0.5,
                        retry=_fast_retry(2), poll_s=0.05,
                        report_dir=str(tmp_path))
    assert not rep.ok and rep.disposition == "failed"
    assert [a.outcome for a in rep.attempts] == ["timeout", "crash"]
    assert rep.degraded and rep.degradations[0]["reason"] == "timeout"
    assert rep.failure_kind == "crash"
    assert rep.backend_used == "cpu"
    # the structured report artifact
    assert rep.report_path and os.path.exists(rep.report_path)
    with open(rep.report_path) as f:
        doc = json.load(f)
    assert doc["ok"] is False and doc["disposition"] == "failed"
    assert doc["n_attempts"] == 2
    assert [a["outcome"] for a in doc["attempts"]] == ["timeout", "crash"]
    assert doc["attempts"][0]["deadline_s"] == 60.0
    assert "heartbeat stale" in doc["attempts"][0]["detail"]
    assert doc["backoff_schedule_s"] == rep.backoff_schedule
    assert doc["degradations"] == rep.degradations
    assert doc["retry_policy"]["max_attempts"] == 2


def test_injected_oom_classified_and_degrades():
    body = ("import sys; "
            "print('RESOURCE_EXHAUSTED: injected', file=sys.stderr); "
            "sys.exit(1)")
    rep = run_resilient(_argv(body), name="oom", deadline_s=30.0,
                        retry=_fast_retry(2))
    assert [a.outcome for a in rep.attempts] == ["oom", "oom"]
    assert rep.degraded and rep.degradations[0]["reason"] == "oom"


def test_heartbeat_staleness_kills_wedged_child_before_deadline():
    """A child that heartbeats once then wedges is killed by the
    staleness bound long before the wall deadline."""
    body = ("import os, time; "
            "open(os.environ['RQ_HEARTBEAT_FILE'], 'w').write('x'); "
            "time.sleep(60)")
    rep = run_resilient(_argv(body), name="stale-heartbeat",
                        deadline_s=30.0, heartbeat_timeout_s=0.5,
                        poll_s=0.05, retry=RetryPolicy(max_attempts=1))
    att = rep.attempts[0]
    assert att.outcome == "timeout" and "heartbeat stale" in att.detail
    assert att.wall_s < 10.0, "must not wait out the 30s wall deadline"


def test_crash_not_retried_when_excluded():
    rep = run_resilient(_argv("import os; os._exit(9)"), name="no-retry",
                        deadline_s=30.0, retry=_fast_retry(3),
                        retry_on=("timeout", "transient", "oom"))
    assert len(rep.attempts) == 1 and rep.failure_kind == "crash"


def test_raise_on_failure_carries_report():
    with pytest.raises(SupervisorError) as ei:
        run_resilient(_argv("import os; os._exit(2)"), name="boom",
                      deadline_s=30.0, retry=RetryPolicy(max_attempts=1),
                      raise_on_failure=True)
    assert ei.value.report.failure_kind == "crash"


def test_degraded_attempt_env_forces_cpu(tmp_path):
    """After degradation the child env carries RQ_BACKEND=cpu (what
    ensure_backend() honors without a probe) and, unlike the JAX
    package's, leaves JAX_PLATFORMS as the parent had it."""
    out = str(tmp_path / "env.json")
    state = str(tmp_path / "count")
    body = textwrap.dedent(f"""
        import json, os, time
        p = {state!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n < 1:
            open(os.environ["RQ_HEARTBEAT_FILE"], "w").write("x")
            time.sleep(60)   # wedge; killed fast via stale heartbeat
        json.dump({{"rq": os.environ.get("RQ_BACKEND"),
                    "jp": os.environ.get("JAX_PLATFORMS"),
                    "sup": os.environ.get("RQ_SUPERVISED")}},
                  open({out!r}, "w"))
        """)
    rep = run_resilient(_argv(body), name="degrade-env", deadline_s=60.0,
                        heartbeat_timeout_s=0.5, retry=_fast_retry(2),
                        poll_s=0.05)
    assert rep.ok and rep.degraded
    with open(out) as f:
        env = json.load(f)
    assert env == {"rq": "cpu", "jp": os.environ.get("JAX_PLATFORMS"),
                   "sup": "1"}


def test_supervised_run_timeout_preserves_partial_stdout(tmp_path):
    """The proc_util.run_logged contract, served by the runtime: rc=124,
    the pre-kill stdout is preserved, and the durable log is written."""
    lp = str(tmp_path / "capture.log")
    # 5s deadline: comfortably past interpreter startup (so the EARLY
    # print always lands) while still far short of the 60s sleep.
    rc, out, err, wall = supervised_run(
        _argv("import time; print('EARLY RESULT', flush=True); "
              "time.sleep(60)"),
        5.0, log_path=lp, name="partial")
    assert rc == 124 and "EARLY RESULT" in out
    text = open(lp).read()
    assert "rc=124" in text and "EARLY RESULT" in text


def test_probe_first_degrades_without_burning_an_attempt(monkeypatch):
    """probe_first=True + dead backend: degradation happens BEFORE
    attempt 1 (recorded as after_attempt 0) and the child runs on CPU."""
    import redqueen_tpu_torch.utils.backend as ub

    monkeypatch.setattr(ub, "default_backend_alive",
                        lambda log=None, deadlines=None: (False, 0, ""))
    rep = run_resilient(_argv(OK_LINE), name="probe-degrade",
                        deadline_s=30.0, retry=RetryPolicy(max_attempts=1),
                        probe_first=True)
    assert rep.ok and rep.degraded
    assert rep.degradations[0]["after_attempt"] == 0
    assert rep.attempts[0].backend == "cpu"


# -------------------------------------------------------------------------
# Callable targets through the spawn path (the picklable-fault harness)
# -------------------------------------------------------------------------

def test_callable_flaky_transient_then_success(tmp_path):
    rep = run_resilient(faultinject.flaky,
                        args=(str(tmp_path / "c"), 1, 42),
                        name="flaky-callable", deadline_s=120.0,
                        retry=_fast_retry(3))
    assert rep.ok and rep.result == 42
    assert [a.outcome for a in rep.attempts] == ["transient", "ok"]
    assert len(rep.backoff_schedule) == 1


def test_callable_oom_classified(tmp_path):
    rep = run_resilient(faultinject.raise_oom, name="oom-callable",
                        deadline_s=120.0, retry=RetryPolicy(max_attempts=1),
                        report_dir=str(tmp_path))
    assert not rep.ok and rep.failure_kind == "oom"
    with open(rep.report_path) as f:
        assert json.load(f)["failure_kind"] == "oom"



# -------------------------------------------------------------------------
# The port's own contract
# -------------------------------------------------------------------------

def test_names_and_env_contract_are_the_references():
    for name in ("OK", "TIMEOUT", "CRASH", "TRANSIENT", "OOM", "ERROR",
                 "ENV_HEARTBEAT", "ENV_BACKEND", "ENV_SUPERVISED"):
        assert getattr(supervisor, name) == getattr(jsupervisor, name), name
    assert set(jsupervisor.__all__) <= set(supervisor.__all__)


@pytest.mark.parametrize("reported", [None, "cuda"])
def test_degraded_run_reports_cpu(tmp_path, reported):
    """A hang degrades the retry to the CPU; the run that then succeeds
    is reported as a CPU run, whatever platform the child claims."""
    state = str(tmp_path / "count")
    line = ("print('{\"ok\": true}')" if reported is None else
            f"print('{{\"ok\": true, \"platform\": \"{reported}\"}}')")
    body = textwrap.dedent(f"""
        import os, time
        p = {state!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n < 1:
            open(os.environ["RQ_HEARTBEAT_FILE"], "w").write("x")
            time.sleep(60)
        {line}
        """)
    rep = run_resilient(_argv(body), name="degrade-report", deadline_s=60.0,
                        heartbeat_timeout_s=0.5, retry=_fast_retry(2),
                        poll_s=0.05)
    assert rep.ok and rep.degraded
    assert rep.backend_requested == "default"
    assert rep.backend_used == "cpu"
    assert rep.to_dict()["backend_used"] == "cpu"


@pytest.mark.parametrize("reported,want", [("cuda", "cuda"),
                                             ("cpu", "cpu"),
                                             (None, "default")])
def test_undegraded_run_reports_the_card(reported, want):
    """A card run is named only on the child's word; a child that says
    nothing leaves the requested backend, as the JAX package does."""
    line = ("print('{\"ok\": true}')" if reported is None else
            f"print('{{\"ok\": true, \"platform\": \"{reported}\"}}')")
    rep = run_resilient(_argv(line), name="card", deadline_s=30.0,
                        retry=RetryPolicy(max_attempts=1))
    assert rep.ok and not rep.degraded and rep.backend_used == want


def test_no_degradation_when_not_allowed():
    rep = run_resilient(_argv(HANG), name="no-degrade", deadline_s=0.75,
                        retry=_fast_retry(2), poll_s=0.05,
                        allow_degrade=False)
    assert [a.backend for a in rep.attempts] == ["default", "default"]
    assert not rep.degraded and rep.backend_used == "default"


def test_ensure_backend_honours_rq_backend_without_probing(monkeypatch):
    import redqueen_tpu_torch.utils.backend as ub

    def no_probe(*a, **k):
        raise AssertionError("ensure_backend probed under RQ_BACKEND=cpu")

    monkeypatch.setattr(ub, "probe_default_backend", no_probe)
    monkeypatch.setattr(ub, "default_backend_alive", no_probe)
    monkeypatch.setenv(supervisor.ENV_BACKEND, "cpu")
    before = dict(os.environ)
    assert supervisor.ensure_backend(log=None) == "cpu"
    assert dict(os.environ) == before


def test_ensure_backend_probes_when_unset(monkeypatch):
    import redqueen_tpu_torch.utils.backend as ub

    monkeypatch.delenv(supervisor.ENV_BACKEND, raising=False)
    monkeypatch.setattr(ub, "probe_default_backend",
                        lambda d, log=None: (True, 1, "cuda"))
    assert supervisor.ensure_backend(log=None) == "cuda"
    monkeypatch.setattr(ub, "probe_default_backend",
                        lambda d, log=None: (False, 0, ""))
    monkeypatch.setattr(ub.time, "sleep", lambda s: None)
    assert supervisor.ensure_backend(log=None) == "cpu"
