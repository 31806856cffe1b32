"""Preemption safety: turn SIGTERM/SIGINT into an orderly flush + exit.

A copy of the JAX package's ``runtime.preempt`` for the port (the port
never imports the JAX package).  Long-running work (fits, chunked runs)
is routinely killed from outside: deadlines, ``timeout -k``, a watcher
outliving its run.  The invariant this module provides: a first
SIGTERM/SIGINT never tears the process mid-write.  Instead it (a) runs
every registered flush callback, and (b) sets a flag that cooperative
loops poll via :func:`check_preempt` at their next safe point: for
``learn.fit_hawkes`` and ``models.rmtpp.fit`` that is right after a
checkpoint's atomic ``os.replace`` lands, so a resumed run completes
bit-identically from what is on disk.  A second signal restores the
original handlers and re-raises, so a stuck flush can still be killed.

Stdlib-only on purpose: importable from signal handlers and from
supervised children without torch.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
from typing import Callable, Iterable, List, Optional

__all__ = [
    "PreemptedError",
    "preemption_guard",
    "preempt_requested",
    "check_preempt",
    "register_flush",
    "unregister_flush",
    "reset",
]


class PreemptedError(RuntimeError):
    """Raised at a safe point after a preemption signal was received.

    Carries ``signum`` so callers can translate to the conventional
    128+signum exit code.
    """

    def __init__(self, message: str, signum: Optional[int] = None):
        super().__init__(message)
        self.signum = signum


_FLUSHERS: List[Callable[[], None]] = []
_STATE = {"signum": None, "count": 0}


def register_flush(fn: Callable[[], None]) -> Callable[[], None]:
    """Register ``fn`` to run when a preemption signal arrives (before the
    cooperative exit).  Returns ``fn`` so it can be used as a decorator.
    Flushers must be idempotent and exception-safe — each one is wrapped,
    a failing flusher never blocks the others."""
    if fn not in _FLUSHERS:
        _FLUSHERS.append(fn)
    return fn


def unregister_flush(fn: Callable[[], None]) -> None:
    with contextlib.suppress(ValueError):
        _FLUSHERS.remove(fn)


def preempt_requested() -> bool:
    """True once a guarded SIGTERM/SIGINT has been received."""
    return _STATE["signum"] is not None


def check_preempt(what: str = "") -> None:
    """Cooperative cancellation point: raise :class:`PreemptedError` iff a
    preemption signal has been received.  Call this at boundaries where
    everything already done is durable (e.g. after a sweep chunk's atomic
    rename), never inside a critical section."""
    signum = _STATE["signum"]
    if signum is not None:
        name = signal.Signals(signum).name if signum else "signal"
        where = f" during {what}" if what else ""
        raise PreemptedError(
            f"preempted by {name}{where}; completed work is checkpointed "
            f"and a rerun with the same arguments resumes from it",
            signum=signum,
        )


def flush_all(log: Callable = None) -> None:
    """Run every registered flusher, swallowing (but logging) failures."""
    for fn in list(_FLUSHERS):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — a flusher must not block exit
            if log:
                log(f"preempt: flush {getattr(fn, '__name__', fn)!r} "
                    f"failed: {e!r}")


def reset() -> None:
    """Clear the preemption flag (tests / sequential guarded sections)."""
    _STATE["signum"] = None
    _STATE["count"] = 0


def _log_stderr(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def preemption_guard(signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
                     log: Callable = _log_stderr):
    """Install the orderly-shutdown handlers for the duration of a block.

    First signal: run flushers, set the flag :func:`check_preempt` polls.
    Second signal: restore the original handlers and re-deliver, so an
    operator (or the driver's ``timeout -k``) can always force an exit.
    Handlers are restored on block exit; the flag is NOT auto-cleared on a
    preempted exit (callers inspect it), but is cleared on a clean one.
    Only the main thread may install signal handlers; in any other thread
    this degrades to a no-op guard.
    """
    signals = tuple(signals)

    def _handler(signum, frame):  # noqa: ARG001 — signal API
        _STATE["count"] += 1
        if _STATE["count"] >= 2:
            for s, h in saved.items():
                signal.signal(s, h)
            if log:
                log(f"preempt: second {signal.Signals(signum).name}; "
                    f"restoring default handling")
            os.kill(os.getpid(), signum)
            return
        _STATE["signum"] = signum
        if log:
            log(f"preempt: {signal.Signals(signum).name} received — "
                f"flushing and stopping at the next safe point")
        flush_all(log)

    # Per-section signal count: a preempted earlier section must not make
    # this section's FIRST signal take the second-signal (kill) path and
    # skip the flushers.
    _STATE["count"] = 0
    saved = {}
    try:
        for s in signals:
            saved[s] = signal.signal(s, _handler)
    except ValueError:  # not the main thread: signals cannot be guarded
        saved = {}
    try:
        yield
        if not preempt_requested():
            reset()
    finally:
        for s, h in saved.items():
            with contextlib.suppress(Exception):
                signal.signal(s, h)
