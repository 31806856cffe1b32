"""Telemetry of the port: the subset of the JAX package's
``runtime.telemetry`` that the lane layer calls.

Spans (monotonic-clock intervals with a parent id), point events and
counters, recorded in memory while telemetry is enabled and read back
with :meth:`Telemetry.payload` / :meth:`Telemetry.drain_spans`.  Disabled
(the default, unless ``RQ_TRACE`` is set), a call is one branch and
returns a shared no-op span.  The flight recorder, sampling, histograms,
cross-process context and the artifact export of the JAX module are not
here (ROADMAP.md Queue 1 item 7)."""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Telemetry", "get", "configure", "span", "event", "counter",
           "NULL_SPAN", "ENV_TRACE"]

ENV_TRACE = "RQ_TRACE"


class _NullSpan:
    """The shared no-op span every disabled call returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """A live span: ``__enter__`` stamps the clock and pushes its id on
    the thread's context stack, ``__exit__`` records the duration."""

    __slots__ = ("_tel", "name", "parent", "sid", "attrs", "t_wall", "_t0",
                 "dur")

    def __init__(self, tel: "Telemetry", name: str, parent: Optional[int],
                 attrs: Optional[Dict[str, Any]]):
        self._tel = tel
        self.name = name
        self.parent = parent
        self.sid = 0
        self.attrs = attrs or None
        self.t_wall = 0.0
        self._t0 = 0.0
        self.dur = 0.0

    def __enter__(self):
        tel = self._tel
        self.sid = next(tel._sid)
        tel._stack().append(self.sid)
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.dur = time.perf_counter() - self._t0
        stack = self._tel._stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        if et is not None:
            self.set(error=et.__name__)
        self._tel._finish(self)
        return False

    def set(self, **attrs):
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"sid": self.sid, "name": self.name,
                             "t": round(self.t_wall, 6),
                             "dur": round(self.dur, 9)}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Telemetry:
    """One process's telemetry state: the enabled flag, the finished
    spans and the counters."""

    def __init__(self, enabled: bool = False):
        self._lock = threading.Lock()
        self._sid = itertools.count(1)
        self._local = threading.local()
        self.enabled = bool(enabled)
        self.spans: List[_Span] = []
        self.counters: Dict[str, float] = {}

    def configure(self, enabled: Optional[bool] = None,
                  reset: bool = False) -> "Telemetry":
        """Switch recording on or off; ``reset`` drops the recorded spans
        and counters."""
        with self._lock:
            if reset:
                self.spans = []
                self.counters = {}
            if enabled is not None:
                self.enabled = bool(enabled)
        return self

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        """A child span of the current one (a root when none is open)."""
        if not self.enabled:
            return NULL_SPAN
        stack = self._stack()
        return _Span(self, name, stack[-1] if stack else None,
                     attrs or None)

    def event(self, name: str, **attrs) -> None:
        """A point annotation, recorded as a zero-duration span."""
        if not self.enabled:
            return
        stack = self._stack()
        s = _Span(self, name, stack[-1] if stack else None, attrs or None)
        s.sid = next(self._sid)
        s.t_wall = time.time()
        self._finish(s)

    def counter(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _finish(self, s: _Span) -> None:
        with self._lock:
            self.spans.append(s)

    def drain_spans(self) -> List[Dict[str, Any]]:
        """The recorded spans as dicts, clearing the buffer (counters
        stay)."""
        with self._lock:
            out, self.spans = self.spans, []
        return [s.to_dict() for s in out]

    def payload(self) -> Dict[str, Any]:
        """A snapshot: the counters and the spans as dicts."""
        with self._lock:
            snap = list(self.spans)
            counters = dict(self.counters)
        return {"n_spans": len(snap), "counters": counters,
                "spans": [s.to_dict() for s in snap]}


_GLOBAL: Optional[Telemetry] = None
_GLOBAL_LOCK = threading.Lock()


def get() -> Telemetry:
    """The process-default instance, enabled when ``RQ_TRACE`` is set to
    anything but ``""`` or ``"0"``."""
    global _GLOBAL
    t = _GLOBAL
    if t is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Telemetry(
                    enabled=os.environ.get(ENV_TRACE, "") not in ("", "0"))
            t = _GLOBAL
    return t


def configure(**kw) -> Telemetry:
    return get().configure(**kw)


def span(name: str, **attrs):
    return get().span(name, **attrs)


def event(name: str, **attrs) -> None:
    get().event(name, **attrs)


def counter(name: str, n: float = 1) -> None:
    get().counter(name, n)
