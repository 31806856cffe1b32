"""Pieces every driver shares: seeds, the run's record, the numbers a
run compares with their limits, and diagnostics of the host."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["seed_words", "rng", "later_rows", "Check", "Record",
           "nearest_rank", "host_probe_ms", "GcPauses"]

#: The stream of a run's seed (``rng(seed, LATER_STREAM)``) that draws
#: which of the later batches' kept lanes the check judges.
LATER_STREAM = 6


def rng(seed: int, *path: int) -> np.random.Generator:
    """A generator for one use of a run's seed: ``path`` names the use
    (batch index, purpose), so uses never share a stream."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, *map(int, path)]))


def seed_words(seed: int, *path: int, n: int = 1) -> np.ndarray:
    """``n`` uint32 words drawn for one use of a run's seed."""
    return np.random.SeedSequence(
        [int(seed) % 2 ** 64, *map(int, path)]).generate_state(n, np.uint32)


def later_rows(events, cap: int, seed: int) -> List[np.ndarray]:
    """Which lanes of the later batches the check judges.  ``events``
    holds, for each later batch, the events of every lane it kept.  While
    they number ``cap`` or fewer, every one, in order; past it ``cap`` of
    them, a uniform sample drawn from ``seed`` alone that always holds
    the lane of most events (the first such): each lane draws a key from
    ``rng(seed, LATER_STREAM)`` and the ``cap`` least keys are judged,
    the heaviest lane's key set below all.  Returns, for each batch, the
    indices of its kept lanes to judge, ascending."""
    sizes = [len(e) for e in events]
    if sum(sizes) <= cap:
        return [np.arange(n) for n in sizes]
    keys = rng(seed, LATER_STREAM).random(sum(sizes))
    keys[int(np.argmax(np.concatenate(events)))] = -1.0
    pick = np.sort(np.argsort(keys, kind="stable")[:cap])
    ends = np.cumsum(sizes)
    return [pick[(pick >= e - n) & (pick < e)] - (e - n)
            for n, e in zip(sizes, ends)]


def nearest_rank(values, pct: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``pct`` percent of the values at or below it (``inf`` counts as a
    value)."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.nan
    return float(v[max(math.ceil(pct / 100.0 * v.size) - 1, 0)])


def host_probe_ms() -> float:
    """The best of three timings, in ms, of a fixed pure-Python loop: how
    fast the host's core runs the interpreter just now (a diagnostic; two
    runs whose probes differ ran on a core of different speed)."""
    best = math.inf
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i
        best = min(best, time.perf_counter() - t)
    return round(1e3 * best, 4)


class GcPauses:
    """The garbage collector's pauses while the context is open: the
    count of collections of each generation, their total and the
    longest, in ms (a diagnostic)."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.total_s = 0.0
        self.max_s = 0.0
        self._t = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        dt = time.perf_counter() - self._t
        self.count[info["generation"]] += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def notes(self) -> Dict:
        return {"collections": self.count,
                "total_ms": round(1e3 * self.total_s, 3),
                "max_ms": round(1e3 * self.max_s, 3)}


class Check:
    """One number a run compares with its limit; it passes when the
    number is at most the limit."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name} {self.value!r} limit {self.limit!r} "
                f"{'ok' if self.ok else 'FAILED'}")


class Record:
    """What a driver hands back: the counts of work attempted and failed,
    the measurements the metric readers take their numbers from, the
    checks, and the device's readings."""

    def __init__(self, driver: str):
        self.driver = driver
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.values: Dict[str, object] = {}
        self.notes: Dict[str, object] = {}   # diagnostics for stderr
        self.checks: List[Check] = []
        self.memory_peak_bytes = 0
        self.trace = None      # a trace.DeviceTrace of the traced window
        self.phases = None     # the trace.Phases inside it
        self.spans: List[Dict] = []

    def check(self, name: str, value: float, limits: Dict[str, float]):
        self.checks.append(Check(name, value, limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)
