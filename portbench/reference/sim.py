"""The plain reference of the simulate layer: RedQueen's ``Opt``
broadcaster against Poisson walls (Zarezade et al., arXiv:1610.05773,
Algorithm 1), in NumPy, vectorised over independent lanes.

A component has S sources over F follower feeds.  The lowest-index
source at the earliest clock fires.  A Poisson source draws its next
clock as ``t + Exp(1) / rate``.  An ``Opt`` source's own post cancels its
clock; when another source posts into feeds it shares with the ``Opt``
row, the row draws a candidate ``t + Exp(1) / sum_f sqrt(s_f / q)`` over
the shared feeds and keeps the earlier of it and its clock
(superposition).  The run stops at the horizon T.

Every draw is threefry-2x32 on counters, so the reference makes the same
draws from the same lane seeds.  The system has two engines, and they
address their draws in two ways (:class:`PanelDraws` for the scan
engine, :class:`SourceDraws` for the fused one).

:func:`check_events` judges a program's log lane by lane.  It follows
the program's own events: at each event it recomputes every source's
clock in float64 from the seeds, with the new clock of the source that
fired anchored at the program's event time, and measures how far the
program's event lies from the reference's clock of the source it names
and from the earliest clock (a wrong source, a wrong draw, a skipped or
repeated event all show as a gap).  After the last event it measures how
far before the horizon a clock was left unfired.  The gap of a sound run
is float32 rounding of the event times.

:func:`simulate` runs the same model free, in a precision it is given:
float32 is what the system states, bfloat16 is the control."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .precision import rounder
from .threefry import exp1, threefry2x32, uniform23, uniform24

__all__ = ["POISSON", "OPT", "Component", "headline_component",
           "PanelDraws", "SourceDraws", "draws_for", "check_events",
           "feed_metrics", "simulate"]

POISSON, OPT = 0, 1
_PANEL_DOMAIN = 0x8000_0000


@dataclasses.dataclass(frozen=True)
class Component:
    """One component's shape and parameters (shared by every lane)."""

    kind: np.ndarray     # [S] POISSON or OPT
    rate: np.ndarray     # [S] Poisson rates (0 for Opt rows)
    q: np.ndarray        # [S] Opt costs (1 for other rows)
    adj: np.ndarray      # [S, F] bool: source s posts into feed f
    s_sink: np.ndarray   # [F] follower significances
    end_time: float
    tracked: int         # the Opt row whose feeds the metrics score

    @property
    def S(self) -> int:
        return int(self.kind.shape[0])

    @property
    def F(self) -> int:
        return int(self.adj.shape[1])

    @property
    def opt_rows(self) -> Sequence[int]:
        return tuple(int(r) for r in np.flatnonzero(self.kind == OPT))

    def rate_sum(self, rnd=None) -> np.ndarray:
        """``[S, S]``: for Opt row r and source s, the sum over the feeds
        they share of ``sqrt(s_f / q_r)`` (0 where they share none)."""
        rnd = rnd or rounder("float64")
        out = np.zeros((self.S, self.S))
        for r in self.opt_rows:
            w = rnd(np.sqrt(rnd(self.s_sink / self.q[r])))
            for f in range(self.F):
                hit = self.adj[r, f] & self.adj[:, f]
                out[r] = np.where(hit, rnd(out[r] + w[f]), out[r])
        return out


def headline_component(cfg: dict) -> Component:
    """One ``Opt`` broadcaster (row 0, cost ``q``, posting into every
    follower's feed) against ``followers`` Poisson walls, wall f + 1
    posting at ``wall_rate`` into feed f only."""
    F = int(cfg["followers"])
    S = F + 1
    kind = np.array([OPT] + [POISSON] * F)
    rate = np.array([0.0] + [float(cfg["wall_rate"])] * F)
    q = np.array([float(cfg["q"])] + [1.0] * F)
    adj = np.zeros((S, F), bool)
    adj[0] = True
    adj[np.arange(1, S), np.arange(F)] = True
    return Component(kind=kind, rate=rate, q=q, adj=adj,
                     s_sink=np.full(F, float(cfg["s_sink"])),
                     end_time=float(cfg["end_time"]), tracked=0)


def _lane_seeds(seeds) -> np.ndarray:
    return (np.asarray(seeds, np.int64) & 0xFFFFFFFF).astype(np.uint32)


class PanelDraws:
    """The scan engine's draws.  The lane key is ``(0, seed)``.  Source s
    draws its first clock from ``fold_in(fold_in(key, s), 0)`` as
    ``jax.random.exponential`` does (the 23-bit uniform of ``w0 ^ w1``).
    The event with index n reads the panel ``threefry(key; n, pair |
    2^31)``: slot 0 (word 0 of pair 0) is the fired source's draw, slot
    1 + r the draw of Opt row r; words become 24-bit uniforms."""

    def __init__(self, seeds, S: int):
        self.k1 = _lane_seeds(seeds)
        self.k0 = np.zeros_like(self.k1)
        self.S = S
        self._n = None
        self._words = None

    def init(self) -> np.ndarray:
        src = np.arange(self.S, dtype=np.uint32)[None, :]
        a0, a1 = threefry2x32(self.k0[:, None], self.k1[:, None], 0, src)
        i0, i1 = threefry2x32(a0, a1, 0, 0)
        w0, w1 = threefry2x32(i0, i1, 0, 0)
        return exp1(uniform23(w0 ^ w1))

    def _slot(self, n: np.ndarray, slot: int) -> np.ndarray:
        pair = slot // 2
        key = (pair, n.tobytes())
        if self._n != key:
            self._words = threefry2x32(self.k0, self.k1, n.astype(np.uint32),
                                       np.uint32(pair | _PANEL_DOMAIN))
            self._n = key
        return self._words[slot % 2]

    def fire(self, n, s) -> np.ndarray:
        return exp1(uniform24(self._slot(np.asarray(n), 0)))

    def react(self, n, s, r: int) -> np.ndarray:
        return exp1(uniform24(self._slot(np.asarray(n), 1 + r)))

    def commit(self, s, fired, r=None, reacted=None):
        pass


class SourceDraws:
    """The fused engine's draws.  Source s of a lane has the key
    ``threefry((seed, 0); s, 0)`` and a counter that starts at 0.  Its
    first clock is word 0 of ``(key; 0, 2)``; a fire reads ``(key; ctr,
    0)`` and moves the fired source's counter, whatever its kind; an Opt
    row's reaction reads ``(key; ctr, 1)`` and moves that row's counter.
    Words become 24-bit uniforms."""

    def __init__(self, seeds, S: int):
        seed = _lane_seeds(seeds)
        src = np.arange(S, dtype=np.uint32)[None, :]
        self.k0, self.k1 = threefry2x32(seed[:, None], 0, src, 0)
        self.ctr = np.zeros(self.k0.shape, np.uint32)
        self.rows = np.arange(seed.shape[0])

    def init(self) -> np.ndarray:
        w0, _ = threefry2x32(self.k0, self.k1, 0, 2)
        return exp1(uniform24(w0))

    def _word(self, s, x1) -> np.ndarray:
        s = np.asarray(s)
        w0, _ = threefry2x32(self.k0[self.rows, s], self.k1[self.rows, s],
                             self.ctr[self.rows, s], x1)
        return w0

    def fire(self, n, s) -> np.ndarray:
        return exp1(uniform24(self._word(s, 0)))

    def react(self, n, s, r: int) -> np.ndarray:
        return exp1(uniform24(self._word(np.full_like(np.asarray(s), r), 1)))

    def commit(self, s, fired, r=None, reacted=None):
        if r is None:
            self.ctr[self.rows[fired], np.asarray(s)[fired]] += np.uint32(1)
        else:
            self.ctr[self.rows[reacted], r] += np.uint32(1)


def draws_for(engine: str, seeds, S: int):
    """The draws of the engine a log came from: ``"scan"`` or
    ``"fused"``."""
    if engine == "scan":
        return PanelDraws(seeds, S)
    if engine == "fused":
        return SourceDraws(seeds, S)
    raise ValueError(f"engine must be 'scan' or 'fused', got {engine!r}")


def _first_clocks(comp: Component, e0: np.ndarray, rnd) -> np.ndarray:
    L = e0.shape[0]
    poisson = (comp.kind == POISSON) & (comp.rate > 0)
    safe = np.where(poisson, comp.rate, 1.0)
    first = rnd(rnd(e0) / safe[None, :])
    return np.where(poisson[None, :], first, np.inf).reshape(L, comp.S)


def check_events(comp: Component, draws, times, srcs, nev) -> np.ndarray:
    """The worst gap of each lane's log (``times``/``srcs`` ``[L, E]``,
    ``nev`` ``[L]`` valid events, a prefix) against the reference clocks,
    in units of time: ``inf`` for a malformed log (a source out of range,
    a non-finite time among the valid events, a valid-looking entry
    after them)."""
    times = np.asarray(times, np.float64)
    srcs = np.asarray(srcs, np.int64)
    nev = np.asarray(nev, np.int64)
    L, E = times.shape
    S, T = comp.S, comp.end_time
    rows = np.arange(L)
    rs_all = comp.rate_sum()
    clock = _first_clocks(comp, draws.init(), rounder("float64"))
    gap = np.zeros(L)
    if np.any(nev > E) or np.any(nev < 0):
        return np.full(L, np.inf)
    cols = np.arange(E)[None, :]
    tail = cols >= nev[:, None]
    bad_tail = (tail & (np.isfinite(times) | (srcs != -1))).any(1)
    for n in range(int(nev.max(initial=0))):
        act = n < nev
        s = srcs[:, n]
        t = times[:, n]
        bad = act & ((s < 0) | (s >= S) | ~np.isfinite(t))
        s = np.clip(s, 0, S - 1)
        c_s = clock[rows, s]
        with np.errstate(invalid="ignore"):
            g = np.maximum(np.abs(t - c_s), c_s - clock.min(1))
        g = np.where(bad | ~np.isfinite(g), np.inf, g)
        gap = np.where(act, np.maximum(gap, g), gap)
        fired_kind = comp.kind[s]
        e = draws.fire(np.full(L, n), s)
        rate = np.where(comp.rate[s] > 0, comp.rate[s], 1.0)
        new = np.where((fired_kind == POISSON) & (comp.rate[s] > 0),
                       t + e / rate, np.inf)
        reacts = []
        for r in comp.opt_rows:
            rs = rs_all[r, s]
            react = act & (s != r) & (rs > 0)
            er = draws.react(np.full(L, n), s, r)
            cand = t + er / np.where(rs > 0, rs, 1.0)
            reacts.append((r, react, cand))
        clock[rows[act], s[act]] = new[act]
        draws.commit(s, act)
        for r, react, cand in reacts:
            clock[:, r] = np.where(react, np.minimum(clock[:, r], cand),
                                   clock[:, r])
            draws.commit(s, act, r, react)
    tmin = clock.min(1)
    gap = np.maximum(gap, np.where(tmin <= T, T - tmin, 0.0))
    return np.where(bad_tail, np.inf, gap)


def feed_metrics(comp: Component, times, srcs, nev,
                 precision: str = "float64"):
    """Time-in-top-1 and posts of the tracked row from a log, per lane.

    The tracked row's rank in a followed feed starts at 0, rises by one
    at each post of another source into the feed and returns to 0 at the
    row's own post; time-in-top-1 is the time over [0, T] at rank 0,
    averaged over the followed feeds.  Events are taken as the log gives
    them, their times clipped to the window."""
    rnd = rounder(precision)
    times = np.asarray(times, np.float64)
    srcs = np.asarray(srcs, np.int64)
    nev = np.asarray(nev, np.int64)
    L, E = times.shape
    T = comp.end_time
    follows = comp.adj[comp.tracked]
    rank = np.zeros((L, comp.F), np.int64)
    top = np.zeros((L, comp.F))
    t_prev = np.zeros(L)
    for n in range(int(nev.max(initial=0))):
        valid = n < nev
        t = np.clip(np.where(valid, times[:, n], t_prev), 0.0, T)
        dt = rnd(np.maximum(rnd(t - t_prev), 0.0))
        top = rnd(top + rnd(dt[:, None] * (rank < 1)))
        s = np.clip(srcs[:, n], 0, comp.S - 1)
        hit = comp.adj[s] & follows[None, :] & valid[:, None]
        own = (s == comp.tracked)[:, None]
        rank = np.where(hit, np.where(own, 0, rank + 1), rank)
        t_prev = np.maximum(t_prev, t)
    dt = rnd(np.maximum(rnd(T - t_prev), 0.0))
    top = rnd(top + rnd(dt[:, None] * (rank < 1)))
    n_f = max(int(follows.sum()), 1)
    top1 = rnd(np.where(follows[None, :], top, 0.0).sum(1) / n_f)
    valid = np.arange(E)[None, :] < nev[:, None]
    posts = ((srcs == comp.tracked) & valid).sum(1)
    return top1, posts


def simulate(comp: Component, draws, n_lanes: int, precision: str,
             max_events: int):
    """Run ``n_lanes`` lanes free to the horizon, every operation rounded
    to ``precision``: ``(times [L, E], srcs [L, E], nev [L])`` in the
    log layout the system uses (invalid entries ``(+inf, -1)``)."""
    rnd = rounder(precision)
    L, S, T = n_lanes, comp.S, comp.end_time
    rows = np.arange(L)
    rs_all = comp.rate_sum(rnd)
    clock = _first_clocks(comp, draws.init(), rnd)
    nev = np.zeros(L, np.int64)
    times = np.full((L, max_events), np.inf)
    srcs = np.full((L, max_events), -1, np.int64)
    for n in range(max_events):
        tmin = clock.min(1)
        s = np.argmin(clock, 1)
        act = tmin <= T
        if not act.any():
            break
        e = rnd(draws.fire(nev, s))
        rate = np.where(comp.rate[s] > 0, comp.rate[s], 1.0)
        new = np.where((comp.kind[s] == POISSON) & (comp.rate[s] > 0),
                       rnd(tmin + rnd(e / rate)), np.inf)
        reacts = []
        for r in comp.opt_rows:
            rs = rs_all[r, s]
            react = act & (s != r) & (rs > 0)
            er = rnd(draws.react(nev, s, r))
            cand = rnd(tmin + rnd(er / np.where(rs > 0, rs, 1.0)))
            reacts.append((r, react, cand))
        clock[rows[act], s[act]] = new[act]
        draws.commit(s, act)
        for r, react, cand in reacts:
            clock[:, r] = np.where(react, np.minimum(clock[:, r], cand),
                                   clock[:, r])
            draws.commit(s, act, r, react)
        times[act, nev[act]] = tmin[act]
        srcs[act, nev[act]] = s[act]
        nev = nev + act
    else:
        if (clock.min(1) <= T).any():
            raise RuntimeError(f"lanes still running after {max_events} "
                               f"events")
    return times, srcs, nev
