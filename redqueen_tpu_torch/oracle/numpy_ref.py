"""NumPy parity oracle: an event-driven feed simulator with the semantics of
MPI-SWS/RedQueen's ``redqueen/opt_model.py``.

This module is the trusted, boring, pure-Python/NumPy reference that the
port's engines (``redqueen_tpu_torch``) are validated against: a copy of the
JAX package's ``oracle/numpy_ref.py``, kept in the port because the port never
imports that package, and held to it by ``tests/test_torch_oracle.py`` (the
same dataframes at the same seeds).  Its parity targets are the
class/function inventory of SURVEY.md sections 1–3 (``redqueen/opt_model.py``
for Event/State/Broadcaster/Poisson/Poisson2/Hawkes/PiecewiseConst/RealData/
Opt/Manager/SimOpts, ``redqueen/utils.py`` for the metric layer) and the
RedQueen paper (Zarezade et al., WSDM 2017, arXiv:1610.05773), Algorithm 1.

Model recap: ``sinks`` are followers, each with a feed. ``sources`` are
broadcasters posting into the feeds of the sinks they are connected to
(``edge_list``). The rank r_i(t) of a source in sink i's feed is the number of
posts by OTHER sources into that feed since the source's own most recent post
(0 = top of feed). The RedQueen policy ``Opt`` posts with intensity
u*(t) = sum_i sqrt(s_i / q) * r_i(t), sampled online via the superposition
trick (one new exponential clock per rank increment, keep the running min).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

__all__ = [
    "Event",
    "State",
    "Broadcaster",
    "Poisson",
    "Poisson2",
    "Hawkes",
    "PiecewiseConst",
    "RealData",
    "Opt",
    "RMTPP",
    "Manager",
    "SimOpts",
]


class Event:
    """One broadcast event (reference: ``Event`` in redqueen/opt_model.py).

    Attributes mirror the reference record: ``event_id`` (sequence number),
    ``cur_time`` (absolute event time), ``time_delta`` (time since the source's
    previous event), ``src_id``, ``sink_ids`` (feeds the post lands in).
    """

    __slots__ = ("event_id", "cur_time", "time_delta", "src_id", "sink_ids")

    def __init__(self, event_id, cur_time, time_delta, src_id, sink_ids):
        self.event_id = event_id
        self.cur_time = cur_time
        self.time_delta = time_delta
        self.src_id = src_id
        self.sink_ids = sink_ids

    def __repr__(self):
        return (
            f"Event(id={self.event_id}, t={self.cur_time:.6f}, "
            f"src={self.src_id}, sinks={list(self.sink_ids)})"
        )


class State:
    """Append-only world state (reference: ``State`` in redqueen/opt_model.py).

    Holds the current time and the event log; exports a pandas DataFrame with
    one row per (event, sink) — the schema the evaluation layer consumes
    (SURVEY.md section 3.4).
    """

    def __init__(self, start_time: float = 0.0):
        self.time = float(start_time)
        self.events: List[Event] = []

    def apply_event(self, event: Event) -> None:
        assert event.cur_time >= self.time, "events must be time-ordered"
        self.time = event.cur_time
        self.events.append(event)

    def get_dataframe(self) -> pd.DataFrame:
        """One row per (event, sink): columns event_id, t, time_delta, src_id, sink_id."""
        rows = []
        for ev in self.events:
            for sink_id in ev.sink_ids:
                rows.append(
                    (ev.event_id, ev.cur_time, ev.time_delta, ev.src_id, sink_id)
                )
        return pd.DataFrame(
            rows, columns=["event_id", "t", "time_delta", "src_id", "sink_id"]
        )


class Broadcaster:
    """Abstract posting policy (reference: ``Broadcaster`` base class).

    Protocol: ``init_state(...)`` wires the broadcaster into the simulation;
    ``get_next_event_time(event)`` is called with ``None`` once at start and
    then with every world event; it returns the broadcaster's next posting
    time (absolute), or +inf if it will not post.
    """

    def __init__(self, src_id, seed: int):
        self.src_id = src_id
        self.seed = seed
        self.random_state = np.random.RandomState(seed)
        self.start_time = 0.0
        self.end_time = np.inf
        self.sink_ids: List = []

    def init_state(self, start_time, all_sink_ids, follower_sink_ids, end_time):
        self.start_time = float(start_time)
        self.end_time = float(end_time)
        self.sink_ids = list(follower_sink_ids)

    def get_next_event_time(self, event: Optional[Event]) -> float:
        raise NotImplementedError


class Poisson(Broadcaster):
    """Constant-rate Poisson posting (reference: ``Poisson``).

    Variant with *precomputed* inter-arrival times: a block of exponentials is
    drawn up front and consumed sequentially (extended lazily if exhausted).
    Distributionally identical to ``Poisson2``.
    """

    _BLOCK = 256

    def __init__(self, src_id, seed, rate: float = 1.0):
        super().__init__(src_id, seed)
        self.rate = float(rate)
        self._deltas: np.ndarray = np.empty(0)
        self._idx = 0
        self._t_next: Optional[float] = None

    def _next_delta(self) -> float:
        if self._idx >= len(self._deltas):
            self._deltas = self.random_state.exponential(
                scale=1.0 / self.rate, size=self._BLOCK
            )
            self._idx = 0
        d = self._deltas[self._idx]
        self._idx += 1
        return float(d)

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            self._t_next = self.start_time + self._next_delta()
        elif event.src_id == self.src_id:
            self._t_next = event.cur_time + self._next_delta()
        return self._t_next


class Poisson2(Broadcaster):
    """Constant-rate Poisson posting, incremental draw variant (reference:
    ``Poisson2``): one exponential is drawn per own event, at decision time."""

    def __init__(self, src_id, seed, rate: float = 1.0):
        super().__init__(src_id, seed)
        self.rate = float(rate)
        self._t_next: Optional[float] = None

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            self._t_next = self.start_time + self.random_state.exponential(
                scale=1.0 / self.rate
            )
        elif event.src_id == self.src_id:
            self._t_next = event.cur_time + self.random_state.exponential(
                scale=1.0 / self.rate
            )
        return self._t_next


class Hawkes(Broadcaster):
    """Self-exciting posting (reference: ``Hawkes``).

    Intensity lambda(t) = l_0 + alpha * sum_{t_j < t} exp(-beta (t - t_j)) over
    the broadcaster's OWN past events. The next event time is sampled with
    Ogata's thinning (SURVEY.md section 3.3): propose from the current upper
    bound (valid because the exponential-kernel intensity decays between
    events), accept with probability lambda(t)/lambda_bar, tighten the bound on
    rejection.
    """

    def __init__(self, src_id, seed, l_0: float = 1.0, alpha: float = 1.0, beta: float = 2.0):
        super().__init__(src_id, seed)
        self.l_0 = float(l_0)
        self.alpha = float(alpha)
        self.beta = float(beta)
        # Excitation S(t) = alpha * sum exp(-beta (t - t_j)), tracked at _exc_t.
        self._exc = 0.0
        self._exc_t = 0.0
        self._t_next: Optional[float] = None

    def _intensity_at(self, t: float) -> float:
        return self.l_0 + self._exc * np.exp(-self.beta * (t - self._exc_t))

    def _sample_next(self, t_from: float) -> float:
        t = t_from
        while True:
            lbd_bar = self._intensity_at(t)
            t += self.random_state.exponential(scale=1.0 / lbd_bar)
            u = self.random_state.uniform()
            if u * lbd_bar <= self._intensity_at(t):
                return t

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            self._exc = 0.0
            self._exc_t = self.start_time
            self._t_next = self._sample_next(self.start_time)
        elif event.src_id == self.src_id:
            t = event.cur_time
            self._exc = self._exc * np.exp(-self.beta * (t - self._exc_t)) + self.alpha
            self._exc_t = t
            self._t_next = self._sample_next(t)
        return self._t_next


class PiecewiseConst(Broadcaster):
    """Inhomogeneous Poisson with piecewise-constant rate (reference:
    ``PiecewiseConst``; models diurnal follower activity and the shape of the
    Karimi et al. offline baseline).

    ``change_times`` are segment boundaries (ascending, first <= start_time);
    ``rates[k]`` applies on [change_times[k], change_times[k+1]). Sampling is
    exact inversion: draw E ~ Exp(1) and push the cumulative hazard forward
    through the segments.
    """

    def __init__(self, src_id, seed, change_times: Sequence[float], rates: Sequence[float]):
        super().__init__(src_id, seed)
        self.change_times = np.asarray(change_times, dtype=np.float64)
        self.rates = np.asarray(rates, dtype=np.float64)
        assert len(self.change_times) == len(self.rates)
        assert np.all(np.diff(self.change_times) > 0)
        assert np.all(self.rates >= 0)
        self._t_next: Optional[float] = None

    def _sample_next(self, t_from: float) -> float:
        target = self.random_state.exponential()  # Exp(1) hazard target
        if t_from < self.change_times[0]:
            # Rate is 0 before the first segment: hazard starts accruing at
            # change_times[0], so the next event cannot land before it.
            k, t = 0, float(self.change_times[0])
        else:
            k = bisect.bisect_right(self.change_times, t_from) - 1
            t = t_from
        n = len(self.rates)
        while True:
            seg_end = self.change_times[k + 1] if k + 1 < n else np.inf
            rate = self.rates[k]
            if rate > 0:
                dt_needed = target / rate
                if t + dt_needed <= seg_end:
                    return t + dt_needed
                target -= rate * (seg_end - t)
            if not np.isfinite(seg_end):
                return np.inf  # zero tail rate: no more events
            t = seg_end
            k += 1

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            self._t_next = self._sample_next(self.start_time)
        elif event.src_id == self.src_id:
            self._t_next = self._sample_next(event.cur_time)
        return self._t_next


class RealData(Broadcaster):
    """Replays a fixed array of real event timestamps (reference: ``RealData``,
    Twitter trace replay)."""

    def __init__(self, src_id, times: Sequence[float]):
        super().__init__(src_id, seed=0)
        self.times = np.sort(np.asarray(times, dtype=np.float64))
        self._ptr = 0

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            self._ptr = int(np.searchsorted(self.times, self.start_time, side="left"))
        elif event.src_id == self.src_id:
            self._ptr += 1
        if self._ptr < len(self.times):
            return float(self.times[self._ptr])
        return np.inf


class Opt(Broadcaster):
    """RedQueen optimal online broadcaster (reference: ``Opt``; paper Alg. 1).

    Tracks the rank r_i(t) in each follower's feed and posts with intensity
    u*(t) = sum_i sqrt(s_i / q) * r_i(t). Because u* is piecewise constant
    between events, the next posting time is sampled by superposition: each
    rank increment of follower i spawns an Exp(sqrt(s_i/q)) candidate clock and
    the running minimum is kept; the broadcaster's own post resets every rank
    (and hence every candidate).
    """

    def __init__(self, src_id, seed, q: float = 1.0, s: Optional[Dict] = None):
        super().__init__(src_id, seed)
        if not q > 0:
            raise ValueError(f"Opt requires q > 0, got q={q}")
        self.q = float(q)
        self._s_spec = s  # sink_id -> significance; None = 1.0 everywhere
        self.r: Dict = {}
        self._t_candidate = np.inf

    def init_state(self, start_time, all_sink_ids, follower_sink_ids, end_time):
        super().init_state(start_time, all_sink_ids, follower_sink_ids, end_time)
        self.r = {i: 0 for i in self.sink_ids}
        self.s = {
            i: (1.0 if self._s_spec is None else float(self._s_spec[i]))
            for i in self.sink_ids
        }
        self._t_candidate = np.inf

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            return self._t_candidate
        if event.src_id == self.src_id:
            for i in self.r:
                self.r[i] = 0
            self._t_candidate = np.inf
        else:
            t = event.cur_time
            for i in event.sink_ids:
                if i in self.r:
                    self.r[i] += 1
                    rate = np.sqrt(self.s[i] / self.q)
                    tau = self.random_state.exponential(scale=1.0 / rate)
                    self._t_candidate = min(self._t_candidate, t + tau)
        return self._t_candidate


class RMTPP(Broadcaster):
    """RMTPP neural-intensity broadcaster (BASELINE config 5) — the pure
    NumPy twin of ``redqueen_tpu_torch.models.rmtpp``: a GRU consumes the
    source's own inter-event gaps and the conditional intensity until the
    next own post is lambda(tau) = exp(a + w tau) with a = v.h + b, sampled
    exactly by inverse CDF (no thinning; same closed form as
    ``redqueen_tpu_torch.ops.sampling.rmtpp_next_delta``).

    ``weights`` is the weight tree of ``models.rmtpp`` (the flax layout) as
    plain nested dicts of NumPy arrays (``convert.rmtpp_weights_to_jax``
    gives it); the GRU recurrence is flax's ``nn.GRUCell`` gate layout
    (r/z gates without hidden bias, the candidate's hidden projection
    biased INSIDE the reset product), pinned to the port's cell by
    tests/test_torch_rmtpp.py."""

    def __init__(self, src_id, seed, weights, hidden: int):
        super().__init__(src_id, seed)
        self.weights = weights
        self.hidden = int(hidden)
        self.h = np.zeros(self.hidden, np.float64)
        self._t_last = 0.0
        self._t_next = np.inf

    @staticmethod
    def _sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    def _gru(self, h, tau):
        g = self.weights["gru"]
        x = np.array([tau, np.log1p(tau)], np.float64)
        r = self._sigmoid(x @ g["ir"]["kernel"] + g["ir"]["bias"]
                          + h @ g["hr"]["kernel"])
        z = self._sigmoid(x @ g["iz"]["kernel"] + g["iz"]["bias"]
                          + h @ g["hz"]["kernel"])
        n = np.tanh(x @ g["in"]["kernel"] + g["in"]["bias"]
                    + r * (h @ g["hn"]["kernel"] + g["hn"]["bias"]))
        return (1.0 - z) * n + z * h

    def _head(self, h):
        a = float(h @ np.asarray(self.weights["v"]["kernel"])[:, 0]
                  + np.asarray(self.weights["v"]["bias"])[0])
        return a, float(np.asarray(self.weights["w"]))

    def _sample_delta(self):
        a, w = self._head(self.h)
        e = self.random_state.exponential()
        if abs(w) < 1e-6:
            return e * np.exp(-a)  # w ~ 0: constant intensity exp(a)
        z = w * e * np.exp(-a)
        # w < 0: finite total hazard exp(a)/(-w); a draw beyond it means
        # the process never fires again.
        return np.log1p(z) / w if z > -1.0 else np.inf

    def init_state(self, start_time, all_sink_ids, follower_sink_ids,
                   end_time):
        super().init_state(start_time, all_sink_ids, follower_sink_ids,
                           end_time)
        self.h = np.zeros(self.hidden, np.float64)
        self._t_last = self.start_time

    def get_next_event_time(self, event: Optional[Event]) -> float:
        if event is None:
            self._t_next = self.start_time + self._sample_delta()
        elif event.src_id == self.src_id:
            tau = event.cur_time - self._t_last
            self.h = self._gru(self.h, tau)
            self._t_last = event.cur_time
            self._t_next = event.cur_time + self._sample_delta()
        return self._t_next


class Manager:
    """Event-loop simulation driver (reference: ``Manager``).

    The hot loop (SURVEY.md section 3.1): ask every source for its next event
    time, pop the global minimum (ties broken by LOWEST source position — the
    engines' argmin must match this exactly), apply the event to world
    state, and notify every source so it can re-decide.
    """

    def __init__(self, sources: Sequence[Broadcaster], sink_ids: Sequence,
                 edge_list: Dict, end_time: float, start_time: float = 0.0):
        self.sources = list(sources)
        self.sink_ids = list(sink_ids)
        self.edge_list = {k: list(v) for k, v in edge_list.items()}
        self.end_time = float(end_time)
        self.start_time = float(start_time)
        self.state = State(start_time)
        self._last_self_time = {s.src_id: None for s in self.sources}
        self._t_next: Optional[np.ndarray] = None  # lazily drawn on first run
        self._event_id = 0
        for src in self.sources:
            src.init_state(
                start_time, self.sink_ids, self.edge_list[src.src_id], end_time
            )

    def run_till(self, end_time: Optional[float] = None, max_events: Optional[int] = None) -> "Manager":
        """Run the event loop up to ``end_time`` (or ``max_events`` more
        events). Re-entrant: a second call continues from the current state
        rather than re-initializing the broadcasters."""
        T = self.end_time if end_time is None else float(end_time)
        if self._t_next is None:
            self._t_next = np.array(
                [src.get_next_event_time(None) for src in self.sources],
                dtype=np.float64,
            )
        t_next = self._t_next
        event_id = self._event_id
        events_this_call = 0
        while True:
            k = int(np.argmin(t_next))  # first occurrence = lowest source index
            t = t_next[k]
            if not np.isfinite(t) or t > T:
                break
            src = self.sources[k]
            prev = self._last_self_time[src.src_id]
            delta = t - (self.start_time if prev is None else prev)
            self._last_self_time[src.src_id] = t
            ev = Event(event_id, t, delta, src.src_id, self.edge_list[src.src_id])
            self.state.apply_event(ev)
            event_id += 1
            events_this_call += 1
            for j, s in enumerate(self.sources):
                t_next[j] = s.get_next_event_time(ev)
            if max_events is not None and events_this_call >= max_events:
                break
        self._event_id = event_id
        return self

    # Name kept for parity with the reference API surface.
    def run_dynamic(self, max_events: int) -> "Manager":
        return self.run_till(max_events=max_events)


class SimOpts:
    """Experiment config / manager factory (reference: ``SimOpts``).

    Bundles the follower set, the broadcaster->follower edge list, the "other
    source" specs, the horizon, and the Opt hyperparameters (q, s). Factory
    methods build a Manager with the controlled broadcaster swapped per policy
    — the reference's policy-pluggable seam (SURVEY.md section 1).
    """

    _WALL_REGISTRY: Dict[str, Callable] = {}

    def __init__(self, src_id, sink_ids, other_sources, end_time,
                 q: float = 1.0, s: Optional[Dict] = None, start_time: float = 0.0,
                 edge_list: Optional[Dict] = None):
        self.src_id = src_id
        self.sink_ids = list(sink_ids)
        # other_sources: list of (kind, kwargs) where kwargs contains src_id,
        # sink_ids (the feeds it posts into) and policy parameters.
        self.other_sources = list(other_sources)
        self.end_time = float(end_time)
        self.q = float(q)
        self.s = s
        self.start_time = float(start_time)
        # Controlled broadcaster posts to every sink unless an edge_list says otherwise.
        self.edge_list = edge_list

    def update(self, d: Dict) -> "SimOpts":
        kw = dict(
            src_id=self.src_id, sink_ids=self.sink_ids,
            other_sources=self.other_sources, end_time=self.end_time,
            q=self.q, s=self.s, start_time=self.start_time,
            edge_list=self.edge_list,
        )
        kw.update(d)
        return SimOpts(**kw)

    def _make_others(self) -> List[Broadcaster]:
        out = []
        for kind, kwargs in self.other_sources:
            kw = dict(kwargs)
            kw.pop("sink_ids", None)  # connectivity lives in the edge list
            kind_l = kind.lower()
            if kind_l == "poisson":
                out.append(Poisson(kw.pop("src_id"), kw.pop("seed"), **kw))
            elif kind_l == "poisson2":
                out.append(Poisson2(kw.pop("src_id"), kw.pop("seed"), **kw))
            elif kind_l == "hawkes":
                out.append(Hawkes(kw.pop("src_id"), kw.pop("seed"), **kw))
            elif kind_l == "piecewiseconst":
                out.append(PiecewiseConst(kw.pop("src_id"), kw.pop("seed"), **kw))
            elif kind_l == "realdata":
                out.append(RealData(kw.pop("src_id"), **kw))
            else:
                raise ValueError(f"unknown other-source kind: {kind}")
        return out

    def _other_edges(self) -> Dict:
        edges = {}
        for kind, kwargs in self.other_sources:
            edges[kwargs["src_id"]] = list(kwargs.get("sink_ids", self.sink_ids))
        return edges

    def _manager(self, our: Broadcaster) -> Manager:
        edge_list = dict(self._other_edges())
        if self.edge_list is not None:
            edge_list.update({k: list(v) for k, v in self.edge_list.items()})
        edge_list.setdefault(self.src_id, list(self.sink_ids))
        sources = [our] + self._make_others()
        return Manager(sources, self.sink_ids, edge_list, self.end_time,
                       self.start_time)

    def create_manager_with_opt(self, seed: int) -> Manager:
        return self._manager(Opt(self.src_id, seed, q=self.q, s=self.s))

    def create_manager_with_poisson(self, seed: int, rate: float) -> Manager:
        return self._manager(Poisson(self.src_id, seed, rate=rate))

    def create_manager_with_piecewise_const(self, seed: int, change_times, rates) -> Manager:
        return self._manager(
            PiecewiseConst(self.src_id, seed, change_times=change_times, rates=rates)
        )

    def create_manager_with_times(self, times) -> Manager:
        """RealData replay of the controlled broadcaster (reference:
        ``create_manager_with_times`` — real user posting trace)."""
        return self._manager(RealData(self.src_id, times=times))

    def create_manager_with_rmtpp(self, seed: int, weights,
                                  hidden: int) -> Manager:
        """RMTPP neural-intensity controlled broadcaster (BASELINE config
        5); ``weights`` = the flax RMTPPCell tree as nested NumPy dicts."""
        return self._manager(
            RMTPP(self.src_id, seed, weights=weights, hidden=hidden)
        )

    def create_manager_with_broadcaster(self, broadcaster: Broadcaster) -> Manager:
        """Open seam: any Broadcaster implementation (the reference's Opt-subclass
        registration point, per BASELINE.json north star)."""
        assert broadcaster.src_id == self.src_id
        return self._manager(broadcaster)
