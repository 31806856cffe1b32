"""Simulation configuration and parameters, in PyTorch.

The counterpart of ``redqueen_tpu.config``: ``SimConfig`` is the frozen,
hashable static shape; ``SourceParams`` holds the per-source policy
parameters as tensors (struct-of-tensors over sources ``[S]``, or
``[B, S]`` once components are stacked); the adjacency is a bool tensor
``[S, F]``.  ``GraphBuilder`` validates every spec the way the JAX
builder does, with the same error types and messages, and builds the
same arrays, so a component built by either package carries across
unchanged (``convert.py``)."""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.base import (
    KIND_HAWKES,
    KIND_OPT,
    KIND_PIECEWISE,
    KIND_POISSON,
    KIND_REALDATA,
    KIND_RMTPP,
    N_KINDS,
    map_weights,
)
from .runtime.numerics import require_float32

__all__ = [
    "SimConfig", "SourceParams", "GraphBuilder", "stack_components",
    "check_piecewise", "ConfigValidationError", "CROSS_EXCITATION_WARN",
    "PARAM_FIELDS", "SimState", "STATE_FIELDS",
]

#: Share of off-diagonal branching mass above which a learned [D, D]
#: Hawkes matrix projected onto per-source walls is warned about (the
#: value of the JAX package's ``learn.control.CROSS_EXCITATION_WARN``).
CROSS_EXCITATION_WARN = 0.25


class ConfigValidationError(ValueError):
    """A component spec failed host-side domain validation; ``component``
    names the offending source index (None for builder-level arguments)."""

    def __init__(self, message: str, component: Optional[int] = None):
        self.component = component
        where = "" if component is None else f"source {component}: "
        super().__init__(f"{where}{message}")


def _require_finite(name: str, value, component: Optional[int] = None,
                    minimum: Optional[float] = None,
                    strict: bool = False) -> float:
    """One scalar domain check with a typed, component-addressed error."""
    v = float(value)
    if not np.isfinite(v):
        raise ConfigValidationError(
            f"{name} must be finite, got {v!r}", component)
    if minimum is not None:
        ok = v > minimum if strict else v >= minimum
        if not ok:
            op = ">" if strict else ">="
            raise ConfigValidationError(
                f"{name} must be {op} {minimum:g}, got {v!r}", component)
    return v


def check_piecewise(change_times, rates, component: Optional[int] = None):
    """Validate a piecewise-constant rate spec and return ``(ct, rates)``
    as float64 arrays: knots finite and strictly increasing, rates finite
    and non-negative."""
    ct = np.asarray(change_times, np.float64)
    r = np.asarray(rates, np.float64)
    if ct.shape != r.shape:
        raise ConfigValidationError(
            f"change_times and rates must have equal shapes, got "
            f"{ct.shape} vs {r.shape}", component
        )
    if ct.ndim != 1 or ct.size == 0:
        raise ConfigValidationError(
            f"change_times must be a non-empty 1-D array, got shape "
            f"{ct.shape}", component
        )
    if not np.isfinite(ct).all():
        raise ConfigValidationError(
            f"change_times must be finite, got {ct[~np.isfinite(ct)][0]!r} "
            f"at index {int(np.flatnonzero(~np.isfinite(ct))[0])}", component)
    if not np.all(np.diff(ct) > 0):
        raise ConfigValidationError(
            "change_times must be strictly increasing", component)
    bad = ~(np.isfinite(r) & (r >= 0))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ConfigValidationError(
            f"rates must be finite and >= 0, got {r[i]!r} at index {i}",
            component)
    return ct, r


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation shape; hashable.  ``present_kinds`` and
    ``opt_rows`` (filled by :meth:`GraphBuilder.build`) let the engine
    specialise to the kinds the component has."""

    n_sources: int
    n_sinks: int
    end_time: float
    start_time: float = 0.0
    capacity: int = 4096  # steps (= max events) per chunk
    rmtpp_hidden: int = 1
    present_kinds: tuple = ()
    opt_rows: tuple = ()


#: SourceParams tensor fields, in declaration order.
PARAM_FIELDS = ("kind", "rate", "l0", "alpha", "beta", "pw_times",
                "pw_rates", "rd_times", "q", "s_sink")


@dataclasses.dataclass(frozen=True)
class SourceParams:
    """Per-source policy parameters, struct-of-tensors over sources.

    Union layout: each policy reads only its own fields; rows of other
    policies hold benign defaults (rate 1, zero excitation, empty replay).
    ``s_sink`` is per follower ``[F]`` and shared by the component."""

    kind: torch.Tensor      # i32[S] policy code (models.base.KIND_*)
    rate: torch.Tensor      # f[S]   Poisson rate
    l0: torch.Tensor        # f[S]   Hawkes base rate
    alpha: torch.Tensor     # f[S]   Hawkes jump size
    beta: torch.Tensor      # f[S]   Hawkes decay
    pw_times: torch.Tensor  # f[S,Kp] piecewise segment starts (+inf padded)
    pw_rates: torch.Tensor  # f[S,Kp] piecewise rates
    rd_times: torch.Tensor  # f[S,Kr] replay timestamps (+inf padded)
    q: torch.Tensor         # f[S]   Opt posting cost
    s_sink: torch.Tensor    # f[F]   follower significance
    # Neural-policy weights (models.rmtpp): the flax-layout tree of
    # tensors, with a leading [B] once components are stacked.
    rmtpp: Optional[dict] = None

    def to(self, device: DeviceLike) -> "SourceParams":
        """A copy with every tensor (the RMTPP weights too) on
        ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, rmtpp=map_weights(lambda w: w.to(dev), self.rmtpp),
            **{f: getattr(self, f).to(dev) for f in PARAM_FIELDS})


#: SimState fields, in declaration order (``budget`` and ``health`` may
#: be None).
STATE_FIELDS = ("t", "t_next", "exc", "exc_t", "rd_ptr", "h", "key",
                "keys", "ctr", "n_events", "budget", "health")


@dataclasses.dataclass(frozen=True)
class SimState:
    """The scan engine's whole carry, batch-first: what a step needs from
    the last, and what :func:`redqueen_tpu_torch.sim.resume` needs to go
    on.  The fields are those of the JAX package's ``SimState``, each with
    a leading lane axis ``[B]``; keys, counters and health words are
    uint32 words on the int64 carrier (``ops.threefry``)."""

    t: torch.Tensor         # f32[B]      current time
    t_next: torch.Tensor    # f32[B,S]    next event per source (+inf = never)
    exc: torch.Tensor       # f32[B,S]    Hawkes excitation at exc_t
    exc_t: torch.Tensor     # f32[B,S]    excitation fold time
    rd_ptr: torch.Tensor    # i32[B,S]    RealData replay cursor
    h: torch.Tensor         # f32[B,S,H]  RMTPP recurrent state
    key: torch.Tensor       # [B,2]       component key (the step panel's)
    keys: torch.Tensor      # [B,S,2]     per-source base keys
    ctr: torch.Tensor       # [B,S]       per-source draw counters
    n_events: torch.Tensor  # i32[B]      events emitted so far
    # Absolute event count at which a lane stops (run_dynamic); None =
    # run to the horizon.
    budget: Optional[torch.Tensor] = None   # i32[B]
    # Numeric-health word (runtime.numerics BIT_*); non-zero freezes the
    # lane.  None only for states carried in without one.
    health: Optional[torch.Tensor] = None   # [B]

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)

    @property
    def batch_size(self) -> int:
        return int(self.t.shape[0])


_BENIGN = dict(rate=1.0, l0=1.0, alpha=0.0, beta=1.0, q=1.0)


class GraphBuilder:
    """Assemble one simulation component (sources + sinks + edges) the way
    the reference's ``SimOpts`` does.  ``sinks=None`` connects a source to
    every sink."""

    def __init__(self, n_sinks: int, end_time: float, start_time: float = 0.0,
                 s_sink: Optional[Sequence[float]] = None):
        self.n_sinks = int(n_sinks)
        self.end_time = _require_finite("end_time", end_time)
        self.start_time = _require_finite("start_time", start_time)
        if not self.end_time > self.start_time:
            raise ConfigValidationError(
                f"end_time must be > start_time, got "
                f"[{self.start_time!r}, {self.end_time!r}]")
        self.s_sink = (
            np.ones(n_sinks) if s_sink is None else np.asarray(s_sink, np.float64)
        )
        if self.s_sink.shape != (self.n_sinks,):
            raise ValueError(
                f"s_sink must have shape ({self.n_sinks},), got "
                f"{self.s_sink.shape}"
            )
        bad = ~(np.isfinite(self.s_sink) & (self.s_sink >= 0))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ConfigValidationError(
                f"s_sink must be finite and >= 0, got {self.s_sink[i]!r} at "
                f"sink {i}")
        self._rows: List[dict] = []

    # ---- source constructors ----

    def _add(self, kind: int, sinks, **fields) -> int:
        idx = len(self._rows)
        sinks = range(self.n_sinks) if sinks is None else sinks
        row = dict(_BENIGN)
        row.update(kind=kind, sinks=list(sinks), pw=None, rd=None)
        row.update(fields)
        self._rows.append(row)
        return idx

    def add_poisson(self, rate: float, sinks=None) -> int:
        idx = len(self._rows)
        rate = _require_finite("Poisson rate", rate, idx, minimum=0.0)
        return self._add(KIND_POISSON, sinks, rate=rate)

    def add_hawkes(self, l0, alpha=None, beta=None, sinks=None):
        """One self-exciting source from scalars ``(l0, alpha, beta)``, or
        one source per dimension from a fitted model (anything with
        ``mu``/``alpha``/``beta`` arrays) or from ``(mu[D], alpha, beta[D])``
        arrays, where ``alpha`` may be a [D, D] matrix whose diagonal is
        kept (off-diagonal mass is warned about).  Returns the row index,
        or the list of row indices for array inputs."""
        if alpha is None and beta is None and all(
                hasattr(l0, f) for f in ("mu", "alpha", "beta")):
            fit = l0
            health = np.asarray(getattr(fit, "health", 0), np.uint32)
            sick = np.flatnonzero(np.atleast_1d(health))
            if sick.size:
                warnings.warn(
                    f"HawkesFit has {sick.size} quarantined dimension(s) "
                    f"{sick.tolist()[:8]} (health bits set): their "
                    f"parameters are sanitized fallbacks, not estimates "
                    f"— the corresponding sources will simulate the "
                    f"fallback", stacklevel=2)
            return self.add_hawkes(np.asarray(fit.mu),
                                   np.asarray(fit.alpha),
                                   np.asarray(fit.beta), sinks=sinks)
        if np.ndim(l0) > 0 or np.ndim(alpha) > 0 or np.ndim(beta) > 0:
            if alpha is None or beta is None:
                raise TypeError(
                    "add_hawkes takes (l0, alpha, beta) scalars, a "
                    "HawkesFit, or (mu[D], alpha, beta[D]) arrays — "
                    "array mu needs alpha and beta too")
            mu_v = np.atleast_1d(np.asarray(l0, np.float64))
            beta_v = np.atleast_1d(np.asarray(beta, np.float64))
            a_v = np.asarray(alpha, np.float64)
            if a_v.ndim == 2:
                b_safe = (beta_v if beta_v.shape == (a_v.shape[1],)
                          and (beta_v > 0).all()
                          else np.ones(a_v.shape[1]))
                br = np.abs(a_v) / np.maximum(b_safe[None, :], 1e-300)
                total = float(br.sum())
                off = total - float(np.abs(np.diag(br)).sum())
                if off > CROSS_EXCITATION_WARN * max(total, 1e-300):
                    warnings.warn(
                        f"alpha matrix carries substantial off-diagonal "
                        f"branching mass ({off / max(total, 1e-300):.1%}"
                        f"): per-source Hawkes walls are self-exciting "
                        f"only, so the simulation keeps the DIAGONAL "
                        f"and the feeds will be tamer than the fitted "
                        f"model", stacklevel=2)
                a_v = np.diag(a_v).copy()
            a_v = np.atleast_1d(a_v)
            if not (mu_v.shape == a_v.shape == beta_v.shape
                    and mu_v.ndim == 1):
                raise ConfigValidationError(
                    f"array add_hawkes needs matching [D] mu/alpha/beta "
                    f"(alpha may be [D, D]), got {mu_v.shape} / "
                    f"{a_v.shape} / {beta_v.shape}")
            return [self.add_hawkes(float(mu_v[k]), float(a_v[k]),
                                    float(beta_v[k]), sinks=sinks)
                    for k in range(len(mu_v))]
        if alpha is None or beta is None:
            raise TypeError(
                "add_hawkes takes (l0, alpha, beta) scalars, a HawkesFit, "
                "or (mu[D], alpha, beta[D]) arrays")
        idx = len(self._rows)
        l0 = _require_finite("Hawkes l0 (base rate)", l0, idx, minimum=0.0)
        alpha = _require_finite("Hawkes alpha (jump size)", alpha, idx,
                                minimum=0.0)
        beta = _require_finite("Hawkes beta (decay)", beta, idx,
                               minimum=0.0, strict=True)
        if alpha >= beta:
            warnings.warn(
                f"source {idx}: Hawkes branching ratio alpha/beta = "
                f"{alpha / beta:.3g} >= 1 (supercritical): the process is "
                f"non-stationary and its event count explodes with the "
                f"horizon; expect capacity overflows if this is not "
                f"deliberate", stacklevel=2)
        return self._add(KIND_HAWKES, sinks, l0=l0, alpha=alpha, beta=beta)

    def add_piecewise(self, change_times: Sequence[float],
                      rates: Sequence[float], sinks=None) -> int:
        idx = len(self._rows)
        return self._add(
            KIND_PIECEWISE, sinks,
            pw=check_piecewise(change_times, rates, component=idx))

    def add_realdata(self, times: Sequence[float], sinks=None) -> int:
        idx = len(self._rows)
        rd = np.asarray(times, np.float64)
        if rd.ndim != 1 or rd.size == 0:
            raise ConfigValidationError(
                f"replay times must be a non-empty 1-D array, got shape "
                f"{rd.shape}", idx)
        if not np.isfinite(rd).all():
            i = int(np.flatnonzero(~np.isfinite(rd))[0])
            raise ConfigValidationError(
                f"replay times must be finite, got {rd[i]!r} at index {i} "
                f"(+inf is reserved for the kernel's padding sentinel)", idx)
        if not np.all(np.diff(rd) >= 0):
            i = int(np.flatnonzero(np.diff(rd) < 0)[0])
            raise ConfigValidationError(
                f"replay times must be non-decreasing, but times[{i + 1}] = "
                f"{rd[i + 1]!r} < times[{i}] = {rd[i]!r} — sort the trace "
                f"(was it concatenated from shards?) before adding it", idx)
        return self._add(KIND_REALDATA, sinks, rd=rd)

    def add_opt(self, q: float = 1.0, sinks=None) -> int:
        idx = len(self._rows)
        if not (np.isfinite(q) and q > 0):
            raise ConfigValidationError(
                f"Opt requires finite q > 0, got q={q!r}", idx)
        return self._add(KIND_OPT, sinks, q=float(q))

    def add_rmtpp(self, sinks=None) -> int:
        """Neural-intensity broadcaster; its weights are attached after
        the build (``models.rmtpp.attach(params, weights)``)."""
        return self._add(KIND_RMTPP, sinks)

    # ---- assembly ----

    def build(self, capacity: int = 4096, dtype=torch.float32,
              rmtpp_hidden: Optional[int] = None,
              device: DeviceLike = "cuda"):
        """Returns ``(SimConfig, SourceParams, adjacency bool[S, F])`` with
        float32 parameters on ``device`` (the card by default); the
        positional order is the JAX builder's ``(capacity, dtype,
        rmtpp_hidden)``, and ``dtype`` must name float32.
        ``rmtpp_hidden`` sizes the recurrent-state slot: 16 by default
        when the component has an RMTPP source, else 1."""
        require_float32(dtype, "GraphBuilder.build")
        dev = resolve_device(device)
        S, F = len(self._rows), self.n_sinks
        if S == 0:
            raise ValueError("no sources added")
        if not int(capacity) >= 1:
            raise ConfigValidationError(
                f"capacity must be >= 1 scan step per chunk, got {capacity!r}")
        if rmtpp_hidden is not None and not int(rmtpp_hidden) >= 1:
            raise ConfigValidationError(
                f"rmtpp_hidden must be >= 1, got {rmtpp_hidden!r}")
        Kp = max([len(r["pw"][0]) for r in self._rows if r["pw"] is not None],
                 default=1)
        Kr = max([len(r["rd"]) for r in self._rows if r["rd"] is not None],
                 default=1)
        kind = np.zeros(S, np.int32)
        rate = np.empty(S); l0 = np.empty(S); alpha = np.empty(S)
        beta = np.empty(S); q = np.empty(S)
        pw_t = np.zeros((S, Kp)); pw_r = np.zeros((S, Kp))
        rd_t = np.full((S, Kr), np.inf)
        adj = np.zeros((S, F), bool)
        for s, row in enumerate(self._rows):
            kind[s] = row["kind"]
            rate[s], l0[s], alpha[s], beta[s], q[s] = (
                row["rate"], row["l0"], row["alpha"], row["beta"], row["q"]
            )
            adj[s, row["sinks"]] = True
            if row["pw"] is not None:
                ct, r = row["pw"]
                # +inf knots at rate 0 pad the profile: the last real
                # segment stays open to +inf and the pads add no hazard.
                pw_t[s] = np.inf
                pw_t[s, : len(ct)] = ct
                pw_r[s, : len(r)] = r
            else:
                pw_t[s] = np.inf
                pw_t[s, 0] = 0.0  # dummy row: one segment, rate 0
            if row["rd"] is not None:
                rd_t[s, : len(row["rd"])] = row["rd"]
        if int(kind.max()) >= N_KINDS:
            raise ValueError(
                f"source kind {int(kind.max())} has no registered policy "
                f"(registry has {N_KINDS} kinds)")
        if rmtpp_hidden is None:
            rmtpp_hidden = 16 if KIND_RMTPP in set(int(k) for k in kind) else 1
        cfg = SimConfig(
            n_sources=S, n_sinks=F, end_time=self.end_time,
            start_time=self.start_time, capacity=int(capacity),
            rmtpp_hidden=int(rmtpp_hidden),
            present_kinds=tuple(sorted(set(int(k) for k in kind))),
            opt_rows=tuple(s for s in range(S) if kind[s] == KIND_OPT),
        )

        def t(a, dt=torch.float32):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)

        params = SourceParams(
            kind=t(kind, torch.int32),
            rate=t(rate), l0=t(l0), alpha=t(alpha), beta=t(beta),
            pw_times=t(pw_t), pw_rates=t(pw_r), rd_times=t(rd_t), q=t(q),
            s_sink=t(self.s_sink),
        )
        return cfg, params, t(adj, torch.bool)


def stack_components(params_list: Sequence[SourceParams],
                     adj_list: Sequence[torch.Tensor]):
    """Stack same-layout components along a leading batch axis.  They
    must share the source-kind layout (which row is which policy); their
    parameters may differ freely.  RMTPP weights stack leaf by leaf, so
    they must be attached to all the components or to none."""
    k0 = params_list[0].kind
    k0_host = k0.cpu()
    for p in params_list[1:]:
        if p.kind is not k0 and not torch.equal(p.kind.cpu(), k0_host):
            raise ValueError(
                "stack_components: all components must share the same "
                "source-kind layout (got differing params.kind rows); build "
                "them from the same GraphBuilder structure"
            )
    params = SourceParams(
        rmtpp=map_weights(lambda *ws: torch.stack(ws),
                          *(p.rmtpp for p in params_list)),
        **{f: torch.stack([getattr(p, f) for p in params_list])
           for f in PARAM_FIELDS})
    return params, torch.stack(list(adj_list))
