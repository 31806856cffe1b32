"""The fused batch engine: the counterpart of the JAX package's
``ops/pallas_engine.py``.

A batch of components runs as lanes of one event kernel: each launch
advances every lane by ``k`` chunks of ``capacity`` events with the lane
state kept by the kernel across all of them, and the host checks one
liveness scalar per launch.  On CUDA tensors each launch is the
hand-written kernel (``ops/kernels.py``, ``csrc/event_kernel.cu``); on
CPU tensors it is the kernel's plain PyTorch version
(``ops/event_step.run_launch``).  There is no other route, and no
fallback from one to the other.

Randomness is the JAX engine's: every draw is threefry-2x32 on a
per-(component, source) key with a per-source counter, so a run here and
``simulate_pallas`` at the same integer seeds make the same draws."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..config import SimConfig, SourceParams
from ..device import DeviceLike, resolve_device
from ..models.base import (
    KIND_HAWKES,
    KIND_NAMES,
    KIND_OPT,
    KIND_PIECEWISE,
    KIND_POISSON,
    KIND_REALDATA,
)
from ..runtime import faultinject as _faultinject
from ..runtime import numerics as _numerics
from ..runtime import telemetry as _telemetry
from . import event_step, kernels
from .event_step import KernelSpec
from .sampling import piecewise_next_from_target
from .threefry import (
    MASK32,
    exponential_from_bits,
    from_bits32,
    threefry2x32,
    to_bits32,
)

__all__ = ["COVERED_KINDS", "coverage", "supports", "simulate_fused",
           "FusedState", "Prepared", "prepare", "drive", "launch"]

#: Policy kinds the event kernel implements (RMTPP is the scan engine's).
COVERED_KINDS = frozenset(
    (KIND_POISSON, KIND_OPT, KIND_HAWKES, KIND_REALDATA, KIND_PIECEWISE))


def coverage(cfg: SimConfig):
    """``(covered, reason)``: ``reason`` is None when the event kernel
    covers the config's policy mix, else why it does not."""
    kinds = set(cfg.present_kinds)
    if not kinds:
        return False, (
            "config carries no present_kinds (hand-built SimConfig) — "
            "build through GraphBuilder so the kernel can specialize")
    extra = kinds - COVERED_KINDS
    if extra:
        names = ", ".join(sorted(KIND_NAMES.get(k, f"kind{k}")
                                 for k in extra))
        return False, (
            f"policy kind(s) {{{names}}} have no fused-kernel "
            f"implementation (the RMTPP recurrence needs per-step hidden "
            f"state the megakernel does not carry) — the scan engine "
            f"covers them")
    return True, None


def supports(cfg: SimConfig) -> bool:
    """True iff the event kernel covers the config's policy mix."""
    return coverage(cfg)[0]


@dataclasses.dataclass(frozen=True)
class FusedState:
    """Engine state before the first launch, batch-first [B, ...];
    keys, counters and health words on the int64 carrier."""

    t_next: torch.Tensor    # [B, S] f32
    ctr: torch.Tensor       # [B, S]
    t: torch.Tensor         # [B] f32
    n_events: torch.Tensor  # [B] i32
    health: torch.Tensor    # [B]
    exc: torch.Tensor       # [B, S] Hawkes excitation
    exc_t: torch.Tensor     # [B, S] excitation fold time
    rd_ptr: torch.Tensor    # [B, S] i32 replay cursors
    k0: torch.Tensor        # [B, S] per-source keys
    k1: torch.Tensor


def _source_keys(seeds: torch.Tensor, S: int):
    """Per-(component, source) base keys: (k0, k1) = threefry(seed, 0;
    source, 0), as in the JAX engine."""
    seeds = seeds.to(torch.int64) & MASK32                # [B]
    src = torch.arange(S, dtype=torch.int64, device=seeds.device)
    return threefry2x32(seeds[:, None], 0, src[None, :], 0)  # [B, S] each


def _init_state(cfg: SimConfig, params: SourceParams,
                seeds: torch.Tensor) -> FusedState:
    """First draws for every covered kind from the init stream (counter
    word x1=2, one Exp(1) per source): Poisson inverts Exp(rate); Hawkes
    from an empty history is Exp(l0); RealData seeks the first replay
    time at or after the start; piecewise inverts its hazard."""
    B, S = params.kind.shape
    dev = params.rate.device
    k0, k1 = _source_keys(seeds, S)
    bits0, _ = threefry2x32(k0, k1, torch.zeros_like(k0), 2)
    e = exponential_from_bits(bits0)                      # [B, S]
    kind = params.kind
    kinds = set(cfg.present_kinds)
    f32 = torch.float32
    t0 = torch.tensor(cfg.start_time, dtype=f32, device=dev)
    inf = torch.full((B, S), float("inf"), dtype=f32, device=dev)
    rate_like = torch.where(kind == KIND_HAWKES, params.l0, params.rate)
    t_exp = torch.where(rate_like > 0,
                        t0 + e / torch.clamp(rate_like, min=1e-30), inf)
    t_next = torch.where((kind == KIND_POISSON) | (kind == KIND_HAWKES),
                         t_exp, inf)
    rd_ptr = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if KIND_REALDATA in kinds:
        rd = params.rd_times
        Kr = rd.shape[-1]
        # First replay timestamp >= t0 (searchsorted 'left' as a count).
        rd_ptr = (rd < t0).sum(-1).to(torch.int32)
        peek = torch.gather(
            rd, -1, torch.clamp(rd_ptr, max=Kr - 1)[..., None].long())[..., 0]
        t_rd = torch.where(rd_ptr < Kr, peek, inf)
        t_next = torch.where(kind == KIND_REALDATA, t_rd, t_next)
    if KIND_PIECEWISE in kinds:
        t_pw = piecewise_next_from_target(e, t0, params.pw_times,
                                          params.pw_rates)
        t_next = torch.where(kind == KIND_PIECEWISE, t_pw, t_next)
    return FusedState(
        t_next=t_next.to(f32),
        ctr=torch.zeros((B, S), dtype=torch.int64, device=dev),
        t=torch.full((B,), cfg.start_time, dtype=f32, device=dev),
        n_events=torch.zeros((B,), dtype=torch.int32, device=dev),
        health=torch.zeros((B,), dtype=torch.int64, device=dev),
        exc=torch.zeros((B, S), dtype=f32, device=dev),
        exc_t=torch.full((B, S), cfg.start_time, dtype=f32, device=dev),
        rd_ptr=rd_ptr, k0=k0, k1=k1,
    )


def _spec_for(cfg: SimConfig, S, F, Kr, Kp, k, capacity) -> KernelSpec:
    kinds = set(cfg.present_kinds)
    return KernelSpec(
        S=S, F=F, Kr=Kr, Kp=Kp, capacity=capacity, k=k,
        end_time=float(cfg.end_time), opt_rows=tuple(cfg.opt_rows),
        has_hawkes=KIND_HAWKES in kinds,
        has_rd=KIND_REALDATA in kinds, has_pw=KIND_PIECEWISE in kinds,
    )


@dataclasses.dataclass(frozen=True)
class Prepared:
    """Everything a run's launches need: the spec, the lanes-last kernel
    parameters, and the initial carry (both in the kernel's form)."""

    cfg: SimConfig
    spec: KernelSpec
    params: Dict[str, torch.Tensor]
    carry: Dict[str, torch.Tensor]
    B: int


def _as_seeds(seeds, device: torch.device) -> torch.Tensor:
    seeds = torch.as_tensor(np.asarray(seeds) if not isinstance(
        seeds, torch.Tensor) else seeds)
    if seeds.dim() != 1:
        raise ValueError(
            f"the fused engine takes integer seeds [B] (its per-source "
            f"threefry streams derive from them) — got shape "
            f"{tuple(seeds.shape)}; key-array seeds are a scan-engine "
            f"contract (sim.simulate_batch)")
    if seeds.dtype.is_floating_point or seeds.dtype == torch.bool:
        raise ValueError(f"seeds must be integers, got {seeds.dtype}")
    return seeds.to(device=device, dtype=torch.int64)


def prepare(cfg: SimConfig, params: SourceParams, adj: torch.Tensor, seeds,
            sync_every: int) -> Prepared:
    """Initial state (with the ``RQ_FAULT`` numeric fault applied) and the
    kernel's lanes-last inputs for a batch on ``params``' device."""
    ok, why = coverage(cfg)
    if not ok:
        raise ValueError(
            f"fused engine supports only "
            f"{{poisson, opt, hawkes, realdata, piecewise}} policy mixes "
            f"— {why}")
    dev = params.rate.device
    seeds = _as_seeds(seeds, dev)
    B, S = params.kind.shape
    if seeds.shape[0] != B:
        raise ValueError(f"got {seeds.shape[0]} seeds for {B} components")
    F = adj.shape[-1]
    kinds = set(cfg.present_kinds)
    Kr = params.rd_times.shape[-1] if KIND_REALDATA in kinds else 0
    Kp = params.pw_times.shape[-1] if KIND_PIECEWISE in kinds else 0
    spec = _spec_for(cfg, S, F, Kr, Kp, int(sync_every), int(cfg.capacity))

    state = _init_state(cfg, params, seeds)
    hit = _faultinject.active_numeric_lane(B)
    if hit is not None:
        state = _numerics.poison_lane(state, hit[0], hit[1])

    def lanes(x, dtype=None):
        x = x if dtype is None else x.to(dtype)
        return torch.movedim(x, 0, -1).contiguous()

    f32 = torch.float32
    p = {
        "kind": lanes(params.kind, torch.int32),
        "rate": lanes(params.rate, f32),
        "k0": lanes(to_bits32(state.k0)),
        "k1": lanes(to_bits32(state.k1)),
        "q": lanes(params.q, f32),
        "ssink": lanes(params.s_sink, f32),
        "adj": lanes(adj, f32),
        "l0": lanes(params.l0, f32),
        "alpha": lanes(params.alpha, f32),
        "beta": lanes(params.beta, f32),
        "rd_times": lanes(params.rd_times, f32),
        "pw_times": lanes(params.pw_times, f32),
        "pw_rates": lanes(params.pw_rates, f32),
    }
    carry = {
        "t_next": lanes(state.t_next),
        "ctr": lanes(to_bits32(state.ctr)),
        "t": state.t.contiguous(),
        "nev": state.n_events.contiguous(),
        "health": to_bits32(state.health).contiguous(),
        "exc": lanes(state.exc),
        "exc_t": lanes(state.exc_t),
        "rd_ptr": lanes(state.rd_ptr),
    }
    return Prepared(cfg=cfg, spec=spec, params=p, carry=carry, B=B)


LaunchFn = Callable[[KernelSpec, Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor]],
                    Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]]


def launch(spec: KernelSpec, params: Dict[str, torch.Tensor],
           carry: Dict[str, torch.Tensor]):
    """One launch on the tensors' device: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors."""
    if params["rate"].is_cuda:
        return kernels.launch_event_kernel(spec, params, carry)
    return event_step.run_launch(spec, params, carry)


def drive(prep: Prepared, launch_fn: LaunchFn, max_chunks: int):
    """The launch loop: launches of ``k`` chunks until no lane is both
    unfinished and healthy (ONE liveness scalar per launch), or the
    chunk allowance is spent (``RuntimeError``; never truncates).
    Returns ``(carry, times [B, E], srcs [B, E], dispatches)``."""
    spec, cfg = prep.spec, prep.cfg
    k, cap = spec.k, spec.capacity
    end = torch.tensor(float(cfg.end_time), dtype=torch.float32,
                       device=prep.carry["t"].device)
    max_kernel_chunks = max_chunks * (-(-cfg.capacity // cap))
    n_launches = -(-max_kernel_chunks // k)
    carry = prep.carry
    times_chunks: List[torch.Tensor] = []
    srcs_chunks: List[torch.Tensor] = []
    dispatches = 0
    # The JAX package's spans (``pallas_engine.simulate_pallas``): the
    # run, each launch's enqueue, the liveness sync that waits for it,
    # and the launch count.
    with _telemetry.span("engine.pallas.run", k=k, capacity=cap,
                         lanes=prep.B) as run_span:
        try:
            for _ in range(n_launches):
                with _telemetry.span("engine.pallas.launch"):
                    carry, times_sc, srcs_sc = launch_fn(
                        spec, prep.params, carry)
                dispatches += 1
                times_chunks.append(times_sc)
                srcs_chunks.append(srcs_sc)
                # A frozen sick lane counts as done, or it would spin the
                # loop to max_chunks; torch.amin keeps a NaN clock NaN
                # (not done).
                with _telemetry.span("engine.pallas.sync"):
                    alive = torch.any(
                        (torch.amin(carry["t_next"], dim=0) <= end)
                        & (carry["health"] == 0))
                    done = not bool(alive)  # the one host sync a launch
                if done:
                    break
            else:
                raise RuntimeError(
                    f"simulation still active after {max_kernel_chunks} "
                    f"chunks of {cap} events ({dispatches} superchunk "
                    f"launches) — raise capacity or max_chunks (refusing "
                    f"to truncate silently)")
        finally:
            run_span.set(dispatches=dispatches)
    _telemetry.counter("engine.pallas.launches", dispatches)
    times = torch.cat(times_chunks, dim=0).T   # [B, E]
    srcs = torch.cat(srcs_chunks, dim=0).T
    return carry, times, srcs, dispatches


def simulate_fused(cfg: SimConfig, params: SourceParams, adj, seeds,
                   max_chunks: int = 100, sync_every: int = 8,
                   device: DeviceLike = "cuda"):
    """Run a batch of components on the event kernel on ``device`` (the
    card by default; ``"cpu"`` runs the kernel's plain version); returns
    an ``EventLog``.  ``params``/``adj`` carry a leading [B] dim and are
    moved to ``device``; ``seeds`` is an integer array [B].
    ``sync_every`` is k, the chunks per launch; ``EventLog.dispatches``
    counts the launches.  Raises ``NumericalHealthError`` when every lane
    died."""
    from ..sim import EventLog  # local: sim imports this module

    dev = resolve_device(device)
    with _telemetry.span("fused.prepare"):
        params = params.to(dev)
        adj = torch.as_tensor(adj).to(dev)
        prep = prepare(cfg, params, adj, seeds, sync_every)
    carry, times, srcs, dispatches = drive(prep, launch, max_chunks)
    with _telemetry.span("fused.log"):
        # The run's one results boundary: health crosses to the host once.
        health = from_bits32(carry["health"])
        health_host = health.cpu().numpy()
        if health_host.size and np.all(health_host != 0):
            raise _numerics.NumericalHealthError(
                health_host, context=f"fused simulation of {health_host.size} "
                                     f"lane(s)")
        return EventLog(times, srcs, carry["nev"], cfg, health=health,
                        dispatches=dispatches,
                        engine="cuda" if times.is_cuda else "plain")
