"""Simulation entry points of the port: the counterpart of
``redqueen_tpu.sim``.

- ``simulate`` runs one component to its horizon;
- ``simulate_batch`` runs a batch of same-shape components (params and
  adjacency with a leading ``[B]``) in lockstep;
- ``resume`` goes on from a ``SimState`` that a run returned.

Two engines run a batch.  The scan engine (``ops/scan_core.py``, the
default, as in the JAX package) is PyTorch ops, one event of every lane
per step, and serves every contract: ``max_events``, ``return_state``,
key-array seeds and every policy kind, the RMTPP neural policy
included.  The fused engine
(``ops/event_engine.py``) runs the hand-written CUDA event kernel on the
card (its plain version on the CPU); ``engine="fused"`` (or the JAX
package's name for it, ``"pallas"``) forces it and ``engine="auto"``
picks it where it covers the run (see :func:`select_engine`).

The scan engine runs chunks of ``cfg.capacity`` steps, up to
``sync_every`` of them (1 for the first) in one call of
:func:`_superchunk`, the counterpart of one superchunk dispatch of the
JAX package's ``sim._drive``; as there, the chunks stop once every lane
is done, so the log, ``n_events`` and ``dispatches`` equal the JAX
engine's.  A run that still has live lanes after ``max_chunks`` chunks
raises; it never truncates."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import models as _models  # noqa: F401  (registers the policies)
from .config import SimConfig, SimState, SourceParams, stack_components
from . import device as _device
from .device import DeviceLike, resolve_device
from .models import rmtpp
from .models.base import KIND_PIECEWISE, KIND_REALDATA, KIND_RMTPP
from .ops import kernels, prng
from .ops.event_engine import _spec_for, coverage, simulate_fused
from .ops.scan_core import RunChunk, init_state, make_run_chunk
from .ops.threefry import MASK32
from .runtime import faultinject as _faultinject
from .runtime import numerics as _numerics
from .runtime import telemetry as _telemetry
from .runtime.numerics import NumericalHealthError

__all__ = ["EventLog", "simulate", "simulate_batch", "resume",
           "select_engine", "init_state", "ENGINES", "NumericalHealthError"]

#: What ``engine=`` takes; ``"pallas"`` is the JAX package's name of the
#: fused engine and runs it.
ENGINES = ("scan", "fused", "pallas", "auto")


class EventLog:
    """The event log of a run.

    ``times``/``srcs`` are [B, E] tensors ([E] from :func:`simulate`);
    invalid tail entries hold (+inf, -1).  ``n_events`` [B] counts the
    valid events.  ``health`` [B] holds each lane's numeric-health word
    (the uint32 value of the JAX package's, on int64): 0 = healthy,
    non-zero = the lane was frozen when it went sick (decode with
    ``runtime.numerics.describe_health``).  ``engine`` says which route
    ran: ``"scan"`` (the scan engine), ``"cuda"`` (the hand-written
    kernel) or ``"plain"`` (its plain PyTorch version, for CPU tensors);
    ``engine_reason`` why an ``engine="auto"`` dispatch took the scan
    engine (None otherwise).  ``dispatches`` counts the superchunk calls
    of the scan engine, or the kernel launches of the fused one."""

    def __init__(self, times, srcs, n_events, cfg: SimConfig, health=None,
                 dispatches=None, engine="scan", engine_reason=None):
        self.times = times
        self.srcs = srcs
        self.n_events = n_events
        self.cfg = cfg
        self.health = health
        self.dispatches = dispatches
        self.engine = engine
        self.engine_reason = engine_reason

    @property
    def batched(self) -> bool:
        return self.times.dim() == 2

    def __repr__(self):
        sick = (_numerics.sick_lanes(self.health).size
                if self.health is not None else 0)
        return (
            f"EventLog(batched={self.batched}, engine={self.engine!r}, "
            f"buffer={tuple(self.times.shape)}, sick_lanes={sick})"
        )


def _check_kinds(cfg: SimConfig, params: SourceParams):
    """Reject a params row whose kind the config did not specialise for
    (it would otherwise run as a never-firing source)."""
    if not cfg.present_kinds:
        return
    present = set(cfg.present_kinds)
    got = set(int(k) for k in torch.unique(params.kind.cpu()))
    if not got.issubset(present):
        raise ValueError(
            f"params contain source kinds {sorted(got - present)} not in the "
            f"config's present_kinds {sorted(present)} — build params and "
            f"config from the same GraphBuilder structure"
        )


def _weight_leaves(tree, path=""):
    """``(path, tensor)`` per leaf of a weight tree, the path written as
    ``jax.tree_util.keystr`` writes it (``['gru']['ir']['kernel']``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _weight_leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _check_weights(cfg: SimConfig, params: SourceParams):
    """RMTPP rows need attached weights (``models.rmtpp.attach``), all
    finite, whose hidden size is the config's recurrent-state slot;
    catch each misuse on the host with a clear message instead of a
    never-firing source or a shape error inside the scan."""
    if params.rmtpp is not None:
        for path, leaf in _weight_leaves(params.rmtpp):
            if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
                raise ValueError(
                    f"params.rmtpp weight leaf {path} holds a non-finite "
                    f"value — refusing to deploy a diverged checkpoint as "
                    f"a broadcaster policy")
    if not bool((params.kind == KIND_RMTPP).any()):
        return
    if params.rmtpp is None:
        raise ValueError(
            "component has RMTPP sources but params.rmtpp is None — attach "
            "trained weights via redqueen_tpu_torch.models.rmtpp.attach("
            "params, w)")
    hidden = rmtpp.hidden_of(params.rmtpp)
    if hidden != cfg.rmtpp_hidden:
        raise ValueError(
            f"RMTPP weights have hidden={hidden} but the config was built "
            f"with rmtpp_hidden={cfg.rmtpp_hidden}; pass "
            f"GraphBuilder.build(rmtpp_hidden={hidden})")


# (field name, allow +inf): +inf is a legal padding value in the piecewise
# knots and replay timestamps; NaN and -inf never are.
_FINITE_FIELDS = (
    ("rate", False), ("l0", False), ("alpha", False), ("beta", False),
    ("q", False), ("s_sink", False), ("pw_times", True), ("pw_rates", False),
    ("rd_times", True),
)

# Fields larger than this skip the host check (it copies them to the
# host); the engines' lane-health mask is the backstop for them.
_FINITE_CHECK_MAX_ELEMS = 2_000_000


def _check_finite_params(cfg: SimConfig, params: SourceParams):
    """Reject non-finite parameters host-side with the field and flat
    index, instead of a quarantined lane later."""
    for field, allow_posinf in _FINITE_FIELDS:
        arr = getattr(params, field)
        if arr.numel() > _FINITE_CHECK_MAX_ELEMS:
            continue
        arr = arr.detach().cpu().numpy()
        bad = np.isnan(arr) | np.isneginf(arr)
        if not allow_posinf:
            bad |= np.isposinf(arr)
        if bad.any():
            flat = int(np.flatnonzero(bad.reshape(-1))[0])
            raise ValueError(
                f"SourceParams.{field} holds a non-finite value at flat "
                f"index {flat} ({arr.reshape(-1)[flat]!r}) — simulation "
                f"inputs must be finite ({'+inf padding allowed' if allow_posinf else 'no inf/NaN'}); "
                f"build components through GraphBuilder or fix the array "
                f"before dispatch"
            )


def _is_key_array(seeds) -> bool:
    return np.ndim(seeds) == 2


def _as_keys(seeds, device: torch.device) -> torch.Tensor:
    """Component keys ``[B, 2]`` from integer seeds ``[B]`` (as
    ``jax.random.PRNGKey``) or from key-array seeds ``[B, 2]`` (uint32
    words, taken as they are)."""
    a = np.asarray(seeds.detach().cpu() if isinstance(seeds, torch.Tensor)
                   else seeds)
    if a.dtype.kind not in "iu":
        raise ValueError(f"seeds must be integers, got {a.dtype}")
    a = torch.from_numpy(a.astype(np.int64))
    if a.dim() == 1:
        return prng.PRNGKey(a).to(device)
    if a.dim() == 2 and a.shape[1] == 2:
        return (a & MASK32).to(device)
    raise ValueError(
        f"seeds must be integers [B] or keys [B, 2], got shape "
        f"{tuple(a.shape)}")


def _maybe_poison(state: SimState, batch_size: int) -> SimState:
    """Apply the ``RQ_FAULT=numeric:<mode>@laneN`` fault to a fresh carry
    when it addresses a lane of this dispatch."""
    hit = _faultinject.active_numeric_lane(batch_size)
    if hit is None:
        return state
    lane, mode = hit
    return _numerics.poison_lane(state, lane, mode)


def _alive(state: SimState, end_time: float) -> torch.Tensor:
    """Lanes still running ``[B]``: a clock within the horizon, budget
    left, healthy (a frozen sick lane counts as done)."""
    a = torch.amin(state.t_next, 1) <= end_time
    if state.budget is not None:
        a &= state.n_events < state.budget
    if state.health is not None:
        a &= state.health == 0
    return a


def _superchunk(run: RunChunk, params, adj, state: SimState, consts, k: int):
    """Up to ``k`` chunks, stopping after the chunk that leaves every lane
    done: one superchunk dispatch of the JAX package's ``sim._drive``,
    whose loop checks its lanes after each chunk.  Returns ``(state,
    times, srcs, c, alive_any)`` for the ``c`` chunks run.

    The check is a host sync per chunk.  The host issues the step's
    operations one by one and the card keeps up with it, so a sync finds
    the card done (PERF.md section 5)."""
    end = run.cfg.end_time
    if k <= 0:
        with _telemetry.span("engine.scan.sync"):
            return state, None, None, 0, _device.host_read(
                _alive(state, end).any())
    times, srcs = [], []
    for _ in range(k):
        state, t_c, s_c = run(params, adj, state, consts)
        times.append(t_c)
        srcs.append(s_c)
        with _telemetry.span("engine.scan.sync"):
            alive_any = _device.host_read(_alive(state, end).any())
        if not alive_any:
            break
    return (state, torch.cat(times, 1), torch.cat(srcs, 1), len(times),
            alive_any)


def _drive(cfg: SimConfig, params: SourceParams, adj, state: SimState,
           max_chunks: int, sync_every: int):
    """The host loop over superchunks: the first of one chunk, every later
    one of ``sync_every``.  Returns ``(EventLog, state)``; the log counts
    only this call's events."""
    run = make_run_chunk(cfg)
    consts = run.consts(params, adj)
    n_before = state.n_events
    times_parts, srcs_parts = [], []
    n_chunks = dispatches = 0
    k = 1
    # The JAX package's spans (``sim._drive``): the drive, each
    # superchunk's enqueue and its liveness sync, and the dispatch count.
    with _telemetry.span("engine.scan.drive", batched=True) as dsp:
        try:
            while True:
                dispatches += 1
                with _telemetry.span("engine.scan.superchunk") as ssp:
                    ssp.set(k=k)
                    state, t_sc, s_sc, c, alive_any = _superchunk(
                        run, params, adj, state, consts,
                        min(k, max_chunks - n_chunks))
                k = sync_every
                if c:
                    times_parts.append(t_sc)
                    srcs_parts.append(s_sc)
                n_chunks += c
                if not alive_any:
                    break
                if n_chunks >= max_chunks:
                    raise RuntimeError(
                        f"simulation still active after {n_chunks} chunks "
                        f"of {cfg.capacity} events (events so far: "
                        f"{state.n_events.cpu().numpy()}); raise capacity "
                        f"or max_chunks — refusing to truncate silently")
        finally:
            dsp.set(dispatches=dispatches, chunks=n_chunks)
    _telemetry.counter("engine.scan.dispatches", dispatches)
    B = state.t.shape[0]
    dev = state.t.device
    times = torch.cat(times_parts, 1) if times_parts else \
        torch.empty((B, 0), dtype=torch.float32, device=dev)
    srcs = torch.cat(srcs_parts, 1) if srcs_parts else \
        torch.empty((B, 0), dtype=torch.int32, device=dev)
    log = EventLog(times, srcs, state.n_events - n_before, cfg,
                   health=state.health, dispatches=dispatches,
                   engine="scan")
    if state.health is not None:
        h = state.health.cpu().numpy()
        if h.size and np.all(h != 0):
            err = NumericalHealthError(
                h, context=f"simulation of {h.size} lane(s)")
            # The run's log and carry, for a caller whose other lanes
            # live elsewhere (a sharded run: parallel.shard).
            err.partial = (log, state)
            raise err
    return log, state


def select_engine(cfg: SimConfig, params: Optional[SourceParams] = None, *,
                  engine: str = "auto", max_events=None,
                  return_state: bool = False, platform: Optional[str] = None,
                  key_seeds: bool = False, sync_every: int = 8,
                  device: DeviceLike = "cuda") -> Tuple[str, Optional[str]]:
    """The engine a batch runs on -> ``(name, reason)``.

    ``"scan"`` runs the scan engine.  ``"fused"`` (or ``"pallas"``, the
    JAX package's name) forces the event kernel and raises ``ValueError``
    with the reason when it cannot run; the name returned is ``"fused"``.
    ``"auto"`` picks the kernel when (a) it covers the policy mix
    (``event_engine.coverage``), (b) the shape fits it
    (``kernels.check_kernel_shape``, which needs ``params`` for the
    replay and piecewise widths), (c) no scan-only contract is asked for
    (``max_events``, ``return_state``, key-array seeds) and (d) the
    platform is the card: ``platform`` (``"cuda"``) where given, else
    ``device``'s type; otherwise the scan engine, with ``reason`` saying
    why (``EventLog.engine_reason``)."""
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r} (choose scan, fused, pallas or "
            f"auto)")
    if engine == "scan":
        return "scan", None
    forced = engine in ("fused", "pallas")

    def fall(reason):
        if forced:
            raise ValueError(f"engine={engine!r} requested but {reason}")
        return "scan", reason

    ok, why = coverage(cfg)
    if not ok:
        return fall(why)
    if max_events is not None:
        return fall("the fused kernel has no run_dynamic budget — "
                    "max_events is a scan-engine contract")
    if return_state:
        return fall("the fused kernel's carry is its own (no SimState "
                    "for resume) — return_state is a scan-engine contract")
    if key_seeds:
        return fall("the fused engine takes integer seeds [B] — key-array "
                    "seeds ([B, 2]) are a scan-engine contract")
    if params is not None:
        kinds = set(cfg.present_kinds)
        spec = _spec_for(
            cfg, cfg.n_sources, cfg.n_sinks,
            params.rd_times.shape[-1] if KIND_REALDATA in kinds else 0,
            params.pw_times.shape[-1] if KIND_PIECEWISE in kinds else 0,
            int(sync_every), int(cfg.capacity))
        try:
            kernels.check_kernel_shape(spec)
        except ValueError as e:
            return fall(str(e))
    if platform is None:
        platform = torch.device(device).type
    if not forced and platform != "cuda":
        return "scan", ("the event kernel runs on the card — on the CPU "
                        "auto picks the scan engine (pass engine='fused' "
                        "to run the kernel's plain version)")
    return "fused", None


def _budget(max_events, B: int, device) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(np.asarray(max_events), dtype=torch.int32),
        (B,)).to(device).clone()


def simulate_batch(cfg: SimConfig, params: SourceParams, adj, seeds,
                   max_chunks: int = 100, return_state: bool = False,
                   max_events=None, sync_every: int = 8,
                   engine: str = "scan", slab: Optional[int] = None,
                   device: DeviceLike = "cuda"):
    """Run B same-shape components in lockstep (``params``/``adj`` with a
    leading batch axis; ``seeds`` integers [B] or keys [B, 2]).

    ``max_events`` (scalar or [B]) stops each lane after exactly that
    many events.  ``return_state`` also returns the final ``SimState``
    (pass it to :func:`resume`).  ``engine`` is ``"scan"`` (default),
    ``"fused"`` (alias ``"pallas"``) or ``"auto"``
    (:func:`select_engine`).  ``device`` is where the run happens, the
    card by default; the inputs are moved there.  ``sync_every`` is the chunks per host sync (per kernel launch
    on the fused engine) and ``max_chunks`` the allowance of
    ``cfg.capacity``-event chunks before the run raises.  ``slab``
    dispatches the batch in consecutive ``slab``-lane pieces with
    bit-identical per-lane results (``parallel.lanes.simulate_slabbed``;
    the log gains ``chunk_steps``); it has no ``return_state``."""
    dev = resolve_device(device)
    if slab is not None and slab < np.shape(seeds)[0]:
        if return_state:
            raise ValueError(
                "slab dispatch has no SimState handoff (per-slab carries "
                "cannot merge) — return_state is an unslabbed contract")
        from .parallel.lanes import simulate_slabbed

        return simulate_slabbed(
            cfg, params, adj, seeds, slab, max_chunks=max_chunks,
            sync_every=sync_every, max_events=max_events, engine=engine,
            device=dev)
    name, reason = select_engine(
        cfg, params, engine=engine, max_events=max_events,
        return_state=return_state, key_seeds=_is_key_array(seeds),
        sync_every=sync_every, device=dev)
    params = params.to(dev)
    adj = torch.as_tensor(adj).to(dev)
    _check_kinds(cfg, params)
    _check_finite_params(cfg, params)
    _check_weights(cfg, params)
    if name == "fused":
        _telemetry.event("engine.dispatch", engine="pallas",
                         requested=engine)
        _telemetry.counter("engine.dispatch.pallas")
        return simulate_fused(cfg, params, adj, seeds, max_chunks=max_chunks,
                              sync_every=sync_every, device=dev)
    # The choice and, for an auto request that fell back, why: the fact
    # EventLog.engine_reason carries, in the trace under the JAX
    # package's names.
    _telemetry.event("engine.dispatch", engine="scan", requested=engine,
                     reason=reason)
    _telemetry.counter("engine.dispatch.scan")
    keys = _as_keys(seeds, dev)
    B = keys.shape[0]
    state = _maybe_poison(init_state(cfg, params, adj, keys), B)
    if max_events is not None:
        state = state.replace(budget=_budget(max_events, B, dev))
    log, state = _drive(cfg, params, adj, state, max_chunks, sync_every)
    log.engine_reason = reason
    return (log, state) if return_state else log


def simulate(cfg: SimConfig, params: SourceParams, adj, seed,
             max_chunks: int = 100, return_state: bool = False,
             max_events: Optional[int] = None, sync_every: int = 8,
             device: DeviceLike = "cuda"):
    """Run one component (``params`` [S], ``adj`` [S, F]) on the scan
    engine; ``seed`` is an integer or a key [2].  The log is unbatched
    (``times``/``srcs`` [E], scalar ``n_events`` and ``health``); the
    returned state keeps a lane axis of 1, which :func:`resume` takes."""
    params, adj = stack_components([params], [torch.as_tensor(adj)])
    seeds = np.asarray(seed.detach().cpu() if isinstance(seed, torch.Tensor)
                       else seed)[None]
    out = simulate_batch(cfg, params, adj, seeds, max_chunks=max_chunks,
                         return_state=True, max_events=max_events,
                         sync_every=sync_every, device=device)
    log, state = out
    log = EventLog(log.times[0], log.srcs[0], log.n_events[0], cfg,
                   health=log.health[0], dispatches=log.dispatches)
    return (log, state) if return_state else log


def resume(cfg: SimConfig, params: SourceParams, adj, state: SimState,
           max_chunks: int = 100, max_events: Optional[int] = None,
           sync_every: int = 8):
    """Go on from a ``SimState`` a run returned, on the state's device,
    typically under a ``SimConfig`` with a later horizon: every policy
    keeps its true next event time, so the continued run is the
    continuous one.  ``max_events`` bounds this call's events (None
    clears any budget the state carries).  ``params``/``adj`` are
    batched like the state.  Returns ``(EventLog of this call, state)``;
    the log is batched."""
    dev = state.t.device
    params = params.to(dev)
    adj = torch.as_tensor(adj).to(dev)
    _check_kinds(cfg, params)
    _check_finite_params(cfg, params)
    _check_weights(cfg, params)
    budget = None
    if max_events is not None:
        budget = state.n_events + _budget(max_events, state.batch_size, dev)
    state = state.replace(budget=budget)
    return _drive(cfg, params, adj, state, max_chunks, sync_every)
