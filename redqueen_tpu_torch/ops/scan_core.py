"""The scan engine's step: the counterpart of the JAX package's
``ops/scan_core.py``, as PyTorch ops batched over lanes.

One step is one event in every lane of the batch: the lowest-index source
at the earliest clock fires, its resample runs through the policy of its
kind (``models``), and the react hooks re-decide the other sources.
Steps past the horizon, past a lane's event budget or in a sick lane
absorb: they emit ``(+inf, -1)`` and leave the carry as it was.  A chunk
is ``cfg.capacity`` steps; ``sim._drive`` runs the chunks.

**vmap semantics.**  The JAX engine ``vmap``s its chunk over the lanes.
Its ``lax.switch`` over the compiled kinds then computes every branch in
every lane and selects, and its thinning ``lax.while_loop`` steps every
lane until all are done, a finished lane's carry frozen.  Here each
compiled kind's ``on_fire`` runs on the whole batch and ``torch.where``
keeps, per lane, the one of the fired source's kind; work whose result is
never kept (thinning in lanes that did not fire a Hawkes source, or whose
step is not valid) is masked out, which changes no kept value.

**Two draw streams.**

- The step panel: ``threefry(component key; event index, pair |
  0x80000000)``, pair j giving the words of slots 2j and 2j + 1, through
  the 24-bit :func:`.threefry.uniform_from_bits`.  Slot 0 is the fire
  draw (Poisson), slot 1 + s source s's react draw (Opt).  Only the
  pairs :func:`panel_pairs` names are computed.
- Keyed draws, through the ``jax.random`` mirror :mod:`.prng` (23-bit
  uniforms): source keys ``fold_in(key, s)``, init keys
  ``fold_in(keys[s], 0)``, fire keys ``fold_in(keys[s*], ctr[s*])``, and
  thinning's ``split(key, 3)`` per proposal.  ``ctr`` is 1 after init and
  moves only when a compiled kind has ``fire_uses_key``: by one on each
  fire and on each Opt react.

**Reduction order.**  The Opt react rate sum is folded over the followers
column by column (``models/opt.py``), XLA's CPU order for up to 32
followers; nothing else in a step reduces floats.

Keys, counters and health words are uint32 words on the int64 carrier."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import SimConfig, SimState, SourceParams
from ..models.base import (
    KIND_HAWKES,
    KIND_REALDATA,
    KIND_RMTPP,
    at_source,
    get_registry,
)
from ..runtime import numerics
from ..runtime.numerics import nan_to_posinf, require_float32
from . import prng
from .threefry import MASK32, threefry2x32, uniform_from_bits

__all__ = ["kinds_for", "init_state", "panel_pairs", "make_run_chunk",
           "RunChunk"]

_INF = float("inf")
_PANEL_DOMAIN = 0x8000_0000


def kinds_for(cfg: SimConfig) -> List[int]:
    """The kinds the engine compiles: the config's ``present_kinds``, or
    every registered kind for a hand-built config."""
    return list(cfg.present_kinds) if cfg.present_kinds \
        else sorted(get_registry())


def _select(choice: torch.Tensor, new: Optional[torch.Tensor],
            old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``choice``, else ``old``; None echoes ``old``."""
    if new is None:
        return old
    return torch.where(choice, new, old)


def init_state(cfg: SimConfig, params: SourceParams, adj,
               key: torch.Tensor, dtype=torch.float32) -> SimState:
    """The initial carry of a batch: component keys ``key [B, 2]``,
    per-source keys ``fold_in(key, s)``, and every source's first draw
    from its init key ``fold_in(keys[s], 0)``.  A NaN first time or a
    failed sampler marks the lane sick from step 0 (the NaN becomes +inf).
    ``dtype`` must name float32."""
    require_float32(dtype, "init_state")
    B, S = params.kind.shape
    dev = params.rate.device
    f32 = torch.float32
    src = torch.arange(S, dtype=torch.int64, device=dev)
    keys = prng.fold_in(key[:, None, :], src[None, :])           # [B, S, 2]
    t0 = torch.tensor(cfg.start_time, dtype=f32, device=dev)
    inf = torch.full((B, S), _INF, dtype=f32, device=dev)
    state0 = SimState(
        t=t0.expand(B).clone(),
        t_next=inf,
        exc=torch.zeros((B, S), dtype=f32, device=dev),
        exc_t=t0.expand(B, S).clone(),
        rd_ptr=torch.zeros((B, S), dtype=torch.int32, device=dev),
        h=torch.zeros((B, S, cfg.rmtpp_hidden), dtype=f32, device=dev),
        key=key,
        keys=keys,
        ctr=torch.zeros((B, S), dtype=torch.int64, device=dev),
        n_events=torch.zeros((B,), dtype=torch.int32, device=dev),
        health=torch.zeros((B,), dtype=torch.int64, device=dev),
    )
    init_keys = prng.fold_in(keys, 0)
    reg = get_registry()
    t_next, exc, exc_t, rd_ptr = inf, state0.exc, state0.exc_t, state0.rd_ptr
    ok = torch.ones((B, S), dtype=torch.bool, device=dev)
    for k in kinds_for(cfg):
        rows = params.kind == k
        upd = reg[k].on_init(params, state0, t0, init_keys, rows)
        t_next = torch.where(rows, upd.t_next, t_next)
        exc = _select(rows, upd.exc, exc)
        exc_t = _select(rows, upd.exc_t, exc_t)
        rd_ptr = _select(rows, upd.rd_ptr, rd_ptr)
        ok = _select(rows, upd.ok, ok)
    bits = torch.where(torch.isnan(t_next).any(1),
                       numerics.BIT_NONFINITE_TIME, 0)
    bits |= torch.where((~ok).any(1), numerics.BIT_SAMPLER_FAILURE, 0)
    return state0.replace(
        t_next=nan_to_posinf(t_next), exc=exc, exc_t=exc_t, rd_ptr=rd_ptr,
        ctr=torch.ones((B, S), dtype=torch.int64, device=dev),
        health=bits.to(torch.int64))


def panel_pairs(cfg: SimConfig, has_react: bool) -> Tuple[int, ...]:
    """The threefry pairs covering the step's panel slots: slot 0 (the
    fire draw) and 1 + row for each unrolled Opt row, or every slot
    0..S for the masked react path."""
    from ..models.opt import unrolled_rows

    S = cfg.n_sources
    rows = unrolled_rows(cfg) if has_react else ()
    slots = list(range(S + 1)) if rows is None else [0] + [1 + r for r in rows]
    return tuple(sorted({s // 2 for s in slots}))


class RunChunk:
    """``run(params, adj, state, consts) -> (state, times [B, capacity],
    srcs [B, capacity])``: one chunk of the batch, specialised to the
    config's kinds.  ``consts(params, adj)`` computes, once per run, what
    every step reads."""

    def __init__(self, cfg: SimConfig):
        reg = get_registry()
        kinds = kinds_for(cfg)
        self.cfg = cfg
        self.fire = [(k, reg[k].on_fire) for k in kinds]
        self.reacts = [reg[k] for k in kinds if reg[k].on_react is not None]
        self.pairs = panel_pairs(cfg, bool(self.reacts))
        self.needs_fire_key = any(reg[k].fire_uses_key for k in kinds)
        self.has_hawkes = KIND_HAWKES in kinds
        self.has_realdata = KIND_REALDATA in kinds
        self.has_rmtpp = KIND_RMTPP in kinds
        # exc_t is the Hawkes fold time and RMTPP's last own event time.
        self.has_exc_t = self.has_hawkes or self.has_rmtpp
        # Panel word w of the pairs' words goes to slot w's place: word
        # 2i + j is word j of pair pairs[i], i.e. slot 2 * pairs[i] + j.
        S = cfg.n_sources
        col = [2 * len(self.pairs)] * (S + 1)   # the zero column
        for i, p in enumerate(self.pairs):
            for j in (0, 1):
                if 2 * p + j <= S:
                    col[2 * p + j] = 2 * i + j
        self._slot_col = col

    def consts(self, params: SourceParams, adj) -> Dict[str, object]:
        """What every step of a run reads: the panel's counters and slot
        map and the source indices on the run's device, and each react
        hook's constants (``react_consts``, or the adjacency)."""
        dev = params.rate.device
        return {
            "pairs": torch.tensor(self.pairs, dtype=torch.int64,
                                  device=dev) | _PANEL_DOMAIN,
            "slot_col": torch.tensor(self._slot_col, dtype=torch.int64,
                                     device=dev),
            "iota": torch.arange(self.cfg.n_sources, device=dev),
            "react": {pd.kind: (pd.react_consts(self.cfg, params, adj)
                                if pd.react_consts is not None else adj)
                      for pd in self.reacts},
        }

    def panel(self, state: SimState, consts) -> torch.Tensor:
        """The step's uniform panel ``[B, S + 1]`` (0 in slots no pair
        covers)."""
        ev = state.n_events.to(torch.int64)
        w0, w1 = threefry2x32(state.key[:, 0, None], state.key[:, 1, None],
                              ev[:, None], consts["pairs"][None, :])  # [B, P]
        vals = uniform_from_bits(torch.stack([w0, w1], -1).flatten(1))
        vals = torch.cat([vals, torch.zeros_like(vals[:, :1])], 1)
        return vals[:, consts["slot_col"]]

    def step(self, params: SourceParams, state: SimState, consts):
        """One event in every lane: ``(state, time [B], src [B])``."""
        t_next = state.t_next
        B, S = t_next.shape
        dev = t_next.device
        # argmin with the lowest index on ties; a NaN clock makes the
        # minimum NaN, the step invalid and the lane sick.
        t_ev = torch.amin(t_next, 1)
        s = torch.amin(torch.where(t_next == t_ev[:, None], consts["iota"],
                                   S), 1)
        s = torch.clamp(s, max=S - 1)
        health = state.health if state.health is not None \
            else torch.zeros((B,), dtype=torch.int64, device=dev)
        healthy = health == 0
        t_ev_bad = torch.isnan(t_ev)
        regressed = t_ev < state.t
        valid = (t_ev <= self.cfg.end_time) & healthy & ~regressed
        if state.budget is not None:
            valid &= state.n_events < state.budget

        us = self.panel(state, consts)
        key_fire = None
        if self.needs_fire_key:
            key_fire = prng.fold_in(at_source(state.keys, s),
                                    at_source(state.ctr, s))

        # The fired source's resample: every compiled kind's, the fired
        # kind's kept per lane.
        kind = at_source(params.kind, s)
        t_new = exc_new = exc_t_new = rd_new = h_new = ok = None
        if self.has_hawkes:
            exc_new = at_source(state.exc, s)
        if self.has_exc_t:
            exc_t_new = at_source(state.exc_t, s)
        if self.has_realdata:
            rd_new = at_source(state.rd_ptr, s)
        if self.has_rmtpp:
            h_new = at_source(state.h, s)
        for k, on_fire in self.fire:
            mine = kind == k
            upd = on_fire(params, state, s, t_ev, key_fire, us[:, 0],
                          valid & mine)
            t_new = upd.t_next if t_new is None else \
                torch.where(mine, upd.t_next, t_new)
            if self.has_hawkes:
                exc_new = _select(mine, upd.exc, exc_new)
            if self.has_exc_t:
                exc_t_new = _select(mine, upd.exc_t, exc_t_new)
            if self.has_realdata:
                rd_new = _select(mine, upd.rd_ptr, rd_new)
            if self.has_rmtpp:
                h_new = _select(mine[:, None], upd.h, h_new)
            if upd.ok is not None:
                # Kinds that cannot fail are ok; one kind is the lane's.
                ok_k = upd.ok | ~mine
                ok = ok_k if ok is None else ok & ok_k

        # Write-back checks: every one is an identity on healthy values.
        bits = torch.where(healthy & (t_ev_bad | regressed),
                           numerics.BIT_NONFINITE_TIME, 0)
        bits |= torch.where(valid & torch.isnan(t_new),
                            numerics.BIT_NONFINITE_TIME, 0)
        if ok is not None:
            bits |= torch.where(valid & ~ok,
                                numerics.BIT_SAMPLER_FAILURE, 0)
        if self.has_hawkes:
            bits |= torch.where(valid & ~torch.isfinite(exc_new),
                                numerics.BIT_NONFINITE_STATE, 0)
        if self.has_rmtpp:
            bits |= torch.where(valid & ~torch.isfinite(h_new).all(-1),
                                numerics.BIT_NONFINITE_STATE, 0)
        health = health | bits
        col = s[:, None]
        t_next_w = t_next.scatter(1, col, nan_to_posinf(t_new)[:, None])
        ctr = None
        if self.needs_fire_key:
            ctr = state.ctr.scatter(
                1, col, ((at_source(state.ctr, s) + 1) & MASK32)[:, None])

        # React hooks: the sources that did not fire re-decide.
        for pd in self.reacts:
            t_next_w, bumped = pd.on_react(
                self.cfg, params, state.replace(t_next=t_next_w),
                consts["react"][pd.kind], s, t_ev, valid, us[:, 1:])
            if ctr is not None:
                ctr = (ctr + bumped.to(torch.int64)) & MASK32

        # Absorbed steps leave the carry as it was.
        v1 = valid[:, None]
        fields = dict(
            t=torch.where(valid, t_ev, state.t),
            t_next=torch.where(v1, t_next_w, t_next),
            n_events=state.n_events + valid.to(torch.int32),
        )
        if state.health is not None:
            fields["health"] = health
        if ctr is not None:
            fields["ctr"] = torch.where(v1, ctr, state.ctr)
        if self.has_hawkes:
            fields["exc"] = torch.where(
                v1, state.exc.scatter(1, col, exc_new[:, None]), state.exc)
        if self.has_exc_t:
            fields["exc_t"] = torch.where(
                v1, state.exc_t.scatter(1, col, exc_t_new[:, None]),
                state.exc_t)
        if self.has_rmtpp:
            H = state.h.shape[-1]
            fields["h"] = torch.where(
                v1[..., None],
                state.h.scatter(1, col[..., None].expand(B, 1, H),
                                h_new[:, None, :]),
                state.h)
        if self.has_realdata:
            fields["rd_ptr"] = torch.where(
                v1, state.rd_ptr.scatter(1, col, rd_new[:, None]),
                state.rd_ptr)
        time = torch.where(valid, t_ev, torch.full_like(t_ev, _INF))
        src = torch.where(valid, s, -1).to(torch.int32)
        return state.replace(**fields), time, src

    def __call__(self, params: SourceParams, adj, state: SimState,
                 consts=None):
        if consts is None:
            consts = self.consts(params, adj)
        times, srcs = [], []
        for _ in range(self.cfg.capacity):
            state, t, s = self.step(params, state, consts)
            times.append(t)
            srcs.append(s)
        return state, torch.stack(times, 1), torch.stack(srcs, 1)


def make_run_chunk(cfg: SimConfig) -> RunChunk:
    """The chunk function of ``cfg`` (see :class:`RunChunk`)."""
    return RunChunk(cfg)
