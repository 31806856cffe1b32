"""RedQueen's optimal broadcaster (the JAX package's ``models/opt.py``;
Zarezade et al., arXiv:1610.05773, Algorithm 1).

It posts with intensity u*(t) = sum_i sqrt(s_i / q) r_i(t) over its
followers' ranks, sampled by superposition: each rank increment of
follower i starts an Exp(sqrt(s_i / q)) clock and the earliest wins, so
when another source posts into some of its followers' feeds, one draw
against the summed rate of the affected followers gives its new
candidate, and its own post cancels every clock.

Both react paths of the JAX package are kept.  Up to
:data:`UNROLL_MAX_OPT_ROWS` Opt rows (``cfg.opt_rows``) the update loops
over those rows; past that, one masked update covers every source.  They
read the same panel word (slot 1 + row) and are bit-equal.

**Reduction order.**  The affected rate sum is folded over the followers
one column at a time, ``((0 + x_0) + x_1) + ...``: that is the order in
which XLA on the CPU sums a last axis of up to 32 elements, and an
elementwise add is exact IEEE on CPU and CUDA alike, so the sum is the
JAX engine's bit for bit there (``torch.sum`` is not).  Above 32 followers
XLA sums in another order.  The sum depends only on the Opt row and the
fired source, so :func:`react_consts` folds it once per run for every
pair, and a step reads its lane's entry."""

from __future__ import annotations

import torch

from .base import KIND_OPT, PolicyDef, SourceUpdate, register_policy

# Up to this many Opt rows the react update loops over the rows; beyond
# it one masked update over all sources runs.  Both consume the same
# panel words and are bit-equal, so the cutover is a performance choice.
UNROLL_MAX_OPT_ROWS = 4


def unrolled_rows(cfg):
    """The react rows whose panel words a step must provide, or None for
    every source (the masked path).  ``ops.scan_core`` sizes the panel with
    it and :func:`on_react` dispatches on it."""
    if (cfg is not None and cfg.present_kinds
            and len(cfg.opt_rows) <= UNROLL_MAX_OPT_ROWS):
        return tuple(cfg.opt_rows)
    return None


def _inf(x):
    return torch.full_like(x, float("inf"))


def on_init(params, state, t0, keys, rows):
    # Every rank starts at 0: intensity 0, no candidate.
    return SourceUpdate(t_next=_inf(params.rate))


def on_fire(params, state, fired, t, key, u, lanes):
    # Own post: every rank resets, every candidate clock is cancelled.
    return SourceUpdate(t_next=_inf(t))


def react_consts(cfg, params, adj):
    """For each lane, react row r (``cfg.opt_rows`` on the unrolled path,
    every source otherwise) and fired source s: whether they share a
    follower (``any [B, R, S]``) and the sum of sqrt(s_sink / q_r) over the
    followers they share (``rate_sum [B, R, S]``), folded column by
    column."""
    rows = unrolled_rows(cfg)
    S, F = adj.shape[-2:]
    idx = torch.arange(S, device=adj.device) if rows is None else \
        torch.tensor(rows, dtype=torch.int64, device=adj.device)
    adj = adj.to(torch.bool)
    adj_r = adj[:, idx, :]                                 # [B, R, F]
    rates = torch.sqrt(params.s_sink[:, None, :]
                       / params.q[:, idx, None])           # [B, R, F]
    B, R = adj_r.shape[:2]
    rate_sum = torch.zeros((B, R, S), dtype=rates.dtype, device=adj.device)
    shared = torch.zeros((B, R, S), dtype=torch.bool, device=adj.device)
    for f in range(F):
        hit = adj_r[:, :, f, None] & adj[:, None, :, f]   # [B, R, S]
        rate_sum = rate_sum + torch.where(
            hit, rates[:, :, f, None], torch.zeros_like(rate_sum))
        shared = shared | hit
    return {"rows": rows, "idx": idx, "rate_sum": rate_sum, "any": shared}


def _candidate(t, u, rate_sum):
    """t + Exp(rate_sum) from the panel word ``u``; +inf where the rate
    is 0."""
    draw = -torch.log1p(-u)
    return t + torch.where(rate_sum > 0, draw / rate_sum, _inf(draw))


def on_react(cfg, params, state, consts, fired, t, valid, us):
    """Superposition update of the Opt sources that did not fire:
    ``(t_next [B, S], bump [B, S])``, bump marking the sources that
    reacted (each took one draw)."""
    t_next = state.t_next
    pick = fired[:, None, None].expand(-1, consts["rate_sum"].shape[1], 1)
    rate_sum = torch.gather(consts["rate_sum"], 2, pick)[..., 0]   # [B, R]
    shared = torch.gather(consts["any"], 2, pick)[..., 0]          # [B, R]
    rows = consts["rows"]
    if rows is not None:
        t_next = t_next.clone()
        bump = torch.zeros_like(t_next, dtype=torch.bool)
        for i, row in enumerate(rows):
            react = (fired != row) & shared[:, i] & valid
            cand = _candidate(t, us[:, row], rate_sum[:, i])
            t_next[:, row] = torch.where(
                react, torch.minimum(t_next[:, row], cand), t_next[:, row])
            bump[:, row] = react
        return t_next, bump
    S = t_next.shape[1]
    src = torch.arange(S, device=t_next.device)
    react = ((params.kind == KIND_OPT) & (src[None, :] != fired[:, None])
             & shared & valid[:, None])
    cand = _candidate(t[:, None], us, rate_sum)
    return torch.where(react, torch.minimum(t_next, cand), t_next), react


OPT = register_policy(
    PolicyDef(kind=KIND_OPT, name="opt", on_init=on_init, on_fire=on_fire,
              on_react=on_react, react_consts=react_consts,
              fire_uses_key=False)
)
