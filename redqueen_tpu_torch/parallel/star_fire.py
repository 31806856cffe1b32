"""RedQueen (Opt) posting times of the star engine: the sorted suffix-min
formulation (step 2 of the design in ``bigf.py``), its two fire modes
(a loop over posts and pointer doubling) and the suffix-record
compression of the sort — the counterpart of
``redqueen_tpu.parallel.star_fire``, batched over lanes.

Ties in wall time: the JAX engine sorts ``(t, c)`` with ``lax.sort`` on
the key ``t`` alone, which is not stable.  Here ``t`` is sorted stably
and ``c`` gathered.  The order inside a group of equal ``t`` cannot
change a fire: every query is ``searchsorted(..., side="right")``, which
lands on a group boundary, and the suffix minimum at a group boundary
covers whole groups."""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..ops import prng
from . import comm
from .star_types import StarConfig

__all__ = ["_rec_cap", "_opt_fires", "_fires_by_doubling",
           "_fires_by_loop", "_resolve_fire_mode", "_check_fire_mode",
           "_FIRE_MODES", "LOOP_PROBE_EVERY"]

_FIRE_MODES = ("auto", "loop", "doubling")

#: Posts between two host checks of "is any lane still posting" in the
#: loop mode (a check is a host sync; the posts between two checks of a
#: finished lane are masked no-ops).
LOOP_PROBE_EVERY = 8


def _resolve_fire_mode(fire_mode: str, feed_sharded: bool = False,
                       device="cuda") -> str:
    """``"auto"`` -> the concrete mode, before any kernel cache is keyed:
    doubling on the card, the loop on the CPU (where the loop does about
    10x less work) and on a sharded feed axis (its one ``pmin`` a post
    keeps the records on their rank), as the JAX engine picks."""
    if fire_mode != "auto":
        return fire_mode
    return ("loop" if feed_sharded or torch.device(device).type == "cpu"
            else "doubling")


def _check_fire_mode(fire_mode: str, feed_sharded: bool = False):
    """Public-API validation, so that a typo'd mode fails on every config
    (non-Opt control never reaches :func:`_opt_fires`)."""
    if fire_mode not in _FIRE_MODES:
        raise ValueError(
            f"unknown fire_mode {fire_mode!r} (choose from {_FIRE_MODES})")
    if fire_mode == "doubling" and feed_sharded:
        raise ValueError(
            "fire_mode='doubling' needs the full sorted record arrays on "
            "every device; it does not support a sharded feed axis "
            "(use 'loop'/'auto')")


def _rec_cap(E: int) -> int:
    """Static per-feed suffix-record budget of the compressed fire path:
    about ln E records per feed when the superposition clocks are long
    against the inter-event gaps, up to E when they are short.  Overflow
    is checked and the caller retries uncompressed."""
    return int(max(64, 4 * np.ceil(np.log(max(E, 2)))))


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    """Right-to-left running minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values, [-1])


def _opt_fires(cfg: StarConfig, feed_times, rate_f, key_tau, feed_offset=0,
               compress: bool = True, fire_mode: str = "auto"):
    """RedQueen posting times via the sorted suffix-min formulation, per
    lane.

    ``feed_times`` [B, F, E] ascending wall events per feed; ``rate_f``
    [B, F] = sqrt(s_f / q); ``key_tau`` [B, 2].  Returns ``(own_times
    [B, post_cap], truncated [B], rec_trunc [B])``.

    One Exp clock per wall event, keyed ``fold_in(key_tau, f)`` by global
    feed index; candidate c = t + Exp / rate_f; the k+1-th post is
    min{c : t > post_k}.  Compression keeps only each feed's suffix
    records (events whose candidate is below every later one in the
    row), which are the only possible answers, in ``_rec_cap(E)`` slots;
    a feed with more records trips ``rec_trunc`` and the caller retries
    uncompressed.  ``fire_mode`` picks the loop or pointer doubling: the
    same fires, bit for bit."""
    B, Fl, E = feed_times.shape
    dev = feed_times.device
    dtype = feed_times.dtype
    inf = float("inf")
    compress = compress and E > _rec_cap(E)

    f_global = feed_offset + torch.arange(Fl, device=dev)
    keys = prng.fold_in(key_tau[:, None, :], f_global[None, :])  # [B, F, 2]
    draws = prng.exponential(keys, (E,)).to(dtype)
    cand = feed_times + draws / torch.clamp(rate_f[..., None], min=1e-30)
    cand = torch.where(rate_f[..., None] > 0, cand,
                       torch.full_like(cand, inf))

    if compress:
        suf_incl = _suffix_min(cand)
        suf_after = torch.cat(
            [suf_incl[..., 1:], torch.full_like(suf_incl[..., :1], inf)], -1)
        mask = cand < suf_after                  # +inf cands never qualify
        n_rec = mask.sum(-1)
        R = _rec_cap(E)
        rec_trunc = comm.pany((n_rec > R).reshape(B, -1).any(-1), "feed")
        pos = torch.clamp(torch.cumsum(mask.to(torch.int32), -1) - 1,
                          0, R - 1).long()
        val_t = torch.where(mask, feed_times, torch.full_like(cand, inf))
        val_c = torch.where(mask, cand, torch.full_like(cand, inf))
        base = torch.full((B, Fl, R), inf, dtype=dtype, device=dev)
        t_src = base.scatter_reduce(-1, pos, val_t, "amin")
        c_src = base.scatter_reduce(-1, pos, val_c, "amin")
    else:
        t_src, c_src = feed_times, cand
        rec_trunc = torch.zeros(B, dtype=torch.bool, device=dev)

    t_sorted, order = torch.sort(t_src.reshape(B, -1), dim=-1, stable=True)
    c_sorted = torch.gather(c_src.reshape(B, -1), -1, order)
    # suffix[i] = min candidate among the kept wall events with index >= i.
    suffix = torch.cat([_suffix_min(c_sorted),
                        torch.full((B, 1), inf, dtype=dtype, device=dev)], -1)

    sharded = comm.axis_present("feed")
    _check_fire_mode(fire_mode, feed_sharded=sharded)
    if _resolve_fire_mode(fire_mode, sharded, dev) == "doubling":
        own, truncated = _fires_by_doubling(cfg, t_sorted, suffix)
    else:
        own, truncated = _fires_by_loop(cfg, t_sorted, suffix)
    return own, truncated, rec_trunc


def _fires_by_loop(cfg: StarConfig, t_sorted, suffix):
    """The posting trajectory one post at a time for every lane, as the
    JAX engine's ``while_loop`` under ``vmap``: a lane whose last post is
    +inf or whose buffer is full stops moving; the host checks for a
    moving lane once every :data:`LOOP_PROBE_EVERY` posts.  On a sharded
    feed axis each post is the ``pmin`` of the ranks' candidates, so every
    rank holds the same posts and takes the same branches."""
    B, N = t_sorted.shape
    Kp = cfg.post_cap
    dev = t_sorted.device
    end = cfg.end_time
    inf = torch.tensor(float("inf"), dtype=t_sorted.dtype, device=dev)
    t_last = torch.full((B, 1), cfg.start_time, dtype=t_sorted.dtype,
                        device=dev)
    n = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    buf = torch.full((B, Kp), float("inf"), dtype=t_sorted.dtype,
                     device=dev)

    def moving():
        return torch.isfinite(t_last) & (n < Kp)

    while _device.host_read(moving().any()):
        for _ in range(LOOP_PROBE_EVERY):
            go = moving()
            idx = torch.searchsorted(t_sorted, t_last, right=True)
            t_next = comm.pmin(torch.gather(suffix, 1, idx), "feed")
            t_next = torch.where(t_next <= end, t_next, inf)
            slot = torch.clamp(n, max=Kp - 1)
            buf.scatter_(1, slot, torch.where(go, t_next,
                                              torch.gather(buf, 1, slot)))
            n = n + (go & torch.isfinite(t_next)).to(n.dtype)
            t_last = torch.where(go, t_next, t_last)
    # Overflow: a further post would still fit before the horizon.
    idx = torch.searchsorted(t_sorted, t_last, right=True)
    more = comm.pmin(torch.gather(suffix, 1, idx), "feed") <= end
    truncated = (torch.isfinite(t_last) & more)[:, 0]
    return buf, truncated


def _fires_by_doubling(cfg: StarConfig, t_sorted, suffix):
    """The posting trajectory by pointer doubling, the loop's fires bit
    for bit.  The fire map on positions is nxt[i] = searchsorted(t_sorted,
    suffix[i], 'right'), strictly forward, with position N (the appended
    +inf suffix slot) absorbing; the jump tables nxt^(2^p) fill all
    ``post_cap`` positions in ceil(log2(post_cap)) gather passes.  The
    horizon is clipped after the orbit: fires increase strictly, so the
    kept fires are a dense prefix as in the loop."""
    B, N = t_sorted.shape
    Kp = cfg.post_cap
    dev = t_sorted.device
    end = cfg.end_time
    nxt = torch.searchsorted(t_sorted, suffix, right=True)     # [B, N+1]
    p1 = torch.searchsorted(
        t_sorted, torch.full((B, 1), cfg.start_time, dtype=t_sorted.dtype,
                             device=dev), right=True)
    pos = torch.full((B, Kp), N, dtype=torch.int64, device=dev)
    pos[:, :1] = p1
    jump = nxt
    filled = 1
    while filled < Kp:
        take = min(filled, Kp - filled)
        pos[:, filled:filled + take] = torch.gather(jump, 1, pos[:, :take])
        filled += take
        if filled < Kp:
            jump = torch.gather(jump, 1, jump)
    raw = torch.gather(suffix, 1, pos)
    own = torch.where(raw <= end, raw, torch.full_like(raw, float("inf")))
    f_next = torch.gather(suffix, 1,
                          torch.gather(nxt, 1, pos[:, Kp - 1:]))[:, 0]
    truncated = torch.isfinite(own[:, Kp - 1]) & (f_next <= end)
    return own, truncated
