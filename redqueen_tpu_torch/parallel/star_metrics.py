"""Per-feed rank metrics of the star engine (step 3 of the design in
``bigf.py``): the closed form used on the hot path and its sequential
merge-scan twin, the test oracle — the counterpart of
``redqueen_tpu.parallel.star_metrics``, batched over lanes."""

from __future__ import annotations

import torch

from ..utils.metrics import FeedMetrics
from .star_types import StarConfig

__all__ = ["_feed_metrics_star", "_feed_metrics_star_scan",
           "_METRIC_FEED_BLOCK"]

# Feeds per metrics block: bounds the closed form's [lanes, block, E]
# intermediates at 100k-feed scale.
_METRIC_FEED_BLOCK = 8192


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in float64, rounded once to ``x``'s dtype:
    the card's reductions associate by the tensor's shape, and a float64
    sum makes a feed's value the same in any batch and on either device
    (but for a sum within 1e-16 of a float32 rounding boundary)."""
    return x.double().sum(-1).to(x.dtype)


def _window(cfg: StarConfig, B: int, dtype, dev):
    start = torch.full((B,), cfg.start_time, dtype=dtype, device=dev)
    end = torch.full((B,), cfg.end_time, dtype=dtype, device=dev)
    return start, end


def _feed_metrics_star(cfg: StarConfig, feed_times, own_times, K: int):
    """Per-feed rank integrals in closed form, no sequential pass.

    ``feed_times`` [B, F, E] ascending wall events; ``own_times`` [B, Kp]
    ascending posts.  Each wall event w raises the rank by one until the
    next own post (or the horizon) b, so int r dt = sum (b - w)^+ and,
    numbering walls 1..m within their window, int r^2 dt = sum (2i - 1)
    (b - w)^+; rank >= K holds exactly from a window's K-th wall to its
    end, so time in top K is (end - start) minus the K-th walls' spans.
    An own post at a wall's time applies first (the oracle's
    lowest-index pop).  Feeds go in blocks of ``_METRIC_FEED_BLOCK``.
    ``start_time``/``end_time`` of the result are [B]."""
    B, Fl, E = feed_times.shape
    dtype = feed_times.dtype
    dev = feed_times.device
    start = torch.tensor(cfg.start_time, dtype=dtype, device=dev)
    end = torch.tensor(cfg.end_time, dtype=dtype, device=dev)
    inf = torch.full((B, 1), float("inf"), dtype=dtype, device=dev)
    own_ext = torch.cat([own_times, inf], -1)                  # [B, Kp+1]
    # Window starts for counting walls: window 0 counts from -inf, so that
    # walls before start_time still build rank history.
    own_cnt = torch.cat([-inf, own_times], -1)                 # [B, Kp+1]
    ar = torch.arange(E, device=dev)
    tops, irs, ir2s = [], [], []
    for f0 in range(0, Fl, _METRIC_FEED_BLOCK):
        w = feed_times[:, f0:f0 + _METRIC_FEED_BLOCK].contiguous()  # [B, Fb, E]
        Fb = w.shape[1]
        nxt_idx = torch.searchsorted(
            own_times, w.reshape(B, Fb * E), right=True)       # [B, Fb*E]
        b = torch.minimum(torch.gather(own_ext, 1, nxt_idx), end)
        a = torch.gather(own_cnt, 1, nxt_idx)
        walls_before = torch.searchsorted(
            w.reshape(B * Fb, E), a.reshape(B * Fb, E)).reshape(B, Fb, E)
        i_e = ar - walls_before + 1                            # 1-based
        dt = torch.clamp(b.reshape(B, Fb, E) - torch.maximum(w, start),
                         min=0.0)
        irs.append(_sum(dt))
        ir2s.append(_sum((2.0 * i_e.to(dtype) - 1.0) * dt))
        # Padded wall slots (+inf) have dt = 0 and drop out of every sum.
        tops.append((end - start)
                    - _sum(torch.where(i_e == K, dt, torch.zeros_like(dt))))
    s, e = _window(cfg, B, dtype, dev)
    return FeedMetrics(
        time_in_top_k=torch.cat(tops, 1), int_rank=torch.cat(irs, 1),
        int_rank2=torch.cat(ir2s, 1),
        follows=torch.ones((B, Fl), dtype=torch.bool, device=dev),
        start_time=s, end_time=e)


def _feed_metrics_star_scan(cfg: StarConfig, feed_times, own_times, K: int):
    """The sequential merge-scan twin of :func:`_feed_metrics_star`: a
    two-pointer walk over each feed's walls and the own posts (an own
    post at a wall's time first).  The test oracle of the closed form;
    not on the hot path."""
    B, Fl, E = feed_times.shape
    Kp = own_times.shape[-1]
    dtype = feed_times.dtype
    dev = feed_times.device
    start = torch.tensor(cfg.start_time, dtype=dtype, device=dev)
    end = torch.tensor(cfg.end_time, dtype=dtype, device=dev)
    row = torch.cat([feed_times, torch.full((B, Fl, 1), float("inf"),
                                            dtype=dtype, device=dev)], -1)
    own = torch.cat([own_times, torch.full((B, 1), float("inf"),
                                           dtype=dtype, device=dev)], -1)
    own = own[:, None, :].expand(B, Fl, Kp + 1)
    i = torch.zeros((B, Fl, 1), dtype=torch.int64, device=dev)
    j = torch.zeros_like(i)
    r = torch.zeros((B, Fl), dtype=torch.int32, device=dev)
    t_prev = torch.full((B, Fl), cfg.start_time, dtype=dtype, device=dev)
    top = torch.zeros((B, Fl), dtype=dtype, device=dev)
    ir = torch.zeros_like(top)
    ir2 = torch.zeros_like(top)
    for _ in range(E + Kp):
        t_w = torch.gather(row, 2, i)[..., 0]
        t_o = torch.gather(own, 2, j)[..., 0]
        own_first = t_o <= t_w
        t = torch.minimum(t_w, t_o)
        valid = torch.isfinite(t)
        t_clip = torch.clamp(torch.where(valid, t, t_prev), start, end)
        dt = torch.clamp(t_clip - t_prev, min=0.0)
        rf = r.to(dtype)
        top = top + dt * (r < K).to(dtype)
        ir = ir + dt * rf
        ir2 = ir2 + dt * rf * rf
        r_new = torch.where(own_first, torch.zeros_like(r), r + 1)
        i = torch.where((valid & ~own_first)[..., None], i + 1, i)
        j = torch.where((valid & own_first)[..., None], j + 1, j)
        r = torch.where(valid, r_new, r)
        t_prev = torch.maximum(t_prev, t_clip)
    dt = torch.clamp(end - t_prev, min=0.0)
    rf = r.to(dtype)
    s, e = _window(cfg, B, dtype, dev)
    return FeedMetrics(
        time_in_top_k=top + dt * (r < K).to(dtype), int_rank=ir + dt * rf,
        int_rank2=ir2 + dt * rf * rf,
        follows=torch.ones((B, Fl), dtype=torch.bool, device=dev),
        start_time=s, end_time=e)
