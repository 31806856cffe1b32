"""Feed-rank metrics over the event log, in PyTorch (the counterpart of
``redqueen_tpu.utils.metrics``).

One pass over the log rebuilds the tracked source's rank in every
follower's feed and integrates time-in-top-K and the rank moments, with
the JAX package's operations in its order, so the values agree.  The
pass is a loop over log columns with [B, F] tensor operations; columns
after the last valid event of every lane add nothing and are skipped."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..runtime import telemetry as _telemetry

__all__ = ["FeedMetrics", "feed_metrics", "feed_metrics_batch", "num_posts"]


class FeedMetrics(NamedTuple):
    """Per-sink integrals over [start_time, end_time] for the tracked
    source; sinks it does not post to hold 0 and are left out of the
    means.  Tensors [F] (or [B, F] for batched logs)."""

    time_in_top_k: torch.Tensor  # int 1[r_i(t) < K] dt
    int_rank: torch.Tensor       # int r_i(t) dt
    int_rank2: torch.Tensor      # int r_i(t)^2 dt
    follows: torch.Tensor        # bool: tracked source posts into this feed
    start_time: torch.Tensor     # window start the integrals used
    end_time: torch.Tensor       # window end the integrals used

    def mean_time_in_top_k(self):
        n = torch.clamp(self.follows.sum(-1), min=1)
        return (self.time_in_top_k * self.follows).sum(-1) / n

    def mean_average_rank(self):
        n = torch.clamp(self.follows.sum(-1), min=1)
        return (self.int_rank * self.follows).sum(-1) / n / (
            self.end_time - self.start_time)


def _muladd(acc, a, b):
    """``acc + a * b`` rounded once, as the JAX package's compiled scan
    computes it (XLA contracts each multiply-add of the accumulation into
    one fused multiply-add): the float32 product is exact in float64, so
    only the sum rounds, to float64 and then to float32."""
    if acc.dtype != torch.float32:
        return acc + a * b
    return (acc.double() + a.double() * b.double()).float()


def feed_metrics_batch(times, srcs, adj, src_index, end_time, K: int = 1,
                       start_time: float = 0.0) -> FeedMetrics:
    """Metrics of a batched log ``times``/``srcs`` [B, E] against the
    components' adjacency [B, S, F] for tracked row ``src_index``.
    Events before ``start_time`` still build rank history."""
    with _telemetry.span("metrics.feed") as sp:
        dtype = times.dtype
        dev = times.device
        B, S, F = adj.shape
        follows = adj[:, src_index, :]                         # [B, F] bool
        end = torch.tensor(end_time, dtype=dtype, device=dev)
        start = torch.tensor(start_time, dtype=dtype, device=dev)
        r = torch.zeros((B, F), dtype=torch.int32, device=dev)
        t_prev = torch.full((B,), start_time, dtype=dtype, device=dev)
        top = torch.zeros((B, F), dtype=dtype, device=dev)
        ir = torch.zeros_like(top)
        ir2 = torch.zeros_like(top)
        lane = torch.arange(B, device=dev)
        # Columns after the last valid entry of every lane are no-ops.
        with _telemetry.span("metrics.feed.extent"):
            any_valid = torch.nonzero((srcs >= 0).any(0))
            n_rows = int(any_valid[-1]) + 1 if any_valid.numel() else 0
        sp.set(columns=n_rows)
        with _telemetry.span("metrics.feed.loop"):
            for col in range(n_rows):
                t, s = times[:, col], srcs[:, col]
                valid = s >= 0
                # Integrate the held rank over the in-window part of
                # [t_prev, t).
                t_clip = torch.clamp(torch.where(valid, t, t_prev), start, end)
                dt = torch.clamp(t_clip - t_prev, min=0.0)[:, None]
                rf = r.to(dtype)
                top = _muladd(top, dt, (r < K).to(dtype))
                ir = _muladd(ir, dt, rf)
                ir2 = _muladd(ir2, dt * rf, rf)
                # Then apply the event to the rank vector.
                hit = adj[lane, torch.clamp(s, min=0).long()] & follows
                own = (s == src_index)[:, None]
                r_new = torch.where(hit, torch.where(own, 0, r + 1), r)
                r = torch.where(valid[:, None], r_new, r).to(torch.int32)
                t_prev = torch.maximum(t_prev, t_clip)
            # Flush the final segment to the horizon.
            dt = torch.clamp(end - t_prev, min=0.0)[:, None]
            rf = r.to(dtype)
            top = _muladd(top, dt, (r < K).to(dtype))
            ir = _muladd(ir, dt, rf)
            ir2 = _muladd(ir2, dt * rf, rf)
        fl = follows.to(dtype)
        return FeedMetrics(
            time_in_top_k=top * fl, int_rank=ir * fl, int_rank2=ir2 * fl,
            follows=follows, start_time=start, end_time=end,
        )


def feed_metrics(times, srcs, adj, src_index, end_time, K: int = 1,
                 start_time: float = 0.0) -> FeedMetrics:
    """Metrics of one log [E] against its component's adjacency [S, F]."""
    m = feed_metrics_batch(times[None], srcs[None], adj[None], src_index,
                           end_time, K, start_time)
    return FeedMetrics(m.time_in_top_k[0], m.int_rank[0], m.int_rank2[0],
                       m.follows[0], m.start_time, m.end_time)


def num_posts(srcs, src_index):
    """Posting budget actually spent: the tracked source's event count.
    Works on [E] or [B, E]."""
    with _telemetry.span("metrics.num_posts"):
        return (srcs == src_index).sum(dim=-1)
