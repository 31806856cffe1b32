"""Whole-stream samplers: every event of a source up to a horizon, the
counterpart of ``redqueen_tpu.ops.streams``.

The star engine's wall sources never react to anything, so each one's
whole stream samples on its own.  The JAX samplers take one source and
are vmapped; these take a batch of sources (leading axes ``[...]``, keys
``[..., 2]``) and give each the stream the JAX sampler gives it from the
same key.  A stream is a fixed-capacity, +inf-padded ascending times
tensor ``[..., cap]``, its valid count and a ``truncated`` flag, True
iff the buffer filled while events before the horizon remained (one
probe slot past the buffer makes the flag exact).

The Hawkes, piecewise and RMTPP samplers are a ``lax.scan`` over ``cap +
1`` slots in the JAX package.  Here they are loops that stop once every
source has absorbed (its clock at +inf): every later slot of the scan is
+inf, so the stream is the same.  The host checks for a live source
once every few steps (``sampling.PROBE_EVERY``).  On the card the Hawkes
sampler is one launch of a hand-written kernel instead, which walks each
source's stream to its end in one thread."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device
from ..models import rmtpp
from ..runtime import telemetry as _telemetry
from ..runtime.numerics import DEFAULT_MAX_PROPOSALS, safe_div, safe_exp
from . import kernels, prng, threefry
from .sampling import (
    PROBE_EVERY,
    hawkes_intensity,
    piecewise_next_time,
    rmtpp_next_delta,
    thinning_proposal,
)

__all__ = ["Stream", "poisson_stream", "hawkes_stream", "piecewise_stream",
           "realdata_stream", "rmtpp_stream"]

class Stream(NamedTuple):
    """Events on (t0, T]: ``times`` [..., cap] ascending, +inf-padded;
    ``n`` [...] valid events (int32); ``truncated`` [...] True iff
    capacity cut the stream."""

    times: torch.Tensor
    n: torch.Tensor
    truncated: torch.Tensor


def _finish(times: torch.Tensor, t0, T):
    valid = (times > t0) & (times <= T)
    times = torch.where(valid, times, torch.full_like(times, float("inf")))
    times = torch.sort(times, dim=-1).values
    return times, valid.sum(-1).to(torch.int32)


def poisson_stream(key, rate, t0, T, cap: int) -> Stream:
    """Constant-rate Poisson events on (t0, T]: the cumulative sum of
    ``cap + 1`` exponential gaps from one draw of the key, over the rate;
    the last is the truncation probe.  The sum runs in float64 and rounds
    once to float32 (what torch's CPU ``cumsum`` does), so that the card,
    whose ``cumsum`` associates by the tensor's shape, gives every stream
    the same times in any batch."""
    rate = torch.as_tensor(rate, dtype=torch.float32, device=key.device)
    gaps = prng.exponential(key, (cap + 1,))
    csum = torch.cumsum(gaps.double(), -1).float()
    times_all = t0 + torch.where(
        rate[..., None] > 0, safe_div(csum, rate[..., None]),
        torch.full_like(gaps, float("inf")))
    times, n = _finish(times_all[..., :cap], t0, T)
    truncated = (rate > 0) & (times_all[..., cap] <= T)
    return Stream(times, n, truncated)


def _slots(step, carry, shape, cap: int, device):
    """Run ``step(carry, i) -> (carry, t_new, live)`` over slots 0..cap and
    stack the ``t_new`` into ``[..., cap + 1]``; slots after the one that
    leaves no source live are +inf."""
    out = torch.full(tuple(shape) + (cap + 1,), float("inf"),
                     dtype=torch.float32, device=device)
    for i in range(cap + 1):
        carry, t_new, live = step(carry, i)
        out[..., i] = t_new
        if not _device.host_read(live.any()):
            break
    return out


def hawkes_stream(key, l0, alpha, beta, t0, T, cap: int) -> Stream:
    """Exponential-kernel Hawkes events on (t0, T], carrying the time and
    the excitation: slot i's event is Ogata thinning
    (``sampling.hawkes_next_time``) from ``fold_in(key, i)``.

    On the card one launch of the thinning kernel
    (``csrc/hawkes_thin.cu``) walks each source's whole stream in one
    thread and writes the finished stream; on the CPU the plain loop
    :func:`_hawkes_stream_plain` runs.  Both give the same bits."""
    if key.device.type == "cuda":
        return _hawkes_stream_kernel(key, l0, alpha, beta, t0, T, cap)
    return _hawkes_stream_plain(key, l0, alpha, beta, t0, T, cap)


def _hawkes_params(key, l0, alpha, beta):
    """``(shape, key [N, 2], l0, alpha, beta [N])``: the parameters
    broadcast to one shape and flattened, the key expanded to it."""
    l0, alpha, beta = torch.broadcast_tensors(*(
        torch.as_tensor(x, dtype=torch.float32, device=key.device)
        for x in (l0, alpha, beta)))
    shape = l0.shape
    N = l0.numel()
    return (shape, key.expand(shape + (2,)).reshape(N, 2), l0.reshape(-1),
            alpha.reshape(-1), beta.reshape(-1))


def _hawkes_stream_kernel(key, l0, alpha, beta, t0, T, cap: int) -> Stream:
    """:func:`hawkes_stream` on the card: one launch of the thinning
    kernel.  The most steps any source needed (``star.hawkes.steps``,
    exact) is read to the host only while telemetry records."""
    shape, key, l0, alpha, beta = _hawkes_params(key, l0, alpha, beta)
    times, n, truncated, steps = kernels.launch_hawkes_thin(
        threefry.to_bits32(key), l0.contiguous(), alpha.contiguous(),
        beta.contiguous(), t0, T, cap)
    _telemetry.counter("star.hawkes.kernel")
    if _telemetry.get().enabled:
        _telemetry.counter("star.hawkes.steps",
                           _device.host_read(steps)[0])
    _telemetry.counter("star.hawkes.host_reads", 0)
    return Stream(times.reshape(shape + (cap,)), n.reshape(shape),
                  truncated.reshape(shape))


def _hawkes_stream_plain(key, l0, alpha, beta, t0, T, cap: int) -> Stream:
    """The plain version of :func:`hawkes_stream`, on any device.

    The JAX sampler runs one thinning loop per slot, and every loop waits
    for the source that needs the most proposals.  Here each source moves
    through its own slots: one step is one proposal of every source still
    drawing, and a source that accepts starts its next slot's proposal
    chain at once.  Each slot sees the same proposals in the same order,
    so the stream is the same; the steps are the most proposals any one
    source makes in all, not the sum over slots of the most any source
    makes in that slot.  The host checks for a source still drawing once
    every ``PROBE_EVERY`` steps."""
    dev = key.device
    shape, key, l0, alpha, beta = _hawkes_params(key, l0, alpha, beta)
    N = l0.numel()
    inf = float("inf")
    out = torch.full((N, cap + 1), inf, dtype=torch.float32, device=dev)
    t = torch.full((N,), float(t0), dtype=torch.float32, device=dev)
    exc, exc_t = torch.zeros_like(t), t.clone()
    slot = torch.zeros((N, 1), dtype=torch.int64, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    # The current slot's proposal chain: its key, time, bound and count.
    pk = prng.fold_in(key, 0)
    tp, lbd = t, hawkes_intensity(t, l0, exc, exc_t, beta)
    n = torch.zeros(N, dtype=torch.int32, device=dev)

    def block(state):
        pk, tp, lbd, n, exc, exc_t, t, slot, done = state
        for _ in range(PROBE_EVERY):
            run = ~done & (tp <= T) & (lbd > 0) & (n < DEFAULT_MAX_PROPOSALS)
            pk_new, tp_new, lbd_new, acc = thinning_proposal(
                pk, tp, lbd, l0, exc, exc_t, beta)
            pk = torch.where(run[:, None], pk_new, pk)
            tp = torch.where(run, tp_new, tp)
            lbd = torch.where(run, lbd_new, lbd)
            n = n + run.to(torch.int32)
            fired = run & acc & (tp <= T)
            # A slot without an event absorbs the source: the thinning
            # stopped (past T, no intensity, the proposal cap) or accepted
            # past T.  Every later slot is +inf.
            absorbed = (~done & ~run) | (run & acc & ~fired)
            cur = torch.clamp(slot, max=cap)
            out.scatter_(1, cur, torch.where(fired[:, None], tp[:, None],
                                             out.gather(1, cur)))
            exc = torch.where(
                fired, exc * safe_exp(-beta * (tp - exc_t)) + alpha, exc)
            exc_t = torch.where(fired, tp, exc_t)
            t = torch.where(fired, tp, t)
            slot = slot + fired[:, None].to(torch.int64)
            done = done | absorbed | (slot[:, 0] > cap)
            nxt = fired & ~done      # the next slot's chain starts at t
            pk = torch.where(nxt[:, None], prng.fold_in(key, slot[:, 0]), pk)
            lbd = torch.where(nxt, hawkes_intensity(t, l0, exc, exc_t, beta),
                              lbd)
            n = torch.where(nxt, torch.zeros_like(n), n)
        return pk, tp, lbd, n, exc, exc_t, t, slot, done

    state = (pk, tp, lbd, n, exc, exc_t, t, slot, done)
    probes = 0
    while _device.host_read((~state[-1]).any()):
        probes += 1
        state = block(state)
    # Counted once a stream, not a step: PROBE_EVERY steps follow each
    # read that found a source still drawing, and one more read ends it.
    _telemetry.counter("star.hawkes.steps", PROBE_EVERY * probes)
    _telemetry.counter("star.hawkes.host_reads", probes + 1)
    out = out.reshape(shape + (cap + 1,))
    times, n_ev = _finish(out[..., :cap], t0, T)
    return Stream(times, n_ev, torch.isfinite(out[..., cap]))


def piecewise_stream(key, change_times, rates, t0, T, cap: int) -> Stream:
    """Inhomogeneous-Poisson events on (t0, T] for a piecewise-constant
    rate (``change_times``/``rates`` [..., K]), one exact-inversion draw
    per slot from ``fold_in(key, slot)``; a source absorbs once past the
    horizon."""
    dev = key.device
    change_times = torch.as_tensor(change_times, dtype=torch.float32,
                                   device=dev)
    rates = torch.as_tensor(rates, dtype=torch.float32, device=dev)
    shape = change_times.shape[:-1]
    key = key.expand(shape + (2,))
    inf = float("inf")

    def step(t, i):
        k = prng.fold_in(key, i)
        t_new = torch.where(torch.isfinite(t),
                            piecewise_next_time(k, t, change_times, rates),
                            torch.full_like(t, inf))
        t = torch.where(t_new > T, torch.full_like(t_new, inf), t_new)
        return t, t_new, torch.isfinite(t)

    t = torch.full(shape, float(t0), dtype=torch.float32, device=dev)
    times_all = _slots(step, t, shape, cap, dev)
    times, n = _finish(times_all[..., :cap], t0, T)
    return Stream(times, n, times_all[..., cap] <= T)


def realdata_stream(times, t0, T) -> Stream:
    """Replay of recorded timestamps ``[..., cap]`` (+inf-padded) clipped
    to (t0, T]."""
    times, n = _finish(torch.as_tensor(times, dtype=torch.float32), t0, T)
    return Stream(times, n, torch.zeros_like(n, dtype=torch.bool))


def rmtpp_stream(weights, key, t0, T, cap: int, hidden: int) -> Stream:
    """The RMTPP policy's events on (t0, T]: its intensity depends only on
    its own past, so the whole stream samples on its own, carrying the
    time and the hidden state.  Slot i draws its gap from ``fold_in(key,
    i)`` with the head of the current state; an event within the horizon
    advances the GRU by its gap, anything else absorbs the source.
    ``weights`` broadcast against the leading axes of ``key [..., 2]``
    (unstacked weights serve every stream)."""
    dev = key.device
    shape = key.shape[:-1]
    t = torch.full(shape, float(t0), dtype=torch.float32, device=dev)
    h = torch.zeros(shape + (int(hidden),), dtype=torch.float32, device=dev)
    inf = float("inf")

    def step(carry, i):
        t, h = carry
        a, w = rmtpp._head(weights, h)
        tau = rmtpp_next_delta(prng.fold_in(key, i), a, w)
        t_new = t + tau
        fired = torch.isfinite(t_new) & (t_new <= T)
        h = torch.where(fired[..., None], rmtpp._step_h(weights, h, tau), h)
        t = torch.where(fired, t_new, torch.full_like(t_new, inf))
        return (t, h), t_new, fired

    times_all = _slots(step, (t, h), shape, cap, dev)
    times, n = _finish(times_all[..., :cap], t0, T)
    return Stream(times, n, times_all[..., cap] <= T)
