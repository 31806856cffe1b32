"""Exact multivariate exponential-kernel Hawkes log-likelihood — the O(n)
recursion shared by both solvers in ``learn.hawkes_mle`` (the
counterpart of the JAX package's ``learn.loglik``).

Model (the simulator's own convention, ``models/hawkes.py`` generalized to
cross-excitation): intensity of dimension ``i``

    lambda_i(t) = mu_i + sum_j alpha_ij * sum_{t_l < t, u_l = j}
                                exp(-beta_j (t - t_l))

``alpha`` is the JUMP matrix, ``beta`` decays per EXCITING dimension.
The exponential kernel collapses the O(n^2) likelihood to O(n * D) via
the decay recursions carried event-to-event in GLOBAL time order:

    R(t + d) = e^{-beta d} R(t)            [+1 on own dim at an event]
    Q(t + d) = e^{-beta d} (Q(t) + d R(t))

    LL = sum_k log lambda_{u_k}(t_k)
         - sum_i [mu_i T + sum_j alpha_ij G_j],
    G_j = sum_{u_l = j} (1 - e^{-beta_j (T - t_l)}) / beta_j

**The pass.**  :func:`hawkes_pass` walks a chunked stream once and
returns per-chunk float32 partials, summed over chunks afterwards (as
the reference's per-chunk scan partials are): in stats mode the event
term of the likelihood, the EM responsibilities ``s0``/``S`` and the
weighted lag ``W``; in grad mode the Frank-Wolfe objective's event term
and its exact gradient in ``(mu, alpha)``; in both the censored-mass sum
``E_j = sum_{u_l = j} e^{-beta_j (T - t_l)}`` and the per-dimension
health word.  On a CUDA tensor it launches the hand-written kernel
``csrc/hawkes_pass.cu`` (counted in ``ops.kernels.LAUNCHES``); on a CPU
tensor it runs :func:`hawkes_pass_plain`, its plain PyTorch version.
The kernel splits each chunk into segments and composes their carries
(:func:`hawkes_carry_plain` is that composition written plainly).

**Fixed summation order.**  The reference sums ``E`` with
``jax.ops.segment_sum``; ``index_add_`` on the card sums with float
atomics, in an order that can change between runs.  Here ``E`` rides
the same sequential walk as everything else (the kernel: each chunk's
sum in event order), so a pass gives the same bits on every run and a
resumed fit is bit-identical to an uninterrupted one on the card too.

Health: an unmasked event whose intensity is non-finite or non-positive
sets ``BIT_NONFINITE_STATE`` on its dimension and, in stats mode,
contributes ZERO to every accumulator (``where`` outside ``safe_div``).
In grad mode the event term is ``m * safe_log(lambda)`` with no gate (an
invalid lambda contributes ``log(tiny)``), and the gradient is zero
where ``safe_log``'s clamp cuts it (lambda <= tiny or NaN), as
``jax.grad`` of the reference's objective gives.  ``R += m`` happens
whatever lambda is: the recursion is a function of the observed times.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..runtime.numerics import (
    BIT_NONFINITE_STATE,
    safe_div,
    safe_exp,
    safe_log,
)
from .ingest import ChunkedEvents, EventStream, chunk_events

__all__ = ["hawkes_loglik", "LoglikResult", "hawkes_pass",
           "hawkes_pass_plain", "hawkes_carry", "hawkes_carry_plain",
           "DeviceEvents", "to_device"]


class LoglikResult(NamedTuple):
    """Scored likelihood of a stream under (mu, alpha, beta).

    ``loglik`` — the exact log-likelihood (float); ``loglik_events`` /
    ``compensator`` — its two terms; ``health`` — u32[D] per-dimension
    bits (``runtime.numerics``): non-zero marks a dimension whose
    intensity went non-finite or non-positive at one of its own events;
    such events contribute exactly ZERO to ``loglik_events``."""

    loglik: float
    loglik_events: float
    compensator: float
    health: np.ndarray


class DeviceEvents(NamedTuple):
    """A :class:`ChunkedEvents` stream moved to one device once: ``dt``,
    ``tail`` f32 [C, K], ``dims`` i32 [C, K], ``mask`` bool [C, K]."""

    dt: torch.Tensor
    dims: torch.Tensor
    mask: torch.Tensor
    tail: torch.Tensor


def to_device(data: ChunkedEvents, device: torch.device) -> DeviceEvents:
    """The chunked stream's arrays as tensors on ``device``."""
    return DeviceEvents(
        dt=torch.as_tensor(np.ascontiguousarray(data.dt)).to(device),
        dims=torch.as_tensor(np.ascontiguousarray(data.dims)).to(device),
        mask=torch.as_tensor(np.ascontiguousarray(data.mask)).to(device),
        tail=torch.as_tensor(np.ascontiguousarray(data.tail)).to(device))


def hawkes_pass_plain(dt, dims, mask, tail, mu, alpha, beta,
                      grad: bool = False):
    """The plain PyTorch version of the ``hawkes_pass`` kernel: the same
    per-chunk partials ``(ll [C], a [C, D], b [C, D, D], w [C, D],
    e [C, D])`` and ``health`` i32 [D] (see the module docstring; ``a``/
    ``b`` are ``s0``/``S`` in stats mode and ``g_mu``/``g_alpha`` in grad
    mode, ``w`` is zero in grad mode).

    The decay recursion runs event by event (``R`` and ``Q`` after each
    event's decay are kept as [K, D] rows per chunk); the per-event terms
    that do not feed the recursion (lambda, the responsibilities, the
    logs, the gradient terms and the censored mass) are then formed for
    the whole chunk at once and summed per chunk with ``index_add_``.  A
    masked ``dt = 0`` event right after another repeats an exact no-op of
    the recursion (decay 1, nothing added), so it takes the previous row
    instead of a step of its own: chunk padding costs one step per chunk.
    Differentiable in ``mu``/``alpha`` (the tests take ``torch.autograd``
    of grad mode's ``ll`` as an independent check of ``a``/``b``)."""
    C, K = dt.shape
    D = mu.shape[0]
    dev, f32 = dt.device, torch.float32
    tiny = torch.finfo(f32).tiny
    dt_h = dt.detach().cpu().numpy()
    mask_h = mask.detach().cpu().numpy()
    dims_h = dims.detach().cpu().numpy()
    negb = -beta
    R = torch.zeros(D, dtype=f32, device=dev)
    Q = torch.zeros(D, dtype=f32, device=dev)
    lls, As, Bs, Ws, Es = [], [], [], [], []
    health = torch.zeros(D, dtype=torch.int32, device=dev)
    for c in range(C):
        d = safe_exp(negb[None, :] * dt[c][:, None])        # [K, D]
        pad = ~mask_h[c] & (dt_h[c] == 0)
        steps = np.ones(K, bool)
        steps[1:] = ~(pad[1:] & pad[:-1])
        Rk = torch.empty((K, D), dtype=f32, device=dev)
        Qk = None if grad else torch.empty((K, D), dtype=f32, device=dev)
        for k in np.flatnonzero(steps).tolist():
            dk = d[k]
            if not grad:
                Q = dk * (Q + float(dt_h[c, k]) * R)
                Qk[k] = Q
            R = dk * R
            Rk[k] = R
            if mask_h[c, k]:
                R[int(dims_h[c, k])] += 1.0
        if not steps.all():
            src = torch.as_tensor(
                np.maximum.accumulate(np.where(steps, np.arange(K), 0)),
                device=dev)
            Rk = Rk[src]
            Qk = None if grad else Qk[src]
        dm = dims[c].long()
        m = mask[c]
        arows = alpha[dm]                                   # [K, D]
        mu_i = mu[dm]
        exc = arows * Rk
        lam = mu_i + exc.sum(1)
        ok = torch.isfinite(lam) & (lam > 0)
        zD = torch.zeros(D, dtype=f32, device=dev)
        if grad:
            lls.append((m.to(f32) * safe_log(lam)).sum())
            gate = m & (lam > tiny)
            cinv = torch.where(gate, 1.0 / lam, torch.zeros_like(lam))
            As.append(zD.index_add(0, dm, cinv))
            Bs.append(torch.zeros((D, D), dtype=f32, device=dev).index_add(
                0, dm, cinv[:, None] * Rk))
            Ws.append(zD)
        else:
            use = m & ok
            zero = torch.zeros_like(lam)
            p0 = torch.where(use, safe_div(mu_i, lam, when_zero=0.0), zero)
            pr = torch.where(use[:, None],
                             safe_div(exc, lam[:, None], when_zero=0.0),
                             torch.zeros_like(exc))
            plag = torch.where(use[:, None],
                               safe_div(arows * Qk, lam[:, None],
                                        when_zero=0.0),
                               torch.zeros_like(exc))
            lls.append(torch.where(use, safe_log(lam), zero).sum())
            As.append(zD.index_add(0, dm, p0))
            Bs.append(torch.zeros((D, D), dtype=f32, device=dev).index_add(
                0, dm, pr))
            Ws.append(plag.sum(0))
        bad = torch.bincount(dm[m & ~ok], minlength=D) > 0
        health = health | torch.where(
            bad, torch.full_like(health, BIT_NONFINITE_STATE),
            torch.zeros_like(health))
        e = torch.where(m, safe_exp(negb[dm] * tail[c]),
                        torch.zeros_like(lam))
        Es.append(zD.index_add(0, dm, e))
    return (torch.stack(lls), torch.stack(As), torch.stack(Bs),
            torch.stack(Ws), torch.stack(Es), health)


def _fold(P, dR, dQ, span, R, Q, grad: bool):
    """R and Q carried through one summary ``(P, dR, dQ, span)`` of a run
    of events: ``R' = P R + dR``, ``Q' = P (Q + span R) + dQ``, exact in
    real arithmetic (the homogeneous solution of the recursion is
    ``e^{-beta (t - t0)} (Q + (t - t0) R)``).  ``Q`` stays as it is in
    grad mode."""
    if not grad:
        Q = P * (Q + span * R) + dQ
    return P * R + dR, Q


def hawkes_carry_plain(dt, dims, mask, beta, segments: int,
                       grad: bool = False):
    """The plain PyTorch version of the ``hawkes_pass`` kernel's phases
    (A) and (B): ``R`` and ``Q`` at the start of every segment, ``(r_in,
    q_in)`` f32 [C, W, D] with ``W = segments`` segments a chunk of
    ``L = ceil(K / W)`` events each (the last one shorter, some empty
    when K is small); ``q_in`` is zero in grad mode.

    (A) every segment walked from a zero state through the decay
    recursion alone (all segments at once, one event of each a step),
    giving ``P`` (the product of its decays in event order), ``dR``,
    ``dQ`` and ``span`` (its sum of ``dt``); each chunk's segments folded
    in order into the chunk's summary.  (B) the chunk summaries folded in
    order from zero (``R_in`` and ``Q_in`` of every chunk), then each
    chunk's ``R_in``/``Q_in`` through its segments in order.  Every fold
    is :func:`_fold`, in the kernel's order."""
    C, K = dt.shape
    D = beta.shape[0]
    W = int(segments)
    L = -(-K // W)
    dev, f32 = dt.device, torch.float32
    # Every segment as a row of L events; the places past K are padding
    # (dt 0, no mask), an exact no-op of the recursion.
    x = torch.zeros((C, W * L), dtype=f32, device=dev)
    i = torch.zeros((C, W * L), dtype=torch.long, device=dev)
    m = torch.zeros((C, W * L), dtype=f32, device=dev)
    x[:, :K] = dt
    i[:, :K] = dims.long().clamp(0, D - 1)
    m[:, :K] = mask.to(f32)
    x, i, m = (t.reshape(C * W, L) for t in (x, i, m))
    negb = -beta
    rows = torch.arange(C * W, device=dev)
    P = torch.ones((C * W, D), dtype=f32, device=dev)
    R = torch.zeros((C * W, D), dtype=f32, device=dev)
    Q = torch.zeros((C * W, D), dtype=f32, device=dev)
    span = torch.zeros(C * W, dtype=f32, device=dev)
    for k in range(L):
        xk = x[:, k]
        d = safe_exp(negb[None, :] * xk[:, None])
        if not grad:
            Q = d * (Q + xk[:, None] * R)
        R = d * R
        P = P * d
        R[rows, i[:, k]] += m[:, k]
        span = span + xk
    sP, sR, sQ = (t.reshape(C, W, D) for t in (P, R, Q))
    span = span.reshape(C, W, 1)
    cP = torch.ones((C, D), dtype=f32, device=dev)
    cR = torch.zeros((C, D), dtype=f32, device=dev)
    cQ = torch.zeros((C, D), dtype=f32, device=dev)
    csp = torch.zeros((C, 1), dtype=f32, device=dev)
    for s in range(W):
        cR, cQ = _fold(sP[:, s], sR[:, s], sQ[:, s], span[:, s], cR, cQ,
                       grad)
        cP = cP * sP[:, s]
        csp = csp + span[:, s]
    R_c = torch.empty((C, D), dtype=f32, device=dev)
    Q_c = torch.zeros((C, D), dtype=f32, device=dev)
    R = torch.zeros(D, dtype=f32, device=dev)
    Q = torch.zeros(D, dtype=f32, device=dev)
    for c in range(C):
        R_c[c] = R
        Q_c[c] = Q
        R, Q = _fold(cP[c], cR[c], cQ[c], csp[c], R, Q, grad)
    r_in = torch.empty((C, W, D), dtype=f32, device=dev)
    q_in = torch.empty((C, W, D), dtype=f32, device=dev)
    R, Q = R_c, Q_c
    for s in range(W):
        r_in[:, s] = R
        q_in[:, s] = Q
        R, Q = _fold(sP[:, s], sR[:, s], sQ[:, s], span[:, s], R, Q, grad)
    return r_in, q_in


def hawkes_carry(dt, dims, mask, beta, segments: int, grad: bool = False):
    """The carries at every segment start, ``segments`` segments a chunk
    (:func:`hawkes_carry_plain`): the kernel's phases (A) and (B) for CUDA
    tensors (``ops.kernels.launch_hawkes_carry``; the pass itself uses
    ``ops.kernels.hawkes_segments(D)``), the plain version for CPU
    tensors."""
    if dt.device.type == "cuda":
        from ..ops import kernels

        return kernels.launch_hawkes_carry(dt, dims, mask, beta,
                                           segments=segments, grad=grad)
    return hawkes_carry_plain(dt, dims, mask, beta, segments, grad=grad)


def hawkes_pass(dt, dims, mask, tail, mu, alpha, beta, grad: bool = False):
    """One pass over a chunked stream (module docstring): the kernel
    ``csrc/hawkes_pass.cu`` for CUDA tensors (``ops.kernels.
    launch_hawkes_pass``, which raises on a shape it does not take), its
    plain version :func:`hawkes_pass_plain` for CPU tensors."""
    if dt.device.type == "cuda":
        from ..ops import kernels

        return kernels.launch_hawkes_pass(dt, dims, mask, tail, mu, alpha,
                                          beta, grad=grad)
    return hawkes_pass_plain(dt, dims, mask, tail, mu, alpha, beta,
                             grad=grad)


class PassStats(NamedTuple):
    """One stats pass summed over chunks: ``ll`` (0-d), ``s0`` [D],
    ``S`` [D, D], ``W`` [D], ``E`` [D] and ``health`` i32 [D]."""

    ll: torch.Tensor
    s0: torch.Tensor
    S: torch.Tensor
    W: torch.Tensor
    E: torch.Tensor
    health: torch.Tensor


def _stream_pass(ev: DeviceEvents, mu, alpha, beta) -> PassStats:
    """The full O(n) stats pass, reduced over chunks: the event-side
    statistics both solvers and the scorer share (f32 tensors)."""
    ll, s0, S, W, E, health = hawkes_pass(
        ev.dt, ev.dims, ev.mask, ev.tail, mu, alpha, beta)
    return PassStats(ll.sum(), s0.sum(0), S.sum(0), W.sum(0), E.sum(0),
                     health)


def _censored_mass(E, counts, beta):
    """``G_j = (counts_j - E_j) / beta_j`` with ``E_j = sum_{u_l = j}
    exp(-beta_j (T - t_l))`` from a pass at this ``beta``: THE one
    definition of the compensator's excitation term (the scorer and the
    EM M-step both call it).  Clamped at zero — f32 cancellation in
    ``counts - E`` must not manufacture a negative mass."""
    return safe_div(torch.clamp(counts - E, min=0.0), beta, when_zero=0.0)


def _compensator_G(ev: DeviceEvents, counts, beta):
    """``G_j`` over a device stream at ``beta`` alone: one pass for
    ``E`` (which depends on the times and ``beta`` only, so the pass
    runs at ``mu = alpha = 0``), then :func:`_censored_mass`.
    ``integral_0^T lambda_i`` then equals ``mu_i T + sum_j alpha_ij
    G_j``."""
    D = beta.shape[0]
    zero = torch.zeros(D, dtype=beta.dtype, device=beta.device)
    E = _stream_pass(ev, zero, torch.zeros((D, D), dtype=beta.dtype,
                                           device=beta.device), beta).E
    return _censored_mass(E, counts, beta)


class _LLEvents(torch.autograd.Function):
    """``sum_k m_k safe_log(lambda_k)`` with its exact gradient in
    ``(mu, alpha)`` from one grad-mode pass; ``beta`` gets none, as in
    the reference (``value_and_grad(..., argnums=(0, 1))``)."""

    @staticmethod
    def forward(ctx, dt, dims, mask, tail, mu, alpha, beta):
        ll, g_mu, g_alpha, _w, _e, _h = hawkes_pass(
            dt, dims, mask, tail, mu.detach(), alpha.detach(),
            beta.detach(), grad=True)
        ctx.save_for_backward(g_mu.sum(0), g_alpha.sum(0))
        return ll.sum()

    @staticmethod
    def backward(ctx, grad_out):
        g_mu, g_alpha = ctx.saved_tensors
        return (None, None, None, None, grad_out * g_mu,
                grad_out * g_alpha, None)


def _ll_events_fn(ev: DeviceEvents, mu, alpha, beta):
    """Differentiable sum of per-event log-intensities (the Frank-Wolfe
    objective's event term), through one grad-mode pass."""
    return _LLEvents.apply(ev.dt, ev.dims, ev.mask, ev.tail, mu, alpha,
                           beta)


def _compensator(mu, alpha, G, span: float):
    """``sum_i mu_i T + sum_ij alpha_ij G_j`` in f32."""
    return mu.sum() * span + (alpha * G[None, :]).sum()


def _f32(x, device) -> torch.Tensor:
    """A host value (float64 or not) as an f32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(x, np.float64),
                           dtype=torch.float32).to(device)


def _params(mu, alpha, beta, D: int, device):
    """``(mu [D], alpha [D, D], beta [D])`` as f32 tensors on ``device``."""
    return (_f32(mu, device).reshape(D), _f32(alpha, device).reshape(D, D),
            _f32(beta, device).reshape(D))


def _score(ev: DeviceEvents, counts, span: float, mu, alpha, beta):
    """Exact log-likelihood at f32 tensors: ``(ll_events, compensator,
    health)`` as host values, one pass and one read."""
    st = _stream_pass(ev, mu, alpha, beta)
    G = _censored_mass(st.E, counts, beta)
    comp = _compensator(mu, alpha, G, span)
    both = torch.stack([st.ll, comp]).cpu().numpy()
    return (float(both[0]), float(both[1]),
            st.health.cpu().numpy().astype(np.uint32))


def hawkes_loglik(data, mu, alpha, beta, chunk_size: int = 4096,
                  device: DeviceLike = "cuda") -> LoglikResult:
    """Exact log-likelihood of an event stream under an exponential-kernel
    multivariate Hawkes model — the scored metric both solvers optimize,
    callable standalone (model comparison, held-out scoring).

    ``data`` — :class:`~redqueen_tpu_torch.learn.ingest.EventStream` or
    pre-chunked :class:`~redqueen_tpu_torch.learn.ingest.ChunkedEvents`;
    ``mu`` f[D], ``alpha`` f[D, D] (jump convention), ``beta`` f[D].
    Runs one pass on ``device`` (the card unless ``device="cpu"``) and
    returns host values."""
    dev = resolve_device(device)
    if isinstance(data, EventStream):
        data = chunk_events(data, chunk_size=chunk_size)
    D = data.n_dims
    ev = to_device(data, dev)
    mu_t, a_t, b_t = _params(mu, alpha, beta, D, dev)
    ll, comp, health = _score(ev, _f32(data.counts, dev),
                              float(data.span), mu_t, a_t, b_t)
    return LoglikResult(loglik=ll - comp, loglik_events=ll,
                        compensator=comp, health=health)
