"""Corpus-scale multivariate Hawkes estimation: two solvers, one interface
(the counterpart of the JAX package's ``learn.hawkes_mle``, with the same
defaults, validation, messages, checkpoints and quarantine).

Fits ``(mu, alpha, beta)`` of the exponential-kernel multivariate Hawkes
model (``learn.loglik`` — the simulator's own parameterization, so a fit
closes the simulate→fit→control loop via ``learn.control``) from one
:class:`~redqueen_tpu_torch.learn.ingest.EventStream`:

- ``solver="em"`` — MM/EM: the closed-form branching-ratio E-step rides
  the SAME O(n·D) pass as the likelihood (``loglik.hawkes_pass``
  aggregates responsibilities per exciting dimension), and the M-step is
  closed-form:

      mu_i     <- S0_i / T
      alpha_ij <- S_ij / G_j            (G = censored kernel mass)
      beta_j   <- P_j / W_j             (weighted-lag exponential MLE,
                                         the standard MM surrogate)

- ``solver="fw"`` — Frank-Wolfe (arXiv:2212.06081): minimizes the exact
  NLL over ``mu in [0, mu_max]^D`` and branching-ratio rows
  ``a_i. in {a >= 0, sum_j a_ij <= rho < 1}`` (every iterate provably
  SUBCRITICAL).  The linear-minimization oracle is closed-form (one
  vertex pick per row), gradients come from one grad-mode pass (the
  kernel's exact gradient inside a ``torch.autograd.Function``), and the
  duality gap is the convergence certificate.  ``beta`` is fixed from
  ``fw_beta_warmup`` EM iterations (or ``beta0``).

On the card every pass is one launch of the ``hawkes_pass`` kernel; the
stream moves to the device once, and iterations move no event data.
Device→host syncs are BLOCKED: the objective trajectory is fetched once
per ``sync_every`` iterations, never per step.

Fits are resumable and preempt-clean: ``ckpt_path`` lands an enveloped
``rq.learn.fit/1`` checkpoint (``learn.ckpt`` → ``runtime.integrity``)
every ``ckpt_every`` iterations, keyed by a fingerprint of the event
bytes + solver config; after each durable save the fitter heartbeats and
honors a pending SIGTERM/SIGINT.

Degenerate inputs quarantine per DIMENSION (``HawkesFit.health`` u32[D],
``runtime.numerics`` bits): a dimension whose intensity or parameters go
non-finite is sanitized to a safe fallback (Poisson-rate ``mu``, zeroed
``alpha`` row+column, unit ``beta``) and flagged — returned rates are
never NaN or negative.  Only when EVERY dimension dies does the fit
raise the typed :class:`FitError`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..runtime import preempt as _preempt
from ..runtime import telemetry as _telemetry
from ..runtime.numerics import (
    BIT_NONFINITE_STATE,
    describe_health,
    safe_div,
)
from ..runtime.supervisor import heartbeat as _heartbeat
from . import ckpt as _ckpt
from .ingest import ChunkedEvents, EventStream, chunk_events
from .loglik import (
    DeviceEvents,
    _censored_mass,
    _compensator,
    _compensator_G,
    _f32,
    _ll_events_fn,
    _score,
    _stream_pass,
    to_device,
)

__all__ = ["HawkesFit", "FitError", "fit_hawkes", "SOLVERS"]

SOLVERS = ("em", "fw")

_F32 = torch.float32


class FitError(RuntimeError):
    """Every dimension of a fit died numerically (mirror of the sim
    driver's ``NumericalHealthError``, at the estimator boundary).
    Carries the per-dimension ``health`` bitmask and decoded
    ``reasons``; partial degeneracy never raises — sick dimensions are
    sanitized + flagged in ``HawkesFit.health`` instead."""

    def __init__(self, health, context: str = "hawkes fit"):
        self.health = np.atleast_1d(np.asarray(health))
        self.reasons = describe_health(self.health)
        dims = ", ".join(
            f"dim {i}: {'; '.join(r)}"
            for i, r in sorted(self.reasons.items())[:8])
        more = "" if len(self.reasons) <= 8 else (
            f" (+{len(self.reasons) - 8} more)")
        super().__init__(
            f"{context}: all {self.health.size} dimension(s) numerically "
            f"dead — {dims}{more}. The stream was host-validated, so the "
            f"trace is degenerate for this model (or parameters "
            f"diverged); inspect the stream or widen beta bounds.")


class HawkesFit(NamedTuple):
    """A fitted multivariate Hawkes model (host float64 arrays).

    ``alpha`` is the JUMP matrix — ``(mu[i], alpha[i, i], beta[i])``
    plugs straight into ``config.GraphBuilder.add_hawkes`` (which also
    accepts the fit object whole; ``learn.control`` is the loop-closer).
    ``health`` u32[D]: non-zero marks a sanitized/quarantined dimension
    whose values are fallbacks, not estimates.  ``loglik`` is the
    objective trajectory (log-likelihood, one entry per iteration,
    evaluated at the pre-update parameters); ``final_loglik`` scores the
    returned parameters exactly."""

    mu: np.ndarray         # f64[D]
    alpha: np.ndarray      # f64[D, D]
    beta: np.ndarray       # f64[D]
    health: np.ndarray     # u32[D]
    loglik: np.ndarray     # f64[n_iter]
    final_loglik: float
    converged: bool
    n_iter: int
    solver: str
    n_events: int
    n_dims: int
    t_end: float
    t_start: float

    def branching(self) -> np.ndarray:
        """Branching-ratio matrix ``alpha_ij / beta_j`` (expected direct
        offspring in dim i per event of dim j)."""
        return self.alpha / np.maximum(self.beta[None, :], 1e-300)


class _Fit(NamedTuple):
    """What an iteration needs besides the parameters: the device stream,
    counts (f32 on the device), the window length and the bounds."""

    ev: DeviceEvents
    counts: torch.Tensor
    span: float
    span_t: torch.Tensor
    beta_floor: float
    beta_cap: float


def _host(*ts):
    """Host float64 copies of device tensors."""
    return tuple(np.asarray(t.detach().cpu().numpy(), np.float64)
                 for t in ts)


# ---------------------------------------------------------------------------
# EM / MM iteration
# ---------------------------------------------------------------------------

def _em_iter(fx: _Fit, mu, alpha, beta):
    """One EM sweep: E-step sufficient statistics from the shared O(n)
    pass, closed-form M-step.  Returns the NEW parameters plus the
    log-likelihood and per-dimension health AT THE OLD parameters (the
    pass that produced the statistics)."""
    st = _stream_pass(fx.ev, mu, alpha, beta)
    G = _censored_mass(st.E, fx.counts, beta)
    comp = _compensator(mu, alpha, G, fx.span)
    mu_n = safe_div(st.s0, fx.span_t, when_zero=0.0)
    alpha_n = safe_div(st.S, G[None, :], when_zero=0.0)
    P = st.S.sum(0)  # total triggered mass attributed to each source dim
    beta_n = torch.clamp(
        torch.where(st.W > 0, safe_div(P, st.W, when_zero=0.0), beta),
        fx.beta_floor, fx.beta_cap)
    return mu_n, alpha_n, beta_n, st.ll - comp, st.health


# ---------------------------------------------------------------------------
# Frank-Wolfe iteration
# ---------------------------------------------------------------------------

#: Added to the FW step-schedule denominator: ``gamma_t = 2 / (t + 2 +
#: offset)``.  The classic ``2/(t+2)`` takes gamma_0 = 1 — a first step
#: that lands EXACTLY on a vertex, obliterating the EM warm start; any
#: constant offset keeps the O(1/t) guarantee while letting the warm
#: start count.
FW_STEP_OFFSET = 8.0


def _fw_iter(fx: _Fit, G, mu_max, t: int, mu, a, beta, rho: float):
    """One Frank-Wolfe step on the exact NLL over box x scaled-simplex.
    Returns the new iterate, the NLL at the old iterate, and the duality
    gap ``<grad, x - s>`` (>= suboptimality for this convex objective —
    the stopping certificate)."""
    D = mu.shape[0]
    with torch.enable_grad():
        mu_v = mu.detach().requires_grad_(True)
        a_v = a.detach().requires_grad_(True)
        alpha = a_v * beta[None, :]
        ll_ev = _ll_events_fn(fx.ev, mu_v, alpha, beta)
        val = _compensator(mu_v, alpha, G, fx.span) - ll_ev
        g_mu, g_a = torch.autograd.grad(val, (mu_v, a_v))
    val = val.detach()
    # LMO, closed form per block: box vertex for mu, a rho-scaled
    # simplex vertex (or the origin) per alpha row.
    s_mu = torch.where(g_mu < 0, mu_max, torch.zeros_like(mu_max))
    row_min = g_a.min(dim=1).values
    pick = torch.nn.functional.one_hot(
        torch.argmin(g_a, dim=1), D).to(_F32)
    rho32 = float(np.float32(rho))
    s_a = torch.where((row_min < 0)[:, None], rho32 * pick,
                      torch.zeros_like(pick))
    gap = (g_mu * (mu - s_mu)).sum() + (g_a * (a - s_a)).sum()
    # The step size in float32, as the reference computes it from a
    # float32 iteration index.
    gamma = float(np.float32(2.0) / (np.float32(t) + np.float32(2.0)
                                     + np.float32(FW_STEP_OFFSET)))
    return (mu + gamma * (s_mu - mu), a + gamma * (s_a - a), val, gap)


# ---------------------------------------------------------------------------
# Host-side driver
# ---------------------------------------------------------------------------

def _sanitize(mu, alpha, beta, counts64, span, prior_bits):
    """Quarantine sick dimensions (host side, at sync boundaries): a
    dimension with non-finite parameters — or one already flagged by the
    pass's per-dimension health word (quarantine is STICKY, like the sim
    kernel's frozen lanes) — gets fallback parameters: Poisson-rate
    ``mu``, zeroed ``alpha`` row+column, unit ``beta``, plus its health
    bit.  Returns ``(mu, alpha, beta, bits)`` with rates guaranteed
    finite and non-negative."""
    mu = np.asarray(mu, np.float64).copy()
    alpha = np.asarray(alpha, np.float64).copy()
    beta = np.asarray(beta, np.float64).copy()
    bad = ~(np.isfinite(mu) & (mu >= 0))
    bad |= ~np.isfinite(alpha).all(axis=1) | ~np.isfinite(alpha).all(axis=0)
    bad |= ~(np.isfinite(beta) & (beta > 0))
    bits = np.asarray(prior_bits, np.uint32).copy()
    bits[bad] |= np.uint32(BIT_NONFINITE_STATE)
    bad |= bits != 0
    if bad.any():
        fallback_mu = np.clip(
            counts64 / max(span, 1e-300), 0.0, np.finfo(np.float32).max)
        mu[bad] = fallback_mu[bad]
        alpha[bad, :] = 0.0
        alpha[:, bad] = 0.0
        beta[bad] = 1.0
    # Numerical dust below zero is clipped silently (not degeneracy).
    alpha = np.maximum(alpha, 0.0)
    mu = np.maximum(mu, 0.0)
    return mu, alpha, beta, bits


def _default_beta0(counts64, span, beta_floor, beta_cap):
    """Decay init: the reciprocal mean own-gap per dimension (a dim's
    rate scale) — the weighted-lag M-step refines it from there."""
    rate = counts64 / max(span, 1e-300)
    return np.clip(np.where(rate > 0, rate, 1.0), beta_floor, beta_cap)


def fit_hawkes(data, solver: str = "em", max_iters: int = 200,
               tol: float = 1e-4, chunk_size: int = 4096,
               beta0=None, beta_floor: float = 1e-3,
               beta_cap: float = 1e4, rho: float = 0.8,
               mu_max_scale: float = 4.0, fw_beta_warmup: int = 30,
               sync_every: int = 8, ckpt_path: Optional[str] = None,
               ckpt_every: int = 32,
               device: DeviceLike = "cuda") -> HawkesFit:
    """Fit a multivariate exponential-kernel Hawkes model to one event
    stream.  See the module docstring for the two solvers.

    ``data`` — :class:`~redqueen_tpu_torch.learn.ingest.EventStream` (or
    pre-chunked :class:`~redqueen_tpu_torch.learn.ingest.ChunkedEvents`).
    ``tol`` — EM: relative log-likelihood improvement; FW: relative
    duality gap.  ``beta0`` — initial (EM) / fixed (FW, unless the EM
    warm-up runs) decay, scalar or [D].  ``ckpt_path`` — enveloped
    ``rq.learn.fit/1`` resume point, written every ``ckpt_every``
    iterations (a killed fit rerun with the same arguments continues; a
    changed stream or config restarts — fingerprinted).  ``device`` —
    where the passes run: the card (``hawkes_pass`` kernel) unless
    ``device="cpu"`` (its plain version).
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (want "
                         f"{'|'.join(SOLVERS)})")
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    if not 0.0 < rho < 1.0:
        raise ValueError(f"rho must be in (0, 1) — the simplex scale IS "
                         f"the subcriticality guarantee; got {rho!r}")
    if isinstance(data, EventStream):
        data = chunk_events(data, chunk_size=chunk_size)
    if not isinstance(data, ChunkedEvents):
        raise TypeError(f"data must be EventStream or ChunkedEvents, "
                        f"got {type(data).__name__}")
    dev = resolve_device(device)
    D = data.n_dims
    span = float(data.span)
    counts64 = np.asarray(data.counts, np.float64)

    beta0_arr = (
        _default_beta0(counts64, span, beta_floor, beta_cap)
        if beta0 is None
        else np.broadcast_to(np.asarray(beta0, np.float64), (D,)).copy())
    if not (np.isfinite(beta0_arr).all() and (beta0_arr > 0).all()):
        raise ValueError(f"beta0 must be finite and > 0, got {beta0_arr}")

    fp = None
    if ckpt_path is not None:
        config = dict(
            solver=solver, chunk_size=int(chunk_size), n_dims=int(D),
            span=float(span), beta_floor=float(beta_floor),
            beta_cap=float(beta_cap), rho=float(rho),
            mu_max_scale=float(mu_max_scale),
            fw_beta_warmup=int(fw_beta_warmup),
            n_events=int(data.n_events),
            beta0=("default" if beta0 is None
                   else beta0_arr.tobytes().hex()),
        )
        # mask is hashed too: a stream extended by one dt=0 trailing
        # event pads to byte-identical dt/dims and differs ONLY in the
        # mask.
        fp = _ckpt.fingerprint_arrays(config, data.dt, data.dims,
                                      data.mask)

    # Device-resident stream (moved once — iterations then move no event
    # data at all) + initial parameters.
    fx = _Fit(ev=to_device(data, dev),
              counts=_f32(counts64, dev), span=span,
              span_t=torch.tensor(span, dtype=_F32, device=dev),
              beta_floor=float(np.float32(beta_floor)),
              beta_cap=float(np.float32(beta_cap)))
    mu0 = 0.5 * counts64 / max(span, 1e-300)
    alpha0 = np.broadcast_to((0.1 * beta0_arr / max(D, 1))[None, :],
                             (D, D)).copy()

    start_it, curve, bits = 0, [], np.zeros(D, np.uint32)
    params = (mu0, alpha0, beta0_arr)
    loaded = (_ckpt.load_fit(ckpt_path, fp)
              if ckpt_path is not None else None)
    if loaded is not None:
        start_it, arrays, meta = loaded
        params = (arrays["mu"], arrays["alpha"], arrays["beta"])
        curve = list(np.asarray(arrays["curve"], np.float64))
        bits = np.asarray(arrays["health"], np.uint32)

    def save(it, params_np, extra_meta=None):
        if ckpt_path is None:
            return
        mu_c, alpha_c, beta_c = params_np
        _ckpt.save_fit(
            ckpt_path, fp, it,
            {"mu": mu_c, "alpha": alpha_c, "beta": beta_c,
             "curve": np.asarray(curve, np.float64), "health": bits},
            meta=dict(solver=solver, n_dims=D,
                      n_events=data.n_events, **(extra_meta or {})))
        # Durable boundary: prove progress, then honor a pending
        # SIGTERM/SIGINT (the resumed fit continues from this artifact).
        _heartbeat()
        _preempt.check_preempt(f"fit_hawkes[{solver}] iteration {it}")

    # The fit's root span: every per-iteration / sync-boundary span
    # below chains under it.
    with _telemetry.span("learn.fit", solver=solver, n_dims=int(D),
                         n_events=int(data.n_events)) as fit_sp:
        if solver == "em":
            fit_arrays, n_iter, converged = _run_em(
                fx, counts64, D, params, start_it, max_iters, tol,
                sync_every, ckpt_every, curve, bits, save)
        else:
            fit_arrays, n_iter, converged = _run_fw(
                fx, counts64, D, params, start_it, max_iters, tol, rho,
                mu_max_scale, fw_beta_warmup, sync_every, ckpt_every,
                curve, bits, save)
        fit_sp.set(n_iter=int(n_iter), converged=bool(converged))
    mu_f, alpha_f, beta_f = fit_arrays

    def score(mu_s, alpha_s, beta_s):
        """Exact log-likelihood + pass health at host params (one pass
        and one read)."""
        ll, comp, health = _score(fx.ev, fx.counts, span, _f32(mu_s, dev),
                                  _f32(alpha_s, dev), _f32(beta_s, dev))
        return ll - comp, health

    # Final exact score (the trajectory's entries are pre-update), then
    # sanitize; if quarantine changed any parameter, score ONCE more so
    # final_loglik describes exactly the RETURNED parameters.
    final_ll, health_host = score(mu_f, alpha_f, beta_f)
    bits = bits | health_host
    pre = (mu_f.copy(), alpha_f.copy(), beta_f.copy())
    mu_f, alpha_f, beta_f, bits = _sanitize(
        mu_f, alpha_f, beta_f, counts64, span, bits)
    if D and (bits != 0).all():
        raise FitError(bits, context=f"fit_hawkes[{solver}]")
    if not all(np.array_equal(a, b)
               for a, b in zip(pre, (mu_f, alpha_f, beta_f))):
        final_ll, _rescored = score(mu_f, alpha_f, beta_f)

    return HawkesFit(
        mu=mu_f, alpha=alpha_f, beta=beta_f, health=bits,
        loglik=np.asarray(curve, np.float64),
        final_loglik=final_ll,
        converged=bool(converged), n_iter=int(n_iter), solver=solver,
        n_events=int(data.n_events), n_dims=int(D),
        t_end=float(data.t_end), t_start=float(data.t_start))


def _run_em(fx, counts64, D, params, start_it, max_iters, tol,
            sync_every, ckpt_every, curve, bits, save):
    dev = fx.counts.device
    mu, alpha, beta = (_f32(p, dev) for p in params)
    pending = []
    converged = False
    it = start_it
    while it < max_iters and not converged:
        # Per-iteration span = the sweep's ENQUEUE (on the card the pass
        # is one asynchronous launch); the blocked wait is the sync span
        # at the window boundary below.
        with _telemetry.span("learn.em.iter") as isp:
            isp.set(it=it)
            mu, alpha, beta, ll, health = _em_iter(fx, mu, alpha, beta)
        pending.append((ll, health))
        it += 1
        if len(pending) >= sync_every or it >= max_iters:
            # ONE blocked sync per window (never per step): the
            # trajectory tail, the pass's health words and the tiny
            # parameter carry.
            with _telemetry.span("learn.em.sync") as ssp:
                ssp.set(iters=len(pending))
                vals = torch.stack([v for v, _h in pending]).cpu().numpy()
                hs = torch.stack([h for _v, h in pending]).cpu().numpy()
                mu_h, alpha_h, beta_h = _host(mu, alpha, beta)
            curve.extend(float(v) for v in vals)
            scan_bits = np.zeros_like(bits)
            for h in hs:
                scan_bits |= np.asarray(h, np.uint32)
            pending = []
            mu_h, alpha_h, beta_h, bits_new = _sanitize(
                mu_h, alpha_h, beta_h, counts64, fx.span, bits | scan_bits)
            if (bits_new != bits).any():
                bits[:] = bits_new
                if (bits != 0).all():
                    raise FitError(bits, context="fit_hawkes[em]")
                mu, alpha, beta = (_f32(p, dev)
                                   for p in (mu_h, alpha_h, beta_h))
            if len(curve) >= 2:
                converged = (abs(curve[-1] - curve[-2])
                             <= tol * (1.0 + abs(curve[-2])))
            if converged or it >= max_iters or (
                    ckpt_every and it % ckpt_every < sync_every):
                save(it, (mu_h, alpha_h, beta_h))
    return _host(mu, alpha, beta), it, converged


def _run_fw(fx, counts64, D, params, start_it, max_iters, tol, rho,
            mu_max_scale, fw_beta_warmup, sync_every, ckpt_every, curve,
            bits, save):
    dev = fx.counts.device
    mu_np, alpha_np, beta_np = params
    if start_it == 0 and fw_beta_warmup > 0:
        # Decay warm-start: a few EM sweeps pin beta (FW then optimizes
        # the convex (mu, a) problem at that fixed decay).
        mu, alpha, beta = (_f32(p, dev) for p in params)
        with _telemetry.span("learn.fw.warmup") as wsp:
            wsp.set(iters=int(fw_beta_warmup))
            for _ in range(int(fw_beta_warmup)):
                mu, alpha, beta, _ll, _h = _em_iter(fx, mu, alpha, beta)
            mu_np, alpha_np, beta_np = _host(mu, alpha, beta)
        mu_np, alpha_np, beta_np, bits[:] = _sanitize(
            mu_np, alpha_np, beta_np, counts64, fx.span, bits)
    beta = _f32(beta_np, dev)
    mu = _f32(mu_np, dev)
    G = _compensator_G(fx.ev, fx.counts, beta)
    mu_max = _f32(mu_max_scale * (counts64 + 1.0) / max(fx.span, 1e-300),
                  dev)
    # Branching-ratio iterate, projected into the feasible simplex (the
    # warm start may sit outside it).
    a_np = alpha_np / np.maximum(beta_np[None, :], 1e-300)
    row = a_np.sum(axis=1, keepdims=True)
    # Tolerance-gated: an f32 iterate can overshoot the simplex by an
    # ulp; rescaling THAT would perturb a resumed fit away from the
    # uninterrupted trajectory for no feasibility gain.
    a_np = np.where(row > rho * (1.0 + 1e-6),
                    a_np * (rho / np.maximum(row, 1e-300)), a_np)
    a = _f32(a_np, dev)

    pending = []
    converged = False
    it = start_it
    while it < max_iters and not converged:
        # Same enqueue/sync split as the EM loop (see _run_em).
        with _telemetry.span("learn.fw.iter") as isp:
            isp.set(it=it)
            mu, a, nll, gap = _fw_iter(fx, G, mu_max, it, mu, a, beta, rho)
        pending.append((nll, gap))
        it += 1
        if len(pending) >= sync_every or it >= max_iters:
            with _telemetry.span("learn.fw.sync") as ssp:
                ssp.set(iters=len(pending))
                vals = torch.stack([torch.stack(p) for p in pending]
                                   ).cpu().numpy()
                mu_h, a_h = _host(mu, a)
            last_gap = float(vals[-1][1])
            last_nll = float(vals[-1][0])
            curve.extend(-float(v[0]) for v in vals)
            pending = []
            alpha_h = a_h * beta_np[None, :]
            mu_h, alpha_h, beta_s, bits_new = _sanitize(
                mu_h, alpha_h, beta_np, counts64, fx.span, bits)
            if (bits_new != bits).any():
                bits[:] = bits_new
                if (bits != 0).all():
                    raise FitError(bits, context="fit_hawkes[fw]")
                mu = _f32(mu_h, dev)
                a = _f32(alpha_h / np.maximum(beta_s[None, :], 1e-300), dev)
            converged = last_gap <= tol * (1.0 + abs(last_nll))
            if converged or it >= max_iters or (
                    ckpt_every and it % ckpt_every < sync_every):
                save(it, (mu_h, alpha_h, beta_np),
                     extra_meta={"phase": "fw"})
    mu_h, a_h = _host(mu, a)
    alpha_h = a_h * beta_np[None, :]
    return ((mu_h, alpha_h, np.asarray(beta_np, np.float64)), it,
            converged)
