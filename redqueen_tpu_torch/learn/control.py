"""Close the loop: fitted Hawkes parameters → RedQueen control (the
counterpart of the JAX package's ``learn.control``; host NumPy, plus
the port's ``GraphBuilder``).

The paper's control algorithm treats the followers' feed dynamics as
GIVEN; ``learn.hawkes_mle`` makes them LEARNED.  This module is the seam
between the two: a :class:`~redqueen_tpu_torch.learn.hawkes_mle.HawkesFit`
becomes ``config.add_hawkes`` sources of a simulation component, with a
RedQueen (Opt) broadcaster layered on top — "fit real feeds, then
broadcast smartly".

The simulator's Hawkes sources are per-source SELF-exciting (diagonal in
the multivariate model); a fit with substantial off-diagonal excitation
cannot be represented faithfully, so :func:`add_fit_walls` measures the
cross-excitation mass and warns (never silently drops it) before adding
the diagonal projection.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

from ..device import DeviceLike

__all__ = [
    "builder_params",
    "cross_excitation_mass",
    "add_fit_walls",
    "control_component",
    "control_cost",
    "stationary_rates",
    "fit_s_sink",
    "simulate_cross_exciting",
]

# Above this fraction of learned branching mass living off-diagonal, the
# diagonal projection is materially wrong and the warning fires.
CROSS_EXCITATION_WARN = 0.25


def cross_excitation_mass(fit) -> float:
    """Fraction of the fitted branching mass (``alpha_ij / beta_j``)
    that is OFF-diagonal — what the simulator's self-exciting sources
    cannot represent.  0.0 for a pure self-exciting fit."""
    b = np.asarray(fit.branching(), np.float64)
    total = float(b.sum())
    if total <= 0:
        return 0.0
    off = float(total - np.trace(b))
    return max(off, 0.0) / max(total, 1e-300)


def builder_params(fit, warn: bool = True):
    """``(mu, alpha_diag, beta)`` f64 arrays for per-source simulation —
    the diagonal projection of the fit, with the cross-excitation check.
    Quarantined dimensions (``fit.health`` non-zero) carry fallback
    values; the caller decides whether to include them (the arrays are
    returned whole — mask with ``fit.health == 0`` to drop them)."""
    mu = np.asarray(fit.mu, np.float64)
    alpha = np.asarray(fit.alpha, np.float64)
    beta = np.asarray(fit.beta, np.float64)
    if warn:
        frac = cross_excitation_mass(fit)
        if frac > CROSS_EXCITATION_WARN:
            warnings.warn(
                f"{frac:.1%} of the fitted branching mass is "
                f"off-diagonal cross-excitation — the simulator's "
                f"per-source Hawkes walls keep only the diagonal, so the "
                f"re-simulated feeds will be tamer than the fit; treat "
                f"control costs as approximate", stacklevel=3)
    return mu, np.diag(alpha).copy(), beta


def add_fit_walls(gb, fit, sinks_per_dim: Optional[Sequence] = None,
                  warn: bool = True):
    """Add one Hawkes wall per fitted dimension to a
    :class:`~redqueen_tpu_torch.config.GraphBuilder` (domain checks +
    supercritical warnings apply to the LEARNED parameters exactly as to
    hand-written specs).  ``sinks_per_dim[k]`` is dimension k's sink
    list (default: dim k → sink k, the closed-loop layout).  Returns the
    added source rows."""
    mu, a_diag, beta = builder_params(fit, warn=warn)
    rows = []
    for k in range(fit.n_dims):
        sinks = [k] if sinks_per_dim is None else sinks_per_dim[k]
        rows.append(gb.add_hawkes(float(mu[k]), float(a_diag[k]),
                                  float(beta[k]), sinks=sinks))
    return rows


def control_component(fit_or_params, end_time: float, q: float = 1.0,
                      capacity: int = 4096, warn: bool = True,
                      device: DeviceLike = "cuda"):
    """The closed-loop component: one RedQueen (Opt) broadcaster posting
    into every feed, against one fitted (or true) Hawkes wall per feed.

    ``fit_or_params`` — a :class:`HawkesFit`, or a ``(mu, alpha_diag,
    beta)`` triple of [D] arrays (the true-parameter twin, so fitted and
    true worlds build through the IDENTICAL path).  Returns
    ``((cfg, params, adj), opt_row)`` on ``device`` ready for
    :func:`~redqueen_tpu_torch.sweep.run_sweep`."""
    from ..config import GraphBuilder

    if hasattr(fit_or_params, "alpha") and hasattr(fit_or_params, "mu"):
        mu, a_diag, beta = builder_params(fit_or_params, warn=warn)
    else:
        mu, a_diag, beta = (np.asarray(x, np.float64)
                            for x in fit_or_params)
    D = len(mu)
    gb = GraphBuilder(n_sinks=D, end_time=float(end_time))
    opt_row = gb.add_opt(q=float(q))
    for k in range(D):
        gb.add_hawkes(float(mu[k]), float(a_diag[k]), float(beta[k]),
                      sinks=[k])
    return gb.build(capacity=int(capacity), device=device), opt_row


def simulate_cross_exciting(mu, alpha, beta, t_end: float,
                            seed: int = 0, t_start: float = 0.0,
                            max_events: int = 1_000_000):
    """Seeded Ogata-thinning simulation of a FULL multivariate Hawkes
    model — off-diagonal ``alpha`` included, which the simulator's
    per-source self-exciting walls cannot produce.  This is the ground
    truth generator that validates fitted cross-excitation end-to-end
    (simulate a known off-diagonal model → journal it → fit → compare
    :func:`cross_excitation_mass`).

    Parameterization matches ``learn.loglik`` exactly: ``alpha`` is the
    jump matrix, ``lambda_i(t) = mu_i + sum_l alpha[i, u_l] *
    exp(-beta[u_l] (t - t_l))``.  Host NumPy (O(n·D) with exponential
    state decay between candidates — no event-history rescan), so it
    stays test-sized; corpus-scale generation is the simulator's job.  Returns ``(times f64[n], dims i32[n])``, globally ordered.
    Raises if the model is supercritical (the simulation would explode)
    or ``max_events`` is exceeded."""
    mu = np.asarray(mu, np.float64)
    alpha = np.asarray(alpha, np.float64)
    if alpha.ndim == 1:
        alpha = np.diag(alpha)
    beta = np.asarray(beta, np.float64)
    D = len(mu)
    if alpha.shape != (D, D) or beta.shape != (D,):
        raise ValueError(
            f"shape mismatch: mu [{D}], alpha {alpha.shape}, "
            f"beta {beta.shape}")
    if (mu < 0).any() or (alpha < 0).any() or (beta <= 0).any():
        raise ValueError("need mu >= 0, alpha >= 0, beta > 0")
    B = alpha / np.maximum(beta[None, :], 1e-300)
    rho = float(np.max(np.abs(np.linalg.eigvals(B)))) if D else 0.0
    if rho >= 1.0:
        raise ValueError(
            f"supercritical model (spectral radius {rho:.3f} >= 1) — "
            f"the cluster sizes diverge; scale alpha down")
    rng = np.random.default_rng(seed)
    t = float(t_start)
    r = np.zeros(D)  # decayed excitation state per SOURCE dimension
    times, dims = [], []
    while True:
        lam = mu + alpha @ r
        M = float(lam.sum())
        if M <= 0:
            break  # silent model: no further events ever
        t_cand = t + rng.exponential(1.0 / max(M, 1e-300))
        if t_cand >= t_end:
            break
        # Host-side sampler, not kernel code: the exponent is <= 0 so the
        # decay factor lives in (0, 1] — no overflow to guard.
        r_cand = r * np.exp(-beta * (t_cand - t))
        lam_cand = mu + alpha @ r_cand
        tot = float(lam_cand.sum())
        t, r = t_cand, r_cand
        if rng.uniform() * M <= tot:
            i = int(rng.choice(D, p=lam_cand / max(tot, 1e-300)))
            times.append(t)
            dims.append(i)
            r[i] += 1.0
            if len(times) > max_events:
                raise RuntimeError(
                    f"simulate_cross_exciting exceeded {max_events} "
                    f"events before t_end={t_end} — rate too high for "
                    f"a host-side test simulation")
    return (np.asarray(times, np.float64),
            np.asarray(dims, np.int32))


def stationary_rates(mu, alpha, beta) -> np.ndarray:
    """Stationary event rates ``Lambda = (I - B)^{-1} mu`` of a
    subcritical multivariate Hawkes model (B the branching matrix
    ``alpha_ij / beta_j`` — the full matrix, so off-diagonal
    cross-excitation contributes exactly its share of the long-run
    rate).  Falls back to ``mu`` when the fit is supercritical or the
    resolvent is singular: a rate is needed even for a fit the install
    gate is about to reject."""
    mu = np.asarray(mu, np.float64)
    alpha = np.asarray(alpha, np.float64)
    if alpha.ndim == 1:  # diagonal (self-exciting) parameterization
        alpha = np.diag(alpha)
    beta = np.asarray(beta, np.float64)
    B = alpha / np.maximum(beta[None, :], 1e-300)
    try:
        ev = np.max(np.abs(np.linalg.eigvals(B))) if B.size else 0.0
        if not np.isfinite(ev) or ev >= 1.0:
            return np.maximum(mu, 0.0)
        lam = np.linalg.solve(np.eye(len(mu)) - B, mu)
    except np.linalg.LinAlgError:
        return np.maximum(mu, 0.0)
    if not np.isfinite(lam).all() or (lam < 0).any():
        return np.maximum(mu, 0.0)
    return lam


def fit_s_sink(fit_or_params, normalize: bool = True) -> np.ndarray:
    """Per-feed significance weights for the serving decision rule,
    derived from a fit: each feed's stationary rate (how much organic
    traffic competes there), mean-normalized to 1 so the learned
    weights land on the same scale as the hand-written ``s_sink=1``
    defaults — the serving ``q`` keeps its meaning across a hot-swap.
    Accepts a :class:`~redqueen_tpu_torch.learn.hawkes_mle.HawkesFit` or a
    ``(mu, alpha, beta)`` triple.  All-zero rates (a dead stream)
    degrade to uniform ones — a weight vector must never be zero."""
    if hasattr(fit_or_params, "alpha") and hasattr(fit_or_params, "mu"):
        mu = np.asarray(fit_or_params.mu, np.float64)
        alpha = np.asarray(fit_or_params.alpha, np.float64)
        beta = np.asarray(fit_or_params.beta, np.float64)
    else:
        mu, alpha, beta = (np.asarray(x, np.float64)
                           for x in fit_or_params)
    lam = stationary_rates(mu, alpha, beta)
    if normalize:
        m = float(lam.mean()) if lam.size else 0.0
        if m <= 0 or not np.isfinite(m):
            return np.ones_like(lam) if lam.size else lam
        lam = lam / max(m, 1e-300)
    return lam


def control_cost(result, q: float) -> np.ndarray:
    """The paper's control objective per sweep lane: ``int r^2 dt + q *
    posts`` over the horizon (the quantity RedQueen trades off) — the
    scalar the fitted-vs-true comparison scores.  ``result`` is a
    :class:`~redqueen_tpu_torch.sweep.SweepResult`."""
    return (np.asarray(result.int_rank2, np.float64)
            + float(q) * np.asarray(result.n_posts, np.float64))
