"""Comparison baselines of the RedQueen paper's experiments, the
counterpart of ``redqueen_tpu.baselines``: budget-matched Poisson
posting and the offline optimal piecewise-constant schedule of Karimi et
al. (NIPS 2016, "Smart broadcasting: do you want to be seen?").

The offline fit: in segment s (length d_s) follower f's wall posts at
rate L[f, s]; broadcasting at rate mu_s holds the top of f's feed with
stationary probability mu_s / (mu_s + L[f, s]).  Maximise sum_s d_s
sum_f mu_s / (mu_s + L) subject to sum_s d_s mu_s = budget: concave, so
water-filling.  Per segment g_s(mu) = sum_f L / (mu + L)^2 equals a
multiplier nu; both the inner solve (mu_s for a nu) and the outer one
(nu for the budget) are monotone bisections with fixed iteration counts
(the JAX package's ``fori_loop``s, here plain loops), float32 as there.
Zero-rate (f, s) entries contribute nothing."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = ["offline_rates", "offline_visibility",
           "budget_matched_poisson_rate", "offline_schedule"]

_INNER_ITERS = 60
_OUTER_ITERS = 60


def budget_matched_poisson_rate(n_posts: float, end_time: float,
                                start_time: float = 0.0) -> float:
    """The constant Poisson rate that spends an observed run's budget."""
    return float(n_posts) / (float(end_time) - float(start_time))


def _g(mu, L, active):
    """KKT derivative sum_f L / (mu + L)^2 per segment: [S] from L [F, S]."""
    terms = torch.where(active, L / torch.square(mu[None, :] + L),
                        torch.zeros_like(L))
    return terms.sum(0)


def _mu_of_nu(nu, L, active):
    """Per-segment water level mu_s(nu), the root of g_s(mu) = nu, by
    bisection on [0, sqrt(sum_f L / nu)]; 0 where g_s(0) <= nu."""
    lo = torch.zeros(L.shape[1], dtype=L.dtype, device=L.device)
    hi = torch.sqrt(torch.where(active, L, torch.zeros_like(L)).sum(0)
                    / nu) + 1e-12
    for _ in range(_INNER_ITERS):
        mid = 0.5 * (lo + hi)
        too_low = _g(mid, L, active) > nu   # g decreasing: root above mid
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    mu = 0.5 * (lo + hi)
    return torch.where(_g(torch.zeros_like(mu), L, active) <= nu,
                       torch.zeros_like(mu), mu)


def offline_rates(wall_rates, durations, budget: float,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """Karimi-style offline optimal posting rates on ``device`` (the card
    by default).

    ``wall_rates``: [F, S] (or [S]) piecewise-constant wall intensity of
    each follower per segment; ``durations``: [S] segment lengths;
    ``budget``: expected posts over the horizon.  Returns mu [S] >= 0 with
    sum_s durations[s] * mu[s] == budget to the solver's tolerance."""
    dev = resolve_device(device)
    L = torch.as_tensor(np.asarray(wall_rates), dtype=torch.float32)
    L = torch.atleast_2d(L).to(dev)
    d = torch.as_tensor(np.asarray(durations), dtype=torch.float32).to(dev)
    active = L > 0

    def spent(nu):
        return (d * _mu_of_nu(nu, L, active)).sum()

    # Outer bisection on nu (spent decreases in nu): nu_hi = max g_s(0)
    # spends 0; nu_lo shrinks by 4 until it overspends.
    zero = torch.zeros(L.shape[1], dtype=L.dtype, device=dev)
    nu_hi = torch.clamp(_g(zero, L, active).max(), min=1e-12)
    budget = torch.tensor(float(budget), dtype=L.dtype, device=dev)
    nu_lo = nu_hi
    sp = spent(nu_lo)
    while bool(((sp < budget) & (nu_lo > 1e-30)).item()):
        nu_lo = nu_lo * 0.25
        sp = spent(nu_lo)
    for _ in range(_OUTER_ITERS):
        mid = torch.sqrt(nu_lo * nu_hi)     # log-space: nu spans decades
        over = spent(mid) > budget          # spending too much: raise nu
        nu_lo, nu_hi = (torch.where(over, mid, nu_lo),
                        torch.where(over, nu_hi, mid))
    return _mu_of_nu(torch.sqrt(nu_lo * nu_hi), L, active)


def offline_visibility(mu, wall_rates, durations) -> torch.Tensor:
    """The offline objective sum_s d_s sum_f mu_s / (mu_s + L) (zero-rate
    entries count as held), on ``mu``'s device."""
    mu = torch.as_tensor(mu)
    L = torch.atleast_2d(torch.as_tensor(np.asarray(wall_rates),
                                         dtype=mu.dtype)).to(mu.device)
    d = torch.as_tensor(np.asarray(durations), dtype=mu.dtype).to(mu.device)
    frac = torch.where(L > 0, mu[None, :] / (mu[None, :] + L),
                       torch.ones_like(L))
    return (d[None, :] * frac).sum()


def offline_schedule(wall_rates, change_times, end_time: float,
                     budget: float, device: DeviceLike = "cuda"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Fit the offline baseline and return ``(change_times, rates)`` as
    float64 numpy, ready for ``add_piecewise``/``ctrl_piecewise``;
    ``change_times`` [S] are ascending segment starts, the last segment
    ending at ``end_time``."""
    ct = np.asarray(change_times, np.float64)
    if not np.all(np.diff(ct) > 0):
        raise ValueError("change_times must be strictly increasing")
    durations = np.diff(np.concatenate([ct, [float(end_time)]]))
    if not np.all(durations > 0):
        raise ValueError(
            f"last change_time ({ct[-1]}) must precede end_time ({end_time})")
    mu = offline_rates(wall_rates, durations, budget, device=device)
    return ct, mu.cpu().numpy().astype(np.float64)
