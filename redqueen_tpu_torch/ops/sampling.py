"""Point-process samplers, batched over leading axes: the counterpart of
``redqueen_tpu.ops.sampling``.

Each function takes tensors whose leading axes are lanes (and sources)
and does, element by element, the JAX function's arithmetic in the same
order, so equal inputs give equal bits wherever the two libraries' ``exp``
and ``log1p`` agree (see ``hawkes_next_time`` for where they need not).
Keyed draws come from the ``jax.random`` mirror :mod:`.prng`.

Hawkes thinning is a ``lax.while_loop`` in the JAX package, and the scan
engine runs it under ``vmap``: every lane steps until all are done, and a
finished lane's carry stops moving.  Here it is a masked loop with the
same rule (``torch.where`` keeps a finished entry's key, time and count),
which checks on the host whether any entry is still active only once
every :data:`PROBE_EVERY` proposals: the masked proposals between checks
change nothing."""

from __future__ import annotations

import torch

from .. import device as _device
from ..runtime.numerics import (
    DEFAULT_MAX_PROPOSALS,
    require_float32,
    safe_div,
    safe_exp,
    safe_log1p,
)
from . import prng

__all__ = [
    "exponential_delta",
    "exponential_from_uniform",
    "hawkes_intensity",
    "hawkes_next_time",
    "thinning_proposal",
    "piecewise_next_time",
    "piecewise_next_from_target",
    "rmtpp_log_intensity",
    "rmtpp_cum_hazard",
    "rmtpp_next_delta",
    "PROBE_EVERY",
]

#: Thinning proposals between two host checks of "is any entry active".
PROBE_EVERY = 4

_INF = float("inf")


def _inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, _INF)


def exponential_delta(key: torch.Tensor, rate: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """One Exp(rate) inter-arrival per key (``keys [..., 2]``, ``rate
    [...]``) from ``jax.random.exponential``; +inf where rate <= 0.
    ``dtype``, if given, must name float32."""
    if dtype is not None:
        require_float32(dtype, "exponential_delta")
    e = prng.exponential(key)
    rate = torch.as_tensor(rate, dtype=torch.float32, device=e.device)
    return torch.where(rate > 0, safe_div(e, rate), _inf_like(e))


def exponential_from_uniform(u: torch.Tensor, rate: torch.Tensor,
                             dtype=None) -> torch.Tensor:
    """Exp(rate) from a pre-drawn uniform word (the step panel's):
    ``-safe_log1p(-u) / rate``; +inf where rate <= 0.  ``dtype``, if
    given, must name float32."""
    if dtype is not None:
        require_float32(dtype, "exponential_from_uniform")
    e = -safe_log1p(-torch.as_tensor(u, dtype=torch.float32))
    rate = torch.as_tensor(rate, dtype=torch.float32, device=e.device)
    return torch.where(rate > 0, safe_div(e, rate), _inf_like(e))


def hawkes_intensity(t, l0, exc, exc_t, beta):
    """lambda(t) = l0 + exc * exp(-beta (t - exc_t)), with ``safe_exp``
    so a degenerate exponent stays finite."""
    return l0 + exc * safe_exp(-beta * (t - exc_t))


def thinning_proposal(key, t, lbd, l0, exc, exc_t, beta):
    """One Ogata thinning proposal from the bound ``lbd`` at ``t``: the
    key splits in three (the next key, the gap's key, the accept test's
    key), the gap is Exp(1) / lbd and the proposal is accepted when
    uniform * lbd <= the intensity there.  Returns ``(next key, proposed
    time, intensity there, accepted)``."""
    keys = prng.split(key, 3)
    gap_bits = prng.random_bits(keys[..., 1:, :])   # [..., 2]
    e = -torch.log1p(-prng.uniform_from_bits23(gap_bits[..., 0]))
    u = prng.uniform_from_bits23(gap_bits[..., 1])
    t_new = t + safe_div(e, lbd)
    lbd_new = hawkes_intensity(t_new, l0, exc, exc_t, beta)
    return keys[..., 0, :], t_new, lbd_new, u * lbd <= lbd_new


def hawkes_next_time(key, t_from, l0, alpha, beta, exc, exc_t, t_max,
                     bound_scale: float = 1.0,
                     max_proposals: int = DEFAULT_MAX_PROPOSALS,
                     return_ok: bool = False, active=None):
    """Next event time after ``t_from`` of an exponential-kernel Hawkes
    process, by Ogata thinning, for every entry of the broadcast shape of
    the float arguments (``key`` is ``[..., 2]``).

    Each proposal splits its key in three (the next key, the gap's key and
    the accept test's key), draws the gap as ``Exp(1) / bound`` and accepts
    when ``uniform * bound <= intensity``; the new intensity is the next
    bound (it only decreases between events).  An entry stops when it
    accepts, passes ``t_max``, has a bound that is not positive, or has
    made ``max_proposals`` proposals.  ``active`` (bool, broadcasting)
    marks the entries to sample; the others make no proposal and return
    +inf (and ok).

    Returns the accepted time, or +inf if none before ``t_max``; with
    ``return_ok`` also ``ok``, False where the proposal cap was hit or the
    first bound was NaN.

    One ulp of ``exp`` can flip an accept test whose two sides are within
    an ulp of each other; the entry then draws a different stream from
    there on.  torch's and XLA's CPU ``exp`` differ by an ulp on some
    arguments, so such a near-tie can separate this sampler from the JAX
    one on the same key: a precision class, not a fault."""
    if isinstance(bound_scale, (int, float)) and bound_scale < 1.0:
        raise ValueError(
            f"bound_scale must be >= 1 (got {bound_scale}): a bound below "
            f"the true intensity biases the thinning accept test")
    if not max_proposals >= 1:
        raise ValueError(f"max_proposals must be >= 1, got {max_proposals}")
    t_from, l0, alpha, beta, exc, exc_t = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.float32, device=key.device)
          for x in (t_from, l0, alpha, beta, exc, exc_t)))
    shape = t_from.shape
    key = key.expand(shape + (2,))
    live0 = (torch.ones(shape, dtype=torch.bool, device=key.device)
             if active is None else torch.as_tensor(active).expand(shape))
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=key.device)
    lbd0 = hawkes_intensity(t_from, l0, exc, exc_t, beta) * bound_scale

    n = torch.zeros(shape, dtype=torch.int32, device=key.device)
    t, lbd = t_from, lbd0
    accepted = torch.zeros(shape, dtype=torch.bool, device=key.device)

    def running():
        return (live0 & ~accepted & (t <= t_max) & (lbd > 0)
                & (n < max_proposals))

    while _device.host_read(running().any()):
        for _ in range(PROBE_EVERY):
            go = running()
            key_new, t_new, lbd_new, accept = thinning_proposal(
                key, t, lbd, l0, exc, exc_t, beta)
            key = torch.where(go[..., None], key_new, key)
            t = torch.where(go, t_new, t)
            accepted = torch.where(go, accept, accepted)
            lbd = torch.where(go, lbd_new * bound_scale, lbd)
            n = n + go.to(torch.int32)
    t_ret = torch.where(live0 & accepted & (t <= t_max), t, _inf_like(t))
    if not return_ok:
        return t_ret
    cap_hit = (~accepted & (t <= t_max) & (lbd > 0) & (n >= max_proposals))
    ok = ~(live0 & (cap_hit | torch.isnan(lbd0)))
    return t_ret, ok


def piecewise_next_from_target(target, t_from, change_times, rates):
    """Exact cumulative-hazard inversion for a piecewise-constant rate
    from a pre-drawn Exp(1) ``target``.

    ``change_times``/``rates`` are [..., K] with the segment axis last
    (+inf knots at rate 0 pad short profiles); ``target`` matches the
    leading shape and ``t_from`` broadcasts against ``change_times``.
    Returns the first time the hazard accumulated from ``t_from`` reaches
    ``target``, or +inf when the profile never gets there."""
    dtype = change_times.dtype
    target = torch.as_tensor(target).to(dtype)
    t_from = torch.as_tensor(t_from, dtype=dtype, device=change_times.device)
    K = rates.shape[-1]
    seg_end = torch.cat(
        [change_times[..., 1:],
         torch.full_like(change_times[..., :1], float("inf"))], dim=-1)
    lo = torch.maximum(change_times, t_from)  # effective segment start
    span = torch.clamp(seg_end - lo, min=0.0)
    # rate * span with 0 * inf := 0 (zero-rate final/padding segments).
    hz = torch.where(rates > 0, rates * span, torch.zeros_like(span))
    hz = torch.where(span > 0, hz, torch.zeros_like(hz))
    cum = torch.cumsum(hz, dim=-1)
    # searchsorted 'left' as a rank count: first segment reaching target.
    k = (cum < target[..., None]).sum(-1)
    k_safe = torch.clamp(k, max=K - 1)
    prev_idx = torch.clamp(k_safe - 1, min=0)
    prev = torch.where(
        k_safe > 0,
        torch.gather(cum, -1, prev_idx[..., None])[..., 0],
        torch.zeros_like(target))
    remaining = target - prev
    rate_k = torch.gather(rates, -1, k_safe[..., None])[..., 0]
    lo_k = torch.gather(lo, -1, k_safe[..., None])[..., 0]
    t_hit = lo_k + torch.where(rate_k > 0, safe_div(remaining, rate_k),
                               torch.full_like(rate_k, float("inf")))
    return torch.where(k < K, t_hit, torch.full_like(t_hit, float("inf")))


def piecewise_next_time(key, t_from, change_times, rates):
    """Next event of an inhomogeneous Poisson process with a
    piecewise-constant rate after ``t_from`` (``[...]``), by exact
    inversion of its hazard (``change_times``/``rates`` ``[..., K]``) at an
    Exp(1) target from ``jax.random.exponential(key)``.

    The result is float32 even where ``t_from`` is not: with rate 1e6 and
    ``t_from = 49.99999`` it returns ``float32(49.99999)``, a zero gap after
    rounding, as the JAX sampler does."""
    target = prng.exponential(key)
    t_from = torch.as_tensor(t_from, dtype=change_times.dtype,
                             device=change_times.device)
    return piecewise_next_from_target(target, t_from[..., None],
                                      change_times, rates)


def rmtpp_log_intensity(a, w, tau):
    """The RMTPP intensity (Du et al. 2016, the neural policy of BASELINE
    config 5): log lambda(tau) = a + w * tau, where a = v.h + b embeds the
    history and tau is the time since the source's last own event."""
    return a + w * tau


def rmtpp_cum_hazard(a, w, tau):
    """The integral of exp(a + w u) over [0, tau]: exp(a) * expm1(w tau) /
    w, and exp(a) * tau in the limit |w| < 1e-6."""
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    return safe_exp(a) * torch.where(
        small, tau, safe_div(torch.expm1(w * tau), w_safe))


def rmtpp_next_delta(key, a, w, dtype=None):
    """The next inter-event time of the intensity exp(a + w tau) by
    inverting its hazard at E from ``jax.random.exponential(key)`` (keys
    ``[..., 2]``, ``a``/``w`` broadcasting against ``[...]``): tau =
    log1p(w E exp(-a)) / w, E exp(-a) where |w| < 1e-6.  With w < 0 the
    total hazard exp(a) / (-w) is finite, and a draw past it (z = w E
    exp(-a) <= -1) never fires: +inf.  ``dtype``, if given, must name
    float32."""
    if dtype is not None:
        require_float32(dtype, "rmtpp_next_delta")
    e = prng.exponential(key)
    a = torch.as_tensor(a, dtype=torch.float32, device=e.device)
    w = torch.as_tensor(w, dtype=torch.float32, device=e.device)
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    z = w * e * safe_exp(-a)
    return torch.where(
        small, e * safe_exp(-a),
        torch.where(z > -1.0, safe_div(safe_log1p(z), w_safe),
                    _inf_like(z)))
