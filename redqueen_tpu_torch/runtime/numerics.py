"""Numerics guard for the port: the per-lane health-bit protocol, the
guarded primitives the samplers use (``safe_exp``, ``safe_log``,
``safe_log1p``, ``safe_div``, ``nan_to_posinf``), the thinning loop's
proposal cap, and deterministic lane poisoning for fault injection.

The bit values, messages and semantics are those of
``redqueen_tpu.runtime.numerics``: a lane whose health word is non-zero
was frozen by the engine on the step the fault appeared, and a run in
which every lane is sick raises :class:`NumericalHealthError` instead of
returning garbage."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

__all__ = [
    "safe_exp", "safe_log", "safe_log1p", "safe_div", "finite_or",
    "nan_to_posinf", "require_float32", "DEFAULT_MAX_PROPOSALS",
    "HEALTH_OK", "BIT_NONFINITE_TIME", "BIT_NONFINITE_STATE",
    "BIT_SAMPLER_FAILURE", "BIT_NONFINITE_RESULT", "HEALTH_BITS",
    "decode_health", "describe_health", "sick_lanes",
    "NumericalHealthError", "poison_lane", "POISON_MODES",
]


def require_float32(dtype, where: str) -> torch.dtype:
    """``torch.float32`` for a ``dtype=`` argument that names float32
    (torch's, numpy's or the JAX package's ``jnp.float32``, or the
    string); any other dtype raises ``TypeError`` naming it and
    ``where``.  The port computes in float32 throughout: the keyword is
    there so that calls written for the JAX package's signatures run."""
    if dtype is torch.float32:
        return torch.float32
    try:
        ok = np.dtype(dtype) == np.float32
    except TypeError:
        ok = False
    if not ok:
        raise TypeError(
            f"{where}: dtype={dtype!r} is not supported — the port "
            f"computes in float32 only")
    return torch.float32


def _exp_cap(dtype: torch.dtype) -> float:
    """Largest exponent safe_exp passes through (f32 overflows at ~88.7,
    f64 at ~709.8)."""
    return 80.0 if torch.finfo(dtype).bits <= 32 else 700.0


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` with the exponent clamped below the dtype's overflow
    point: identical to ``exp`` on healthy inputs, a large finite value
    (never +inf) for a divergent exponent; NaN stays NaN."""
    return torch.exp(torch.clamp(x, max=_exp_cap(x.dtype)))


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` with the argument clamped to the smallest positive
    normal: identical on strictly positive inputs, a large finite negative
    (never -inf or NaN) for zero, negative or NaN arguments."""
    tiny = torch.finfo(x.dtype).tiny
    x = torch.where(torch.isnan(x), torch.full_like(x, tiny), x)
    return torch.log(torch.clamp(x, min=tiny))


def safe_log1p(x: torch.Tensor) -> torch.Tensor:
    """``log1p(x)`` clamped above -1: identical on every representable
    argument in (-1, inf) (the floor is the smallest representable value
    above -1, ``-(1 - eps/2)``, so ``-u`` for ``u = 1 - 2**-24`` passes),
    a finite negative for x <= -1 and NaN."""
    floor = -(1.0 - torch.finfo(x.dtype).eps / 2)
    x = torch.where(torch.isnan(x), torch.full_like(x, floor), x)
    return torch.log1p(torch.clamp(x, min=floor))


def safe_div(num: torch.Tensor, den: torch.Tensor,
             when_zero: float = float("inf")) -> torch.Tensor:
    """``num / den`` with ``when_zero`` where ``den == 0``; the division
    runs against a guarded denominator so no 0/0 NaN is ever formed."""
    zero = den == 0
    out = num / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.full_like(out, when_zero), out)


def finite_or(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x`` where finite, ``fill`` elsewhere (NaN and both infinities)."""
    return torch.where(torch.isfinite(x), x, torch.full_like(x, fill))


def nan_to_posinf(x: torch.Tensor) -> torch.Tensor:
    """NaN -> +inf, the engine's write-back sanitiser: +inf is the legal
    "never fires" clock, so a poisoned resample absorbs instead of
    poisoning the argmin (the health word records the substitution)."""
    return torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)


#: Proposals after which Hawkes thinning gives up, flagged as a sampler
#: failure: valid parameters accept within a handful, so only degenerate
#: ones (a NaN or overflowed bound) reach it.
DEFAULT_MAX_PROPOSALS = 1_000_000

#: A healthy lane's word.
HEALTH_OK = 0
#: A NaN event time was selected, or a policy resample returned NaN.
BIT_NONFINITE_TIME = 1 << 0
#: A per-source state slice (Hawkes excitation) went non-finite.
BIT_NONFINITE_STATE = 1 << 1
#: A sampler failed internally (thinning cap; the scan engine only).
BIT_SAMPLER_FAILURE = 1 << 2
#: Host-side backstop on a reduced result grid (sweep layer only).
BIT_NONFINITE_RESULT = 1 << 3

HEALTH_BITS: Dict[int, str] = {
    BIT_NONFINITE_TIME: "non-finite event time",
    BIT_NONFINITE_STATE: "non-finite per-source state",
    BIT_SAMPLER_FAILURE: "sampler failure (thinning cap / bad intensity)",
    BIT_NONFINITE_RESULT: "non-finite result grid value",
}


def _host(health) -> np.ndarray:
    if isinstance(health, torch.Tensor):
        health = health.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(health))


def decode_health(bits: int) -> List[str]:
    """Human-readable reasons for one lane's health word."""
    bits = int(bits)
    out = [name for bit, name in sorted(HEALTH_BITS.items()) if bits & bit]
    unknown = bits & ~sum(HEALTH_BITS)
    if unknown:
        out.append(f"unknown bits 0x{unknown:x}")
    return out


def describe_health(health) -> Dict[int, List[str]]:
    """``{lane_index: reasons}`` for every sick lane of a health array."""
    h = _host(health)
    return {int(i): decode_health(h[i]) for i in np.flatnonzero(h)}


def sick_lanes(health) -> np.ndarray:
    """Flat indices of the non-zero entries of a health array."""
    return np.flatnonzero(_host(health))


class NumericalHealthError(RuntimeError):
    """Every lane of a simulation died numerically; carries the raw
    per-lane ``health`` words and the decoded ``reasons``."""

    def __init__(self, health, context: str = "simulation"):
        self.health = _host(health)
        self.reasons = describe_health(self.health)
        lanes = ", ".join(
            f"lane {i}: {'; '.join(r)}" for i, r in
            sorted(self.reasons.items())[:8]
        )
        more = "" if len(self.reasons) <= 8 else (
            f" (+{len(self.reasons) - 8} more)")
        super().__init__(
            f"{context}: all {self.health.size} lane(s) numerically dead — "
            f"{lanes}{more}. Inputs were host-validated, so this is "
            f"in-computation corruption (or injected via RQ_FAULT=numeric); "
            f"re-run the lanes or inspect the carry."
        )


POISON_MODES = ("nan", "inf")


def poison_lane(state, lane: int, mode: str = "nan"):
    """Plant a deterministic numeric fault in one lane of an engine state:
    a dataclass with ``t_next``/``exc`` tensors, batched ``[B, S]`` (the
    fused engine's state, ``config.SimState``) or single ``[S]``, where
    ``lane`` must be 0.

    - ``nan``: source 0's scheduled ``t_next`` becomes NaN; the argmin
      selects it and the lane freezes with ``BIT_NONFINITE_TIME``.
    - ``inf``: source 0's Hawkes excitation becomes +inf; its next own
      fire trips ``BIT_NONFINITE_STATE``.

    Returns a new state; the input's tensors are not modified."""
    if mode not in POISON_MODES:
        raise ValueError(
            f"unknown poison mode {mode!r} (want {'|'.join(POISON_MODES)})")
    batched = state.t_next.dim() == 2
    if not batched and lane != 0:
        raise ValueError(
            f"unbatched state has exactly one lane, got lane={lane}")
    idx = (lane, 0) if batched else (0,)
    if mode == "nan":
        t_next = state.t_next.clone()
        t_next[idx] = float("nan")
        return dataclasses.replace(state, t_next=t_next)
    exc = state.exc.clone()
    exc[idx] = float("inf")
    return dataclasses.replace(state, exc=exc)
