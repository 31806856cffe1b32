"""Rounding of float64 results to a narrower float, so that one plain
implementation runs in the precision its caller names: ``float64`` (the
reference), ``float32`` (what the configurations state) or ``bfloat16``
(the control, the next precision below float32).

An operation is computed in float64 and its result rounded once to the
named format, which is the correctly rounded result of that operation in
the narrower format."""

from __future__ import annotations

import numpy as np

__all__ = ["PRECISIONS", "below", "rounder"]

PRECISIONS = ("float64", "float32", "bfloat16")

#: The nearest precision below each one the configurations may state: the
#: control's.
_BELOW = {"float64": "float32", "float32": "bfloat16"}


def below(precision: str) -> str:
    """The precision the control runs in, for a configuration that
    states ``precision``."""
    if precision not in _BELOW:
        raise ValueError(f"no precision below {precision!r} is defined")
    return _BELOW[precision]


def _bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), through float32;
    returned as float64.  Infinities and NaNs pass through."""
    f = np.asarray(x, np.float64).astype(np.float32)
    b = f.view(np.uint32).astype(np.uint64)
    finite = np.isfinite(f)
    b = np.where(finite, (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000, b)
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def rounder(precision: str):
    """The rounding of one operation's result, ``x -> x`` rounded to
    ``precision`` and held in float64."""
    if precision == "float64":
        return lambda x: np.asarray(x, np.float64)
    if precision == "float32":
        return lambda x: np.asarray(x, np.float64).astype(
            np.float32).astype(np.float64)
    if precision == "bfloat16":
        return _bf16
    raise ValueError(f"precision must be one of {PRECISIONS}, "
                     f"got {precision!r}")
