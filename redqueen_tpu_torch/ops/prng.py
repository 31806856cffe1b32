"""The ``jax.random`` draws the scan engine makes, mirrored bit for bit on
:func:`.threefry.threefry2x32`.

The JAX scan engine draws from two places: its per-step panel (threefry
on the component key, see ``ops.scan_core``) and ``jax.random`` for the
per-source streams (``fold_in`` for the source keys and each fire key,
``split`` and ``uniform``/``exponential`` inside Hawkes thinning and the
piecewise sampler).  This module is the second of them.

The layout is the one of ``jax_threefry_partitionable=True``, which
jax 0.5 and later take by default.  A key is two uint32 words ``(k0, k1)``
and

- ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``;
- ``fold_in(key, d)`` is ``threefry(key; 0, d)``;
- ``split(key, n)[i]`` is ``threefry(key; 0, i)``;
- a scalar 32-bit draw is ``w0 ^ w1`` of ``threefry(key; 0, 0)``, and
  element ``i`` of a draw of shape ``shape`` (flat, row-major index ``i``)
  is ``w0 ^ w1`` of ``threefry(key; 0, i)``;
- ``uniform`` keeps the draw's top 23 bits as the mantissa of a float in
  [1, 2) and subtracts 1 (not the panel's 24-bit
  :func:`.threefry.uniform_from_bits`), and ``exponential`` is
  ``-log1p(-uniform)``.

The ``False`` layout (jax < 0.5) splits and draws differently and is not
mirrored.  Keys are tensors ``[..., 2]`` of uint32 words on the int64
carrier of :mod:`.threefry`; every function maps over the leading axes."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .threefry import MASK32, threefry2x32

__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "uniform",
           "exponential", "uniform_from_bits23"]

_ONE_F32_BITS = 0x3F800000


def PRNGKey(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` of integer seeds ``[...]`` -> keys
    ``[..., 2]``."""
    seed = torch.as_tensor(seed).to(torch.int64) & MASK32
    return torch.stack([torch.zeros_like(seed), seed], -1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and uint32 data
    broadcasting against ``[...]`` (a vector of data folds one key into
    many) -> keys ``[..., 2]``."""
    w0, w1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([w0, w1], -1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    w0, w1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    return torch.stack([w0, w1], -1)


def random_bits(key: torch.Tensor, shape: Tuple[int, ...] = ()
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` per key: keys ``[..., 2]`` ->
    uint32 words ``[..., *shape]`` (one word per key for ``shape=()``)."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError(f"draw of {n} words exceeds the 32-bit counter")
    if not shape:
        w0, w1 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
        return w0 ^ w1
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    w0, w1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    return (w0 ^ w1).reshape(key.shape[:-1] + shape)


def uniform_from_bits23(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) the way ``jax.random.uniform``
    makes them: the top 23 bits as the mantissa of [1, 2), minus 1."""
    f = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 per key ->
    ``[..., *shape]``."""
    return uniform_from_bits23(random_bits(key, shape))


def exponential(key: torch.Tensor,
                shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.exponential(key, shape)`` in float32 per key:
    ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, shape))
