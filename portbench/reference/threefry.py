"""Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1,
2, 3", SC'11) in plain NumPy on uint32 words, and the two ways the
system turns its words into draws.

Every draw of the simulator and of the serving apply is a pure function
of a key and a counter, so the reference computes the same words from the
same seeds without taking anything from the program."""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "uniform24", "uniform23", "exp1"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1):
    """One block of 20 rounds: key ``(k0, k1)``, counter ``(x0, x1)`` ->
    two uint32 words, elementwise over the broadcast shape."""
    k0, k1, x0, x1 = np.broadcast_arrays(*(
        np.asarray(v).astype(np.uint64).astype(np.uint32)
        for v in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for group in range(5):
            for r in _ROTATIONS[group % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(group + 1) % 3]
            x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def uniform24(bits) -> np.ndarray:
    """A word's top 24 bits times 2^-24: a float in [0, 1), exact in
    float64."""
    return (np.asarray(bits, np.uint32) >> np.uint32(8)).astype(np.float64) \
        * 2.0 ** -24


def uniform23(bits) -> np.ndarray:
    """A word's top 23 bits as the mantissa of a float in [1, 2), minus 1:
    ``jax.random.uniform``'s float32 construction, exact in float64."""
    return (np.asarray(bits, np.uint32) >> np.uint32(9)).astype(np.float64) \
        * 2.0 ** -23


def exp1(u) -> np.ndarray:
    """Exp(1) by inversion of a uniform, in float64: ``-log1p(-u)``."""
    return -np.log1p(-np.asarray(u, np.float64))
