"""The port's ``jax.random`` mirror (redqueen_tpu_torch/ops/prng.py)
against ``jax.random`` itself, with ``jax_threefry_partitionable`` pinned
to True (the layout the mirror follows), on a few hundred seeds, keys and
data words.

Tolerance: keys, bits and uniforms bit-identical; exponentials within 1
ulp (torch's and XLA's CPU ``log1p`` may differ by one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random as jr

from redqueen_tpu_torch.ops import prng
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

N = 300


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _keys(seed, n=N):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seeds", [
    np.arange(N), np.random.RandomState(1).randint(-2**31, 2**31 - 1, N),
])
def test_prng_key_matches(seeds):
    want = np.asarray(jax.vmap(jr.PRNGKey)(jnp.asarray(seeds, jnp.int32)))
    got = prng.PRNGKey(_t(seeds)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fold_in_matches():
    keys = _keys(2)
    data = np.random.RandomState(3).randint(0, 2**32, N, dtype=np.uint64) \
        .astype(np.uint32)
    data[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jax.vmap(jr.fold_in)(jnp.asarray(keys),
                                           jnp.asarray(data)))
    got = prng.fold_in(_t(keys), _t(data)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split_matches(num):
    keys = _keys(4)
    want = np.asarray(jax.vmap(lambda k: jr.split(k, num))(jnp.asarray(keys)))
    got = prng.split(_t(keys), num).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_bits_and_uniform_match():
    keys = _keys(5)
    bits_j = np.asarray(jax.vmap(lambda k: jr.bits(k, (), jnp.uint32))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(prng.random_bits(_t(keys)).numpy(),
                                  bits_j.astype(np.int64))
    u_j = np.asarray(jax.vmap(lambda k: jr.uniform(k))(jnp.asarray(keys)))
    u_t = prng.uniform(_t(keys)).numpy()
    assert u_t.dtype == np.float32
    np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))


def test_uniform_is_the_23_bit_form_not_the_panel_form():
    # All 23 mantissa bits set: 1 - 2**-23, not the panel's 24-bit value.
    bits = torch.tensor([0xFFFFFFFF, 0x00000000, 0x80000000])
    got = prng.uniform_from_bits23(bits).numpy()
    np.testing.assert_array_equal(got, np.float32([1 - 2.0**-23, 0.0, 0.5]))


def test_exponential_matches_within_an_ulp():
    keys = _keys(6)
    want = np.asarray(jax.vmap(lambda k: jr.exponential(k))(
        jnp.asarray(keys)))
    got = prng.exponential(_t(keys)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert float(prng.exponential(prng.PRNGKey(torch.tensor(42)))) == \
        pytest.approx(0.6708175, abs=1e-7)


def test_batched_leading_axes():
    keys = _keys(7, 24).reshape(4, 6, 2)
    flat = prng.fold_in(_t(keys.reshape(-1, 2)), 9).reshape(4, 6, 2)
    np.testing.assert_array_equal(prng.fold_in(_t(keys), 9).numpy(),
                                  flat.numpy())
    assert prng.split(_t(keys), 3).shape == (4, 6, 3, 2)
