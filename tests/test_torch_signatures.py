"""Keyword parity with the JAX package's signatures: a call written for the
reference runs on the port, binding each argument to the same parameter.

Each repaired gap is called with the reference's keywords and positional
order, and ``inspect.signature`` checks that the reference's parameters
come first in the port's, in the same order (the port may add keywords
after them, such as ``device``).  ``dtype`` keywords take float32
(torch's, numpy's or ``jnp.float32``) and refuse any other dtype by
name: the port computes in float32."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu import learn as jlearn
from redqueen_tpu import sim as jsim
from redqueen_tpu.learn import ingest as jingest
from redqueen_tpu.models import rmtpp as jrmtpp
from redqueen_tpu.ops import sampling as jsampling
from redqueen_tpu.ops import scan_core as jscan
from redqueen_tpu.parallel import lanes as jlanes
from redqueen_tpu_torch import learn as tlearn
from redqueen_tpu_torch import sim as tsim
from redqueen_tpu_torch.learn import ingest as tingest
from redqueen_tpu_torch.models import rmtpp as trmtpp
from redqueen_tpu_torch.ops import prng
from redqueen_tpu_torch.ops import sampling as tsampling
from redqueen_tpu_torch.ops import scan_core as tscan
from redqueen_tpu_torch.parallel import lanes as tlanes
import torch_parity as tp
from torch_parity import autotune_cache, partitionable  # noqa: F401,E501  (autouse fixtures)

PAIRS = {
    "GraphBuilder.build": (J.GraphBuilder.build, rt.GraphBuilder.build),
    "sim.init_state": (jsim.init_state, tsim.init_state),
    "scan_core.init_state": (jscan.init_state, tscan.init_state),
    "exponential_delta": (jsampling.exponential_delta,
                          tsampling.exponential_delta),
    "exponential_from_uniform": (jsampling.exponential_from_uniform,
                                 tsampling.exponential_from_uniform),
    "dispatch_slabbed": (jlanes.dispatch_slabbed, tlanes.dispatch_slabbed),
    "simulate_slabbed": (jlanes.simulate_slabbed, tlanes.simulate_slabbed),
    "rmtpp_next_delta": (jsampling.rmtpp_next_delta,
                         tsampling.rmtpp_next_delta),
    "rmtpp.fit": (jrmtpp.fit, trmtpp.fit),
    "ingest.make_stream": (jingest.make_stream, tingest.make_stream),
}
# The learn package's public functions (the port adds ``device`` after
# the reference's parameters where a function runs passes).
PAIRS.update({f"learn.{n}": (getattr(jlearn, n), getattr(tlearn, n))
              for n in ("fit_hawkes", "hawkes_loglik", "holdout_nll",
                        "chunk_events", "from_event_log", "from_traces",
                        "from_journal", "builder_params",
                        "cross_excitation_mass", "add_fit_walls",
                        "control_component", "control_cost",
                        "stationary_rates", "fit_s_sink",
                        "simulate_cross_exciting")})


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reference_parameters_lead_in_the_same_order(name):
    jfn, tfn = PAIRS[name]
    jp = list(inspect.signature(jfn).parameters.values())
    tpar = list(inspect.signature(tfn).parameters.values())
    assert [p.name for p in tpar[:len(jp)]] == [p.name for p in jp]
    for a, b in zip(jp, tpar):
        assert a.kind == b.kind, (name, a.name)


def _fill(gb):
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_poisson(rate=0.5, sinks=[1])


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, jnp.float32,
                                   "float32"], ids=str)
def test_build_takes_the_reference_positional_order(dtype):
    """``build(capacity, dtype, rmtpp_hidden)``: a positional float32 lands
    in ``dtype``, not in ``rmtpp_hidden``."""
    gbj = J.GraphBuilder(n_sinks=2, end_time=5.0)
    gbt = rt.GraphBuilder(n_sinks=2, end_time=5.0)
    _fill(gbj)
    _fill(gbt)
    cj, pj, aj = gbj.build(64, jnp.float32, 3)
    ct, pt, at = gbt.build(64, dtype, 3, "cpu")
    assert ct == rt.sim_config_from_fields(
        {f: getattr(cj, f) for f in cj.__dataclass_fields__})
    assert ct.capacity == 64 and ct.rmtpp_hidden == 3
    assert pt.rate.dtype == torch.float32
    np.testing.assert_array_equal(pt.rate.numpy(), np.asarray(pj.rate))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, jnp.bfloat16,
                                   torch.int32, "float16"], ids=str)
def test_every_dtype_keyword_refuses_other_dtypes_by_name(dtype):
    gb = rt.GraphBuilder(n_sinks=2, end_time=5.0)
    _fill(gb)
    with pytest.raises(TypeError, match="GraphBuilder.build: dtype=.*float32"):
        gb.build(64, dtype, device="cpu")
    cfg, p, a = gb.build(64, device="cpu")
    pb, ab = rt.stack_components([p], [a])
    key = prng.PRNGKey(torch.tensor([0]))
    with pytest.raises(TypeError, match="init_state"):
        tsim.init_state(cfg, pb, ab, key, dtype)
    with pytest.raises(TypeError, match="exponential_delta"):
        tsampling.exponential_delta(key, torch.ones(1), dtype)
    with pytest.raises(TypeError, match="exponential_from_uniform"):
        tsampling.exponential_from_uniform(torch.full((1,), 0.3),
                                           torch.ones(1), dtype)


def test_init_state_with_dtype_equals_the_reference_first_draws():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.every_kind, 5, 20.0, 32, 3)
    import jax
    from jax import random as jr

    keys_j = jax.vmap(jr.PRNGKey)(np.arange(3))
    sj = jax.vmap(lambda p, a, k: jscan.init_state(cj, p, a, k,
                                                   dtype=jnp.float32))(
        pj, aj, keys_j)
    st = tscan.init_state(ct, pt, at, prng.PRNGKey(torch.arange(3)),
                          dtype=jnp.float32)
    np.testing.assert_allclose(st.t_next.numpy(), np.asarray(sj.t_next),
                               rtol=1e-6)


def test_samplers_take_dtype_like_the_reference():
    import jax
    from jax import random as jr

    keys_j = jr.split(jr.PRNGKey(2), 50)
    rate = np.linspace(0.0, 3.0, 50).astype(np.float32)
    want = jax.vmap(lambda k, r: jsampling.exponential_delta(
        k, r, jnp.float32))(keys_j, rate)
    got = tsampling.exponential_delta(prng.split(prng.PRNGKey(2), 50),
                                      torch.from_numpy(rate), jnp.float32)
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin],
                               rtol=1e-6)
    u = np.linspace(0.0, 0.999, 50).astype(np.float32)
    np.testing.assert_allclose(
        tsampling.exponential_from_uniform(torch.from_numpy(u),
                                           torch.from_numpy(rate),
                                           dtype=np.float32).numpy()[1:],
        np.asarray(jsampling.exponential_from_uniform(
            u, rate, dtype=jnp.float32))[1:], rtol=1e-6)


@pytest.mark.parametrize("fn", ["dispatch_slabbed", "simulate_slabbed"])
def test_dispatch_hook_replaces_the_per_slab_dispatch(fn):
    """The ``dispatch=`` hook gets each slab's ``(cfg, params, adj,
    seeds)``, as the reference's does, and its logs are the slabs'."""
    _, (ct, pt, at) = tp.build_both(tp.golden, 4, 5.0, 16, 5)
    calls = []

    def dispatch(c, p, a, s):
        calls.append((p.kind.shape[0], a.shape[0], list(s)))
        return rt.simulate_batch(c, p, a, s, device="cpu")

    out = getattr(tlanes, fn)(ct, pt, at, np.arange(5), 2,
                              dispatch=dispatch, device="cpu")
    assert calls == [(2, 2, [0, 1]), (2, 2, [2, 3]), (1, 1, [4])]
    whole = rt.simulate_batch(ct, pt, at, np.arange(5), device="cpu")
    if fn == "dispatch_slabbed":
        assert len(out) == 3
        out = tlanes.concat_slab_logs(ct, out)
    w = out.srcs.shape[1]
    assert torch.equal(out.srcs, whole.srcs[:, :w])
    assert bool((whole.srcs[:, w:] == -1).all())
