"""The port's policy registry and policies (redqueen_tpu_torch/models/)
against the JAX package's: each hook fed the same state (a JAX
``init_state`` carried across with ``convert.sim_state_from_numpy``), the
JAX hook under ``vmap`` over lanes, the port's batched; the Opt react's
two paths bit-equal in the port; and each policy mix through both scan
engines.

Tolerance: ``srcs``/``n_events``/``rd_ptr``/``ok`` identical; times and
excitations within rtol 1e-6 (torch's and XLA's CPU ``log1p``/``exp`` may
differ by an ulp); the port's two react paths bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random as jr

import redqueen_tpu_torch as rt
from redqueen_tpu.models import base as jbase
from redqueen_tpu.models import opt as jopt
from redqueen_tpu.models import rmtpp as _jrmtpp  # noqa: F401  (registers kind 5)
from redqueen_tpu.ops.scan_core import init_state as jinit
from redqueen_tpu_torch.models import base as tbase
from redqueen_tpu_torch.models import opt as topt
from redqueen_tpu_torch.ops import prng
import torch_parity as tp
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

B = 64


def _close(got, want, rtol=tp.RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


def test_registry_has_the_five_kinds_with_the_jax_codes():
    reg = tbase.get_registry()
    jreg = jbase.get_registry()
    # Six kinds since the RMTPP neural policy (kind 5) is ported.
    assert sorted(reg) == [0, 1, 2, 3, 4, 5] and tbase.n_kinds() == 6
    for k, pd in reg.items():
        assert pd.name == jreg[k].name == tbase.KIND_NAMES[k]
        assert pd.fire_uses_key == jreg[k].fire_uses_key
    assert (reg[tbase.KIND_OPT].on_react is not None
            and reg[tbase.KIND_OPT].react_consts is not None)
    for name in ("POISSON", "HAWKES", "PIECEWISE", "REALDATA", "OPT",
                 "RMTPP"):
        assert getattr(tbase, f"KIND_{name}") == getattr(jbase,
                                                        f"KIND_{name}")


def test_register_policy_refuses_a_taken_code():
    pd = tbase.get_registry()[tbase.KIND_POISSON]
    assert tbase.register_policy(pd) is pd       # same name: a no-op
    with pytest.raises(ValueError, match="already registered"):
        tbase.register_policy(pd._replace(name="other"))


def _jax_init(cj, pj, aj):
    keys = jax.vmap(jr.PRNGKey)(jnp.arange(B))
    return jax.jit(jax.vmap(lambda p, a, k: jinit(cj, p, a, k)))(
        pj, aj, keys)


_STATES = {}


def _states(key="every_kind"):
    """The same batch's initial carry in both packages (seeds 0..B-1),
    with the carry's excitations, fold times and cursors moved off their
    start values so the hooks see a state in mid-run; ``key`` is
    ``every_kind`` or ``opt<n>`` (:func:`torch_parity.opt_rows`)."""
    if key not in _STATES:
        _STATES[key] = _make_states(key)
    return _STATES[key]


def _make_states(key):
    fill = tp.every_kind if key == "every_kind" else tp.opt_rows(int(key[3:]))
    (cj, pj, aj), (ct, pt, at) = tp.build_both(fill, 5, 15.0, 16, B)
    sj = _jax_init(cj, pj, aj)
    rng = np.random.RandomState(9)
    S = cj.n_sources
    exc = rng.uniform(0, 2, (B, S)).astype(np.float32)
    exc_t = rng.uniform(0, 3, (B, S)).astype(np.float32)
    rd_ptr = rng.randint(0, 3, (B, S)).astype(np.int32)
    sj = sj.replace(exc=jnp.asarray(exc), exc_t=jnp.asarray(exc_t),
                    rd_ptr=jnp.asarray(rd_ptr))
    st = rt.sim_state_from_numpy(tp.state_fields(sj), device="cpu")
    return (cj, pj, aj, sj), (ct, pt, at, st)


def test_init_state_matches():
    (cj, pj, aj), (ct, pt, at) = tp.build_both(tp.every_kind, 5, 15.0, 16, B)
    sj = _jax_init(cj, pj, aj)
    from redqueen_tpu_torch.ops.scan_core import init_state

    st = init_state(ct, pt, at, prng.PRNGKey(torch.arange(B)))
    want, got = tp.state_fields(sj), rt.sim_state_to_numpy(st)
    for f, w in want.items():
        if w is None:
            assert got[f] is None, f
        elif w.dtype.kind == "f":
            _close(got[f], w)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)


KINDS = [tbase.KIND_POISSON, tbase.KIND_HAWKES, tbase.KIND_PIECEWISE,
         tbase.KIND_REALDATA, tbase.KIND_OPT]


@pytest.mark.parametrize("kind", KINDS)
def test_on_fire_matches(kind):
    (cj, pj, aj, sj), (ct, pt, at, st) = _states()
    rows = np.flatnonzero(np.asarray(pj.kind[0]) == kind)
    rng = np.random.RandomState(kind)
    s = rows[rng.randint(0, len(rows), B)].astype(np.int32)
    t = (np.asarray(sj.exc_t)[np.arange(B), s]
         + rng.uniform(0.01, 4, B)).astype(np.float32)
    u = rng.uniform(0, 1, B).astype(np.float32)
    kj = jax.vmap(lambda ks, c, i: jr.fold_in(ks[i], c[i]))(
        sj.keys, sj.ctr, jnp.asarray(s))
    fire_j = jbase.get_registry()[kind].on_fire
    uj = jax.jit(jax.vmap(fire_j))(pj, sj, jnp.asarray(s), jnp.asarray(t),
                                   kj, jnp.asarray(u))
    fire_t = tbase.get_registry()[kind].on_fire
    ut = fire_t(pt, st, torch.from_numpy(s).long(), torch.from_numpy(t),
                torch.from_numpy(np.asarray(kj).astype(np.int64)),
                torch.from_numpy(u), torch.ones(B, dtype=torch.bool))
    _close(ut.t_next.numpy(), uj.t_next)
    if ut.exc is not None:
        _close(ut.exc.numpy(), uj.exc)
        _close(ut.exc_t.numpy(), uj.exc_t)
    if ut.rd_ptr is not None:
        np.testing.assert_array_equal(ut.rd_ptr.numpy(), np.asarray(uj.rd_ptr))
    if ut.ok is not None:
        np.testing.assert_array_equal(ut.ok.numpy(), np.asarray(uj.ok))


def _react_inputs(n_opt, seed):
    (cj, pj, aj, sj), (ct, pt, at, st) = _states(f"opt{n_opt}")
    rng = np.random.RandomState(seed)
    S = cj.n_sources
    t_next = rng.uniform(1, 9, (B, S)).astype(np.float32)
    t_next[:, 0] = np.inf
    s = rng.randint(0, S, B).astype(np.int32)
    t = rng.uniform(0, 1, B).astype(np.float32)
    valid = rng.uniform(0, 1, B) < 0.9
    us = rng.uniform(0, 1, (B, S)).astype(np.float32)
    sj = sj.replace(t_next=jnp.asarray(t_next))
    st = st.replace(t_next=torch.from_numpy(t_next))
    return (cj, pj, aj, sj), (ct, pt, at, st), (s, t, valid, us)


def _react_jax(cj, pj, aj, sj, s, t, valid, us):
    def one(p, st, a, si, ti, vi, ui):
        return jopt.on_react(cj, p, st, a, a[si], si, ti, vi, ui)

    return jax.jit(jax.vmap(one))(pj, sj, aj, jnp.asarray(s),
                                  jnp.asarray(t), jnp.asarray(valid),
                                  jnp.asarray(us))


def _react_port(ct, pt, at, st, s, t, valid, us):
    consts = topt.react_consts(ct, pt, at)
    return topt.on_react(ct, pt, st, consts, torch.from_numpy(s).long(),
                         torch.from_numpy(t), torch.from_numpy(valid),
                         torch.from_numpy(us))


@pytest.mark.parametrize("n_opt", [1, 2, 5, 6])
def test_opt_react_matches_jax(n_opt):
    j, p, x = _react_inputs(n_opt, n_opt)
    tj, bj = _react_jax(*j, *x)
    tt, bt = _react_port(*p, *x)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    _close(tt.numpy(), tj)
    assert bt.any()


@pytest.mark.parametrize("n_opt", [1, 2, 5, 6])
def test_opt_react_paths_bit_equal(n_opt):
    """The unrolled rows (cfg.opt_rows, up to 4) and the masked update
    over every source (a config without present_kinds) give the same
    bits on the same inputs."""
    _, (ct, pt, at, st), x = _react_inputs(n_opt, 10 + n_opt)
    rows = ct.opt_rows
    masked_cfg = dataclasses.replace(ct, present_kinds=())
    assert topt.unrolled_rows(masked_cfg) is None
    a_t, a_b = _react_port(masked_cfg, pt, at, st, *x)
    if n_opt <= topt.UNROLL_MAX_OPT_ROWS:
        assert topt.unrolled_rows(ct) == rows
    else:
        assert topt.unrolled_rows(ct) is None
    b_t, b_b = _react_port(ct, pt, at, st, *x)
    assert torch.equal(a_b, b_b)
    assert torch.equal(a_t.view(torch.int32), b_t.view(torch.int32))


def test_react_rate_sum_folds_column_by_column():
    """The react table's sums are the sequential fold over the followers,
    the order XLA's CPU reduction takes for up to 32 of them."""
    rng = np.random.RandomState(3)
    F = 32
    gb = rt.GraphBuilder(n_sinks=F, end_time=5.0,
                         s_sink=rng.uniform(0.1, 10, F))
    gb.add_opt(q=0.37)
    for i in range(F):
        gb.add_poisson(rate=1.0, sinks=[i])
    gb.add_poisson(rate=1.0)
    cfg, p, a = gb.build(capacity=16, device="cpu")
    params, adj = rt.stack_components([p], [a])
    consts = topt.react_consts(cfg, params, adj)
    rates = torch.sqrt(params.s_sink[0] / params.q[0, 0])
    acc = torch.zeros(())
    for f in range(F):
        acc = acc + rates[f]
    # The last source posts to every feed: the row shares all F with it.
    assert consts["rate_sum"][0, 0, -1].view(torch.int32) == \
        acc.view(torch.int32)
    want = jnp.where(jnp.ones(F, bool), jnp.sqrt(
        jnp.asarray(params.s_sink[0].numpy()) / jnp.float32(0.37)), 0.0).sum()
    assert np.float32(want).view(np.int32) == acc.view(torch.int32).item()


@pytest.mark.parametrize("fill,F,T", [
    (tp.opt_rows(1), 5, 10.0), (tp.opt_rows(2), 5, 10.0),
    (tp.opt_rows(5), 5, 10.0), (tp.opt_rows(6), 5, 10.0),
])
def test_opt_mixes_match_jax_engine(fill, F, T):
    lj, lt = tp.run_both(fill, F, T, 64, 16)
    tp.assert_same_log(lj, lt)


def _only(kind_fill):
    def fill(gb):
        gb.add_opt(q=1.0)
        kind_fill(gb)
    return fill


@pytest.mark.parametrize("name,fill", [
    ("hawkes", _only(lambda gb: [gb.add_hawkes(l0=0.6, alpha=0.4, beta=1.5,
                                               sinks=[i]) for i in range(3)])),
    ("piecewise", _only(lambda gb: [gb.add_piecewise(
        [0.0, 3.0 + i, 8.0], [1.2, 0.2, 0.8], sinks=[i]) for i in range(3)])),
    ("realdata", _only(lambda gb: [gb.add_realdata(
        list(np.sort(np.random.RandomState(i).uniform(0, 12, 9 + i))),
        sinks=[i]) for i in range(3)])),
])
def test_each_kind_matches_jax_engine(name, fill):
    lj, lt = tp.run_both(fill, 3, 12.0, 32, 32)
    tp.assert_same_log(lj, lt)
    assert int(lt.n_events.sum()) > 32
