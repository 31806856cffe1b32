"""The port's RMTPP neural policy (``redqueen_tpu_torch/models/rmtpp.py``,
its samplers, its scan-engine paths, ``rmtpp_stream``, the star
controller and config 5) against the JAX package's on the CPU, at the
same seeds and the same weights (``jax_threefry_partitionable`` pinned to
True), and the counterparts of ``tests/test_rmtpp.py``.

Tolerances, each stated where it is used:

- samplers at the same keys: +inf pattern identical, values within rtol
  1e-5 (torch's and XLA's CPU ``log1p``/``exp`` differ by an ulp now and
  then, and ``log1p(z)`` amplifies it where z nears -1: 1 draw in 3,384
  differs by 1.6e-6);
- the GRU step and the head against the flax cell: within 1e-6
  absolute (a few ulps: XLA's CPU ``tanh`` and its dot order are not
  torch's);
- ``sequence_nll`` and its gradient against ``jax.value_and_grad``: rtol
  1e-5 (a sum over 24 events in another order, and the ulps above);
- the fit curve from the same initial weights: rtol 1e-3 at every one of
  config 5's 120 steps (Adam amplifies the gradient's ulps);
- held-out NLL after ``fit_traces``: within 0.01 nats per event;
- simulations: ``tests/torch_parity.assert_same_log`` (sources identical,
  times within rtol 1e-6), final ``h`` within rtol 1e-5; streams and the
  star run: counts identical, times within rtol 1e-5;
- statistical tests: 4 sigma of the Monte-Carlo spread."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random as jr

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu import presets as jpresets
from redqueen_tpu.models import rmtpp as JR
from redqueen_tpu.ops import sampling as jsampling
from redqueen_tpu.ops import streams as jstreams
from redqueen_tpu.parallel import bigf as JB
from redqueen_tpu_torch import presets
from redqueen_tpu_torch.convert import (
    RMTPP_CHECKPOINT0,
    load_rmtpp_npz,
    rmtpp_weights_from_jax,
    rmtpp_weights_to_jax,
)
from redqueen_tpu_torch.models import rmtpp as TR
from redqueen_tpu_torch.ops import prng
from redqueen_tpu_torch.ops import sampling as tsampling
from redqueen_tpu_torch.ops import streams as tstreams
from redqueen_tpu_torch.oracle.numpy_ref import RMTPP as OracleRMTPP
from redqueen_tpu_torch.oracle.numpy_ref import SimOpts
from redqueen_tpu_torch.parallel import bigf as TB
from redqueen_tpu_torch.utils import metrics_pandas as mp
import torch_parity as tp
from torch_parity import autotune_cache, partitionable  # noqa: F401,E501  (autouse fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def jax_weights(seed, hidden):
    """The reference's initial weights and the same weights in the port."""
    wj = JR.init_weights(jr.PRNGKey(seed), hidden=hidden)
    return wj, rmtpp_weights_from_jax(jax.tree.map(np.asarray, wj), CPU)


def np64(w):
    """The port's weights as the oracle's float64 tree."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        rmtpp_weights_to_jax(w))


def tkeys(seed, n):
    return prng.split(prng.PRNGKey(seed), n)


def same_times(port, ref, rtol):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def test_samplers_match_jax_at_the_same_keys():
    """Every branch: w of either sign, |w| < 1e-6 (constant intensity) and
    w < 0 draws past the finite total hazard (+inf)."""
    n = 4000
    rng = np.random.RandomState(0)
    a = rng.uniform(-3, 2, n).astype(np.float32)
    w = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    w[::7] = 0.0
    w[1::11] = 5e-7
    keys_j = jr.split(jr.PRNGKey(3), n)
    got = tsampling.rmtpp_next_delta(tkeys(3, n), torch.from_numpy(a),
                                     torch.from_numpy(w))
    want = jax.vmap(jsampling.rmtpp_next_delta)(keys_j, a, w)
    assert np.isinf(np.asarray(want)).sum() > 100
    same_times(got, want, rtol=1e-5)
    tau = np.where(np.isfinite(np.asarray(want)), np.asarray(want), 0.5)
    tau = tau.astype(np.float32)
    np.testing.assert_allclose(
        tsampling.rmtpp_cum_hazard(*map(torch.from_numpy, (a, w, tau))),
        jsampling.rmtpp_cum_hazard(a, w, tau), rtol=1e-6)
    np.testing.assert_array_equal(
        tsampling.rmtpp_log_intensity(*map(torch.from_numpy, (a, w, tau))),
        jsampling.rmtpp_log_intensity(a, w, tau))


def test_constant_intensity_limit():
    # w = 0: lambda = exp(a); the mean gap is exp(-a) = 0.5.
    taus = tsampling.rmtpp_next_delta(tkeys(0, 4000), np.log(2.0),
                                      torch.tensor(0.0))
    assert abs(float(taus.mean()) - 0.5) < 0.05


def test_negative_w_can_never_fire():
    # Total hazard exp(a) / (-w) = 0.1: about 90% of draws never fire.
    taus = tsampling.rmtpp_next_delta(tkeys(1, 2000), np.log(0.1),
                                      torch.tensor(-1.0))
    assert abs(float(torch.isinf(taus).double().mean()) - np.exp(-0.1)) \
        < 0.05


def test_inverse_matches_hazard():
    # Lambda(tau drawn) is Exp(1): mean 1.
    a, w = torch.tensor(0.3), torch.tensor(0.7)
    taus = tsampling.rmtpp_next_delta(tkeys(2, 4000), a, w)
    haz = tsampling.rmtpp_cum_hazard(a, w, taus)
    assert abs(float(haz.mean()) - 1.0) < 0.06


def test_dtype_keyword_names_float32_only():
    k = tkeys(0, 3)
    tsampling.rmtpp_next_delta(k, 0.0, torch.tensor(0.5), dtype=jnp.float32)
    with pytest.raises(TypeError, match="float32"):
        tsampling.rmtpp_next_delta(k, 0.0, torch.tensor(0.5),
                                   dtype=torch.float64)


# ---------------------------------------------------------------------------
# The cell, the head and the weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [8, 16])
def test_cell_and_head_match_the_flax_cell(hidden):
    """The GRU step and the head on 500 states and gaps, against the flax
    cell applied one sample at a time (atol 1e-6)."""
    wj, wt = jax_weights(3, hidden)
    rng = np.random.RandomState(hidden)
    hs = (rng.randn(500, hidden) * 0.7).astype(np.float32)
    taus = rng.exponential(1.0, 500).astype(np.float32)
    taus[:5] = [0.0, 1e-4, 3.0, 40.0, 0.3]
    want_h = jax.vmap(lambda h, t: JR._step_h(wj, h, t))(hs, taus)
    want_a = jax.vmap(lambda h: JR._head(wj, h)[0])(hs)
    got_h = TR._step_h(wt, torch.from_numpy(hs), torch.from_numpy(taus))
    got_a, got_w = TR._head(wt, torch.from_numpy(hs))
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_a.numpy(), want_a, atol=1e-6, rtol=0)
    assert float(got_w) == float(JR._head(wj, hs[0])[1])
    cell = TR.RMTPPCell(hidden, weights=wt)
    h2, (a2, _) = cell.step_and_head(torch.from_numpy(hs),
                                     torch.from_numpy(taus))
    assert torch.equal(h2, got_h.detach()) or torch.allclose(h2, got_h)
    names = {n for n, _ in cell.named_parameters()}
    assert {"gru.ir.kernel", "gru.ir.bias", "gru.hr.kernel",
            "gru.hn.bias", "v.kernel", "v.bias", "w"} <= names
    assert "gru.hr.bias" not in names and "gru.hz.bias" not in names


def test_init_weights_distributions_and_constants():
    """flax's initialisers (the draws are torch's): lecun-normal input
    kernels truncated at 2 sigma, orthogonal hidden kernels, zero
    biases, w = -0.1; the tree has the reference's structure and
    shapes."""
    H = 64
    w = TR.init_weights(7, hidden=H, device=CPU)
    wj = JR.init_weights(jr.PRNGKey(0), hidden=H)
    shapes = jax.tree.map(lambda a: np.shape(a), wj)
    assert jax.tree.map(lambda t: tuple(t.shape),
                        rmtpp_weights_to_jax(w)) == shapes
    for k in TR.GATES_H:
        K = w["gru"][k]["kernel"].double()
        np.testing.assert_allclose((K.T @ K).numpy(), np.eye(H), atol=1e-5)
    std = 1.0 / np.sqrt(H) / 0.87962566103423978
    kv = w["v"]["kernel"]
    assert float(kv.abs().max()) <= 2 * std + 1e-7
    assert abs(float(kv.std()) - 1.0 / np.sqrt(H)) < 0.35 / np.sqrt(H)
    ki = torch.cat([w["gru"][k]["kernel"].reshape(-1) for k in TR.GATES_IN])
    assert float(ki.abs().max()) <= 2 / np.sqrt(2) / 0.8796256610342398 + 1e-6
    for k in TR.GATES_IN + ("hn",):
        assert not w["gru"][k]["bias"].any()
    assert not w["v"]["bias"].any() and float(w["w"]) == np.float32(-0.1)
    again = TR.init_weights(7, hidden=H, device=CPU)
    assert torch.equal(again["v"]["kernel"], kv)


# ---------------------------------------------------------------------------
# Likelihood and training
# ---------------------------------------------------------------------------


def _fit_data(seed=0):
    rng = np.random.RandomState(seed)
    taus = rng.exponential(0.7, (32, 24)).astype(np.float32)
    mask = np.ones_like(taus, bool)
    mask[3, 20:] = False
    return taus, mask


def test_sequence_nll_and_gradient_match_jax():
    wj, wt = jax_weights(4, 8)
    taus, mask = _fit_data()
    lj, gj = jax.value_and_grad(JR.nll_loss)(wj, taus, mask, 8)
    cell = TR.RMTPPCell(8, weights=wt)
    lt = TR.nll_loss(cell.weights(), torch.from_numpy(taus),
                     torch.from_numpy(mask), 8)
    gt = torch.autograd.grad(lt, list(cell.parameters()))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    by_name = dict(zip([n for n, _ in cell.named_parameters()], gt))
    flat_j = {"/".join(str(k.key) for k in path): v for path, v in
              jax.tree_util.tree_leaves_with_path(gj)}
    assert len(flat_j) == len(by_name) == 13
    for name, g in by_name.items():
        want = np.asarray(flat_j[name.replace(".", "/")])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    per = TR.sequence_nll(wt, torch.from_numpy(taus[:2]),
                          torch.from_numpy(mask[:2]), 8)
    assert per.shape == (2,)


def test_fit_curve_matches_optax_from_the_same_weights():
    """Config 5's fit (hidden 8, 120 steps, lr 1e-2) from the reference's
    initial weights: the loss curve within rtol 1e-3 at every step."""
    taus, mask = _fit_data()
    wj, wt = jax_weights(0, 8)
    _, _, lj = JR.fit(jr.PRNGKey(0), taus, mask, hidden=8, steps=120,
                      weights=wj)
    w, state, lt = TR.fit(0, taus, mask, hidden=8, steps=120, weights=wt,
                          device=CPU)
    assert lt.shape == (120,) and lt.dtype == np.float64
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-3)
    assert state["count"] == 120 and lt[-1] < lt[0]


def test_fit_resumes_from_checkpointed_state(tmp_path):
    """Training goes on from returned ``weights``/``opt_state``, and from
    a ``ckpt_path=`` checkpoint, where the resumed curve is the
    uninterrupted one bit for bit."""
    rng = np.random.RandomState(1)
    taus = rng.exponential(0.5, (16, 32))
    mask = np.ones((16, 32), bool)
    w1, opt1, l1 = TR.fit(4, taus, mask, hidden=8, steps=50, device=CPU)
    w2, opt2, l2 = TR.fit(4, taus, mask, hidden=8, steps=50, weights=w1,
                          opt_state=opt1, device=CPU)
    assert l2[-1] <= l1[0] and opt2["count"] == 100
    w3, _, l3 = TR.fit(4, taus, mask, hidden=8, steps=100, device=CPU)
    np.testing.assert_allclose(np.concatenate([l1, l2]), l3, rtol=1e-6)
    ck = str(tmp_path / "fit.npz")
    TR.fit(4, taus, mask, hidden=8, steps=50, ckpt_path=ck, ckpt_every=25,
           device=CPU)
    _, opt4, l4 = TR.fit(4, taus, mask, hidden=8, steps=100, ckpt_path=ck,
                         ckpt_every=25, device=CPU)
    np.testing.assert_array_equal(l4, l3)
    assert opt4["count"] == 100


def test_fit_takes_a_torch_optimizer_factory():
    taus, mask = _fit_data()
    w, st, losses = TR.fit(1, taus, mask, hidden=4, steps=20, device=CPU,
                           optimizer=lambda p: torch.optim.SGD(p, lr=1e-2))
    assert losses[-1] < losses[0] and "state" in st


def test_fit_learns_poisson_rate():
    """Gaps of a rate-2 Poisson process: the fitted policy's event count
    approaches 2 T."""
    rng = np.random.RandomState(0)
    B, L, rate, T = 64, 64, 2.0, 30.0
    taus = rng.exponential(1.0 / rate, (B, L))
    w, _, losses = TR.fit(3, taus, np.ones((B, L), bool), hidden=8,
                          steps=200, lr=2e-2, device=CPU)
    assert losses[-1] < losses[0]
    gb = rt.GraphBuilder(n_sinks=1, end_time=T)
    gb.add_rmtpp()
    cfg, params, adj = gb.build(capacity=512, rmtpp_hidden=8, device=CPU)
    p, a = rt.stack_components([TR.attach(params, w)] * 16, [adj] * 16)
    log = rt.simulate_batch(cfg, p, a, np.arange(16), device=CPU)
    mean_events = float(log.n_events.double().mean())
    assert abs(mean_events - rate * T) < 0.25 * rate * T, mean_events


def test_gaps_from_traces_roundtrip_and_equal_jax():
    from redqueen_tpu.data.traces import gaps_from_traces as j_gaps
    from redqueen_tpu_torch.data.traces import gaps_from_traces

    traces = [np.array([1.0, 2.5, 6.0]), np.array([]), np.array([4.0])]
    taus, mask = gaps_from_traces(traces)
    assert taus.shape == mask.shape == (3, 3)
    assert np.allclose(taus[0], [1.0, 1.5, 3.5])
    assert mask.sum() == 4 and not mask[1].any()
    assert np.allclose(np.cumsum(taus[0])[mask[0]], traces[0])
    for got, want in zip((taus, mask), j_gaps(traces)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="truncate"):
        gaps_from_traces(traces, length=2)


def test_fit_traces_matches_jax_heldout_nll(monkeypatch):
    """The learned-broadcasting loop on a synthetic corpus from the
    reference's initial weights (the port's ``init_weights`` is patched to
    return them, as its draws are torch's): the same split, the initial held-out
    NLL within rtol 1e-5, the fitted one within 0.01 nats per event, and
    training beats the initial weights on held-out users."""
    from redqueen_tpu.data import traces as jtr

    corpus = jtr.synthetic_twitter(seed=3, n_users=24, end_time=40.0,
                                   mean_rate=1.0)
    wj, wt = jax_weights(7, 8)
    _, lj, ij = JR.fit_traces(jr.PRNGKey(7), corpus, hidden=8, steps=80,
                              lr=2e-2)
    with monkeypatch.context() as mp_:
        mp_.setattr(TR, "init_weights", lambda key, hidden, device: wt)
        w, lt, it = TR.fit_traces(7, corpus, hidden=8, steps=80, lr=2e-2,
                                  device=CPU)
    for k in ("train_users", "heldout_users", "heldout_events",
              "heldout_user_indices", "heldout_per_trace_events"):
        assert it[k] == ij[k]
    np.testing.assert_allclose(it["heldout_nll_init"],
                               ij["heldout_nll_init"], rtol=1e-5)
    assert abs(it["heldout_nll"] - ij["heldout_nll"]) < 0.01
    assert lt[-1] < lt[0]
    assert it["heldout_nll"] < it["heldout_nll_init"]
    _, _, own = TR.fit_traces(7, corpus, hidden=8, steps=80, lr=2e-2,
                              device=CPU)
    assert own["heldout_nll"] < own["heldout_nll_init"]


def test_calibrate_budget_matches_jax_and_its_target():
    """The bias shift from the same weights and seeds equals the
    reference's, and realized posts land near the target."""
    wj, wt = jax_weights(11, 8)
    T, target = 20.0, 30.0
    kw = dict(n_seeds=8, iters=4)
    cj = JR.calibrate_budget(wj, target, T, **kw)
    ct = TR.calibrate_budget(wt, target, T, device=CPU, **kw)
    np.testing.assert_allclose(ct["v"]["bias"].numpy(),
                               np.asarray(cj["v"]["bias"]), rtol=1e-6)
    gb = rt.GraphBuilder(n_sinks=1, end_time=T)
    src = gb.add_rmtpp()
    cfg, params, adj = gb.build(capacity=512, rmtpp_hidden=8, device=CPU)
    p, a = rt.stack_components([TR.attach(params, ct)] * 16, [adj] * 16)
    lg = rt.simulate_batch(cfg, p, a, np.arange(16) + 123, device=CPU)
    realized = float(rt.num_posts(lg.srcs, src).double().mean())
    assert abs(realized - target) / target < 0.25, realized


# ---------------------------------------------------------------------------
# The scan engine
# ---------------------------------------------------------------------------


def rmtpp_component(pkg, w, F=3, T=20.0, hidden=8, capacity=256, B=1,
                    opt=False, **kw):
    gb = pkg.GraphBuilder(n_sinks=F, end_time=T)
    src = gb.add_rmtpp()
    for i in range(F):
        gb.add_poisson(rate=1.0, sinks=[i])
    if opt:
        gb.add_opt(q=1.0)
    cfg, params, adj = gb.build(capacity=capacity, rmtpp_hidden=hidden,
                                **kw)
    params = (JR if pkg is J else TR).attach(params, w)
    if B > 1:
        params, adj = pkg.stack_components([params] * B, [adj] * B)
    return cfg, params, adj, src


@pytest.mark.parametrize("hidden,opt", [(8, False), (16, True)])
def test_scan_engine_matches_jax(hidden, opt):
    """One RMTPP row among Poisson walls (and an Opt row): the port's scan
    engine against the JAX scan engine at 12 seeds, and the final
    recurrent state."""
    wj, wt = jax_weights(5, hidden)
    B = 12
    cj, pj, aj, _ = rmtpp_component(J, wj, hidden=hidden, B=B, opt=opt,
                                    capacity=128)
    ct, pt, at, src = rmtpp_component(rt, wt, hidden=hidden, B=B, opt=opt,
                                      capacity=128, device=CPU)
    lj, sj = J.simulate_batch(cj, pj, aj, np.arange(B), return_state=True)
    lt, st = rt.simulate_batch(ct, pt, at, np.arange(B), return_state=True,
                               device=CPU)
    tp.assert_same_log(lj, lt)
    assert int((lt.srcs == src).sum()) > 5 * B
    np.testing.assert_allclose(st.h.numpy(), np.asarray(sj.h), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.exc_t.numpy(), np.asarray(sj.exc_t),
                               rtol=1e-6)
    np.testing.assert_array_equal(st.ctr.numpy(), np.asarray(sj.ctr))


def test_rmtpp_as_broadcaster_among_walls():
    _, wt = jax_weights(5, 8)
    cfg, params, adj, src = rmtpp_component(rt, wt, device=CPU)
    log = rt.simulate(cfg, params, adj, seed=0, device=CPU)
    assert int(log.n_events) > 0
    assert int(rt.num_posts(log.srcs[None], src)[0]) > 0
    assert int((log.srcs > 0).sum()) > 0


def test_last_own_event_time_persists():
    """exc_t doubles as RMTPP's last own event time in a component without
    Hawkes rows."""
    _, wt = jax_weights(5, 8)
    cfg, params, adj, src = rmtpp_component(rt, wt, device=CPU)
    log, st = rt.simulate(cfg, params, adj, seed=0, return_state=True,
                          device=CPU)
    own = log.times[log.srcs == src]
    assert len(own) > 0
    np.testing.assert_allclose(float(st.exc_t[0, src]), float(own.max()),
                               rtol=1e-6)


def test_missing_weights_clear_error():
    gb = rt.GraphBuilder(n_sinks=1, end_time=5.0)
    gb.add_rmtpp()
    cfg, params, adj = gb.build(capacity=32, device=CPU)
    with pytest.raises(ValueError, match="rmtpp"):
        rt.simulate(cfg, params, adj, seed=0, device=CPU)


def test_host_checks_refuse_bad_weights():
    """Non-finite weight leaves and a hidden size other than the
    config's are refused on the host, as in the reference."""
    _, wt = jax_weights(5, 8)
    cfg, params, adj, _ = rmtpp_component(rt, wt, B=2, device=CPU)
    bad = {**params.rmtpp, "gru": {**params.rmtpp["gru"], "iz": {
        "kernel": params.rmtpp["gru"]["iz"]["kernel"].clone(),
        "bias": params.rmtpp["gru"]["iz"]["bias"]}}}
    bad["gru"]["iz"]["kernel"][1, 0, 3] = float("nan")
    with pytest.raises(ValueError,
                       match=r"\['gru'\]\['iz'\]\['kernel'\] holds a non-"):
        rt.simulate_batch(cfg, dataclasses.replace(params, rmtpp=bad), adj,
                          np.arange(2), device=CPU)
    cfg16 = dataclasses.replace(cfg, rmtpp_hidden=16)
    with pytest.raises(ValueError, match="hidden=8 .* rmtpp_hidden=16"):
        rt.simulate_batch(cfg16, params, adj, np.arange(2), device=CPU)


def test_select_engine_sends_rmtpp_to_the_scan_engine():
    _, wt = jax_weights(5, 8)
    cfg, params, adj, _ = rmtpp_component(rt, wt, B=2, opt=True, device=CPU)
    name, why = rt.select_engine(cfg, params, engine="auto", device="cuda")
    assert name == "scan" and "rmtpp" in why and "scan engine" in why
    log = rt.simulate_batch(cfg, params, adj, np.arange(2), engine="auto",
                            device=CPU)
    assert log.engine == "scan" and "rmtpp" in log.engine_reason
    with pytest.raises(ValueError, match="engine='fused' requested"):
        rt.simulate_batch(cfg, params, adj, np.arange(2), engine="fused",
                          device=CPU)


def test_resume_from_a_jax_state_carrying_h():
    """A JAX run to T = 10 carries across (``h`` included) and the port
    resumes it to T = 20 like the JAX package does."""
    wj, wt = jax_weights(6, 8)
    B = 4
    cj, pj, aj, _ = rmtpp_component(J, wj, T=10.0, B=B, capacity=64)
    ct, pt, at, _ = rmtpp_component(rt, wt, T=10.0, B=B, capacity=64,
                                    device=CPU)
    _, sj = J.simulate_batch(cj, pj, aj, np.arange(B), return_state=True)
    st = rt.sim_state_from_numpy(tp.state_fields(sj), device=CPU)
    assert st.h.shape == (B, cj.n_sources, 8) and st.h.abs().sum() > 0
    cj2 = dataclasses.replace(cj, end_time=20.0)
    ct2 = dataclasses.replace(ct, end_time=20.0)
    lj, sj2 = J.resume(cj2, pj, aj, sj)
    lt, st2 = rt.resume(ct2, pt, at, st)
    tp.assert_same_log(lj, lt)
    np.testing.assert_allclose(st2.h.numpy(), np.asarray(sj2.h), rtol=1e-5,
                               atol=1e-6)


def test_slab_dispatch_carries_the_weights():
    _, wt = jax_weights(5, 8)
    cfg, params, adj, _ = rmtpp_component(rt, wt, B=3, device=CPU)
    whole = rt.simulate_batch(cfg, params, adj, np.arange(3), device=CPU)
    slabbed = rt.simulate_batch(cfg, params, adj, np.arange(3), slab=2,
                                device=CPU)
    assert torch.equal(whole.srcs, slabbed.srcs[:, :whole.srcs.shape[1]])


# ---------------------------------------------------------------------------
# Streams, the star controller, config 5
# ---------------------------------------------------------------------------


def test_rmtpp_stream_matches_jax():
    wj, wt = jax_weights(8, 8)
    n, T, cap = 10, 15.0, 32
    js = jax.vmap(lambda k: jstreams.rmtpp_stream(wj, k, 0.0, T, cap, 8))(
        jr.split(jr.PRNGKey(4), n))
    ts = tstreams.rmtpp_stream(wt, tkeys(4, n), 0.0, T, cap, 8)
    same_times(ts.times, js.times, rtol=1e-5)
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(ts.truncated.numpy(),
                                  np.asarray(js.truncated))
    assert int(ts.n.sum()) > 2 * n
    small = tstreams.rmtpp_stream(wt, tkeys(4, n), 0.0, T, 2, 8)
    assert bool(small.truncated.any())


def star_rmtpp(pkg, w, **kw):
    sb = pkg.StarBuilder(n_feeds=8, end_time=20.0)
    for f in range(8):
        sb.wall_poisson(f, 1.0 + 0.1 * f)
    sb.ctrl_rmtpp(w, hidden=8)
    return sb.build(wall_cap=128, post_cap=256, **kw)


def test_star_run_with_an_rmtpp_controller_matches_jax():
    """The controlled stream and every feed's metrics against the JAX
    star engine, one seed and a batch of three (times rtol 1e-5)."""
    wj, wt = jax_weights(9, 8)
    rj = JB.simulate_star(*star_rmtpp(JB, wj), seed=3)
    rt_ = TB.simulate_star(*star_rmtpp(TB, wt, device=CPU), seed=3,
                           device=CPU)
    same_times(rt_.own_times, rj.own_times, rtol=1e-5)
    assert rt_.n_posts == int(rj.n_posts) > 0
    same_times(rt_.wall_times, rj.wall_times, rtol=1e-6)
    np.testing.assert_allclose(rt_.metrics.time_in_top_k.numpy(),
                               np.asarray(rj.metrics.time_in_top_k),
                               rtol=1e-5, atol=1e-4)
    cfg, wall, ctrl = star_rmtpp(TB, wt, device=CPU)
    wb, cb = TB.broadcast_star(wall, ctrl, 3)
    rb = TB.simulate_star_batch(cfg, wb, cb, np.array([3, 5, 6]),
                                device=CPU)
    assert torch.equal(rb.own_times[0], rt_.own_times)
    with pytest.raises(ValueError, match="rmtpp weights"):
        TB.simulate_star(cfg, wall, dataclasses.replace(ctrl, rmtpp=None),
                         seed=0, device=CPU)


def test_config5_matches_jax_with_the_same_weights():
    """Config 5 at 32 seeds, T = 30, with converted weights through
    ``run_preset`` on both sides (posts identical, time-in-top-1 within
    rtol 1e-5)."""
    wj, wt = jax_weights(0, 8)
    kw = dict(end_time=30.0, capacity=256)
    bj = jpresets.build_preset(5, weights=wj, **kw)
    bt = presets.build_preset(5, weights=wt, device=CPU, **kw)
    assert bt[0] == "batch" and bt[4] == bj[4] == 0
    oj = jpresets.run_preset(bj, np.arange(32))
    ot = presets.run_preset(bt, np.arange(32), device=CPU)
    assert ot["events"] == oj["events"]
    np.testing.assert_array_equal(ot["per_seed_posts"], oj["per_seed_posts"])
    np.testing.assert_allclose(ot["per_seed_top_k"], oj["per_seed_top_k"],
                               rtol=1e-5)


def test_config5_trains_its_own_weights():
    """Without ``weights`` the preset fits on its device: config 5's data
    (32 x 24 Exp(0.7) gaps from ``RandomState(seed)``)."""
    b = presets.build_preset("rmtpp", scale=0.3, end_time=10.0, hidden=4,
                             train_steps=5, capacity=64, device=CPU)
    _, cfg, params, adj, row = b
    assert cfg.rmtpp_hidden == 4 and cfg.n_sources == 4 and row == 0
    assert TR.hidden_of(params.rmtpp) == 4
    out = presets.run_preset(b, np.arange(3), device=CPU)
    assert out["events"] > 0


# ---------------------------------------------------------------------------
# The oracle twin
# ---------------------------------------------------------------------------


def test_gru_and_head_match_the_oracle():
    """The port's cell against the oracle's float64 twin."""
    _, wt = jax_weights(3, 8)
    ob = OracleRMTPP(0, seed=0, weights=np64(wt), hidden=8)
    h = np.random.RandomState(0).randn(8).astype(np.float32)
    for tau in (0.0, 0.3, 2.7, 40.0):
        got = ob._gru(h.astype(np.float64), tau)
        want = TR._step_h(wt, torch.from_numpy(h), torch.tensor(tau))
        np.testing.assert_allclose(got, want.numpy(), atol=2e-5)
        a_o, w_o = ob._head(got)
        a_t, w_t = TR._head(wt, torch.from_numpy(got.astype(np.float32)))
        np.testing.assert_allclose(a_o, float(a_t), atol=2e-5)
        np.testing.assert_allclose(w_o, float(w_t), atol=1e-6)
        h = got.astype(np.float32)


def test_oracle_sampler_matches_closed_form_hazard():
    _, wt = jax_weights(9, 4)
    ob = OracleRMTPP(0, seed=11, weights=np64(wt), hidden=4)
    ob.h = np.random.RandomState(1).randn(4)
    a, ww = ob._head(ob.h)
    draws = np.asarray([ob._sample_delta() for _ in range(4000)])
    finite = draws[np.isfinite(draws)]
    haz = tsampling.rmtpp_cum_hazard(torch.tensor(a), torch.tensor(ww),
                                     torch.from_numpy(finite)).numpy()
    total = haz.sum() + (np.exp(a) / -ww if ww < 0 else 0.0) * (
        len(draws) - len(finite))
    np.testing.assert_allclose(total / len(draws), 1.0, rtol=0.1)


def test_component_parity_engine_vs_oracle():
    """Mean posts and time-in-top-1 of the port's scan engine against the
    port's oracle with the same weights, within 4 sigma."""
    hidden, T, F, n = 8, 40.0, 4, 12
    _, wt = jax_weights(7, hidden)
    cfg, params, adj, src = rmtpp_component(rt, wt, F=F, T=T, B=n,
                                            capacity=1024, device=CPU)
    log = rt.simulate_batch(cfg, params, adj, np.arange(n), device=CPU)
    posts_e = rt.num_posts(log.srcs, src).double().numpy()
    top_e = rt.feed_metrics_batch(log.times, log.srcs, adj, src, T) \
        .mean_time_in_top_k().double().numpy()
    posts_o, top_o = [], []
    for seed in range(n):
        others = [("poisson", dict(src_id=100 + i, seed=9000 + 100 * seed + i,
                                   rate=1.0, sink_ids=[i]))
                  for i in range(F)]
        so = SimOpts(src_id=0, sink_ids=list(range(F)),
                     other_sources=others, end_time=T)
        mgr = so.create_manager_with_rmtpp(seed=seed, weights=np64(wt),
                                           hidden=hidden)
        mgr.run_till()
        df = mgr.state.get_dataframe()
        posts_o.append(mp.num_posts_of_src(df, 0))
        top_o.append(mp.time_in_top_k(df, 1, T, src_id=0,
                                      sink_ids=so.sink_ids))
    for got, want in ((posts_e, np.asarray(posts_o, np.float64)),
                      (top_e, np.asarray(top_o, np.float64))):
        se = np.sqrt(got.var() / n + want.var() / n)
        tol = max(4.0 * se, 0.05 * max(abs(want.mean()), 1.0))
        assert abs(got.mean() - want.mean()) <= tol, (got.mean(),
                                                      want.mean(), tol)


# ---------------------------------------------------------------------------
# The committed checkpoint
# ---------------------------------------------------------------------------


def test_committed_npz_holds_the_orbax_checkpoint_bit_for_bit():
    from redqueen_tpu.utils.checkpoint import restore

    ck = restore(os.path.join(REPO, "experiments", "checkpoints", "rmtpp"))
    with np.load(RMTPP_CHECKPOINT0) as z:
        files = set(z.files)
        for tree in ("weights", "info"):
            for path, leaf in jax.tree_util.tree_leaves_with_path(ck[tree]):
                name = "/".join([tree] + [str(k.key) for k in path])
                files.discard(name)
                want = np.asarray(leaf)
                got = z[name]
                assert got.dtype == want.dtype and got.shape == want.shape
                assert got.tobytes() == want.tobytes(), name
    assert not files
    w, info = load_rmtpp_npz(device=CPU)
    assert TR.hidden_of(w) == 16 and w["v"]["kernel"].dtype == torch.float32
    assert float(info["heldout_nll"]) == float(np.asarray(
        ck["info"]["heldout_nll"]))


def test_npz_writer_round_trips_a_weight_tree(tmp_path):
    from redqueen_tpu_torch.convert import save_rmtpp_npz

    wj, wt = jax_weights(2, 4)
    path = str(tmp_path / "w.npz")
    save_rmtpp_npz(path, rmtpp_weights_to_jax(wt), {"a": {"b": np.int64(3)}})
    w, info = load_rmtpp_npz(path, device=CPU)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(x, y),
                 rmtpp_weights_to_jax(w), jax.tree.map(np.asarray, wj))
    assert int(info["a"]["b"]) == 3


def test_npz_loads_with_jax_blocked():
    """The card's machine has no flax or orbax: loading the exported
    weights and running them must not import any of jax, flax, optax,
    orbax or the JAX package."""
    code = f"""
import builtins, sys
sys.path.insert(0, {REPO!r})
real = builtins.__import__
def guard(name, *a, **k):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                              "redqueen_tpu"):
        raise ImportError("blocked: " + name)
    return real(name, *a, **k)
builtins.__import__ = guard
import numpy as np, redqueen_tpu_torch as rt
from redqueen_tpu_torch.models import rmtpp
w, info = rt.load_rmtpp_npz(device="cpu")
gb = rt.GraphBuilder(n_sinks=2, end_time=5.0)
src = gb.add_rmtpp()
for i in range(2):
    gb.add_poisson(rate=1.0, sinks=[i])
cfg, p, a = gb.build(capacity=64, rmtpp_hidden=16, device="cpu")
log = rt.simulate(cfg, rmtpp.attach(p, w), a, seed=0, device="cpu")
print("ok", int(log.n_events), float(info["heldout_nll"]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok ")
