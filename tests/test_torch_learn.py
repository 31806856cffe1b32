"""The port's learning path (``redqueen_tpu_torch.learn``) against the JAX
package's ``redqueen_tpu.learn`` on the CPU: the same numpy inputs, made
from a seed, through both.  On the CPU the port's pass is the plain
PyTorch version of the ``hawkes_pass`` kernel (the kernel itself is held
to it on the card, ``tests/test_torch_cuda.py``).

Tolerances, each stated where it is used:

- ingest: byte-equal arrays (the same numpy arithmetic);
- simulate at seed 7: the same stream as the reference (dims identical,
  times within rtol 1e-6, the scan engines' stated parity);
- one pass against ``_stream_pass``: rtol 2e-6 on the chunk-summed
  statistics (torch's and XLA's CPU ``exp``/``log`` differ by an ulp,
  and the port sums a chunk's terms in another order), health equal;
- ``hawkes_loglik``: rtol 1e-6 against the reference, 2e-4 against the
  O(n^2) float64 sum (as ``tests/test_learn.py``);
- the kernel's carries (``hawkes_carry_plain``: R and Q at every
  segment start, composed from segment and chunk summaries): within
  2e-6 of the largest magnitude against a float64 event-by-event walk
  written here (float32 rounding of the products and sums, compounded
  over a few thousand events);
- the grad mode: against ``torch.autograd`` through the plain pass
  within 1e-5 relative (the same terms summed in another order), against
  ``jax.grad`` within rtol 1e-5;
- EM and FW over 20 iterations from the same stream: the curves within
  rtol 1e-5 and the parameters within rtol 1e-5 of the reference's
  (float32 ulps, compounded over the iterations);
- checkpoint resume: bit-identical on the CPU;
- control: exact where the arithmetic is the reference's NumPy."""

import json
import os
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu import learn as JL
from redqueen_tpu.learn import ckpt as jckpt
from redqueen_tpu.learn import hawkes_mle as jmle
from redqueen_tpu.learn import ingest as jingest
from redqueen_tpu.learn import loglik as jloglik
from redqueen_tpu_torch import learn as TL
from redqueen_tpu_torch.learn import ckpt as tckpt
from redqueen_tpu_torch.learn import hawkes_mle as tmle
from redqueen_tpu_torch.learn import ingest as tingest
from redqueen_tpu_torch.learn import loglik as tloglik
from redqueen_tpu_torch.runtime import preempt as tpreempt
from torch_parity import autotune_cache, partitionable  # noqa: F401,E501  (autouse fixtures)

CPU = torch.device("cpu")
# closed_loop's 3-dim world (experiments/closed_loop.py:56-61).
MU_T = np.array([0.3, 0.5, 0.4])
ALPHA_T = np.array([0.8, 0.5, 0.6])
BETA_T = np.array([2.0, 1.5, 2.5])


def random_stream(seed, n, D, T, pkg):
    rng = np.random.RandomState(seed)
    times = np.sort(rng.uniform(0, T, n))
    dims = rng.randint(0, D, n)
    return pkg.make_stream(times, dims, D, t_end=T)


def params(seed, D, degenerate=False):
    """``(mu, alpha, beta)`` float64 from a seed; ``degenerate`` gives dim
    0 ``mu = 0`` and no excitation, so its intensity is 0 at its own
    events and its health bit trips."""
    rng = np.random.RandomState(seed)
    mu = rng.uniform(0.1, 1.0, D)
    alpha = rng.uniform(0.0, 0.5, (D, D))
    beta = rng.uniform(0.5, 3.0, D)
    if degenerate:
        mu[0] = 0.0
        alpha[0, :] = 0.0
    return mu, alpha, beta


def f32(*xs):
    return [np.asarray(x, np.float32) for x in xs]


def same_chunks(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        else:
            assert x == y, f


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,K,D", [(0, 16, 1), (100, 16, 1), (300, 7, 3),
                                   (5000, 16, 4)])
def test_chunk_events_byte_equal(n, K, D):
    same_chunks(jingest.chunk_events(random_stream(n, n, D, 50.0, jingest),
                                     chunk_size=K),
                tingest.chunk_events(random_stream(n, n, D, 50.0, tingest),
                                     chunk_size=K))


def test_pad_chunks_bucketing_equal():
    for c in list(range(1, 600)) + [2095, 4000]:
        assert tingest._pad_chunks(c) == jingest._pad_chunks(c)


@pytest.mark.parametrize("bad", [
    ([1.0, 0.5], [0, 0], 1, 2.0), ([0.5], [1], 1, 2.0),
    ([0.5], [0], 1, 0.4), ([np.nan], [0], 1, 1.0), ([0.1], [0], 0, 1.0)])
def test_make_stream_validation_same_messages(bad):
    times, dims, D, T = bad
    with pytest.raises(jingest.StreamValidationError) as ej:
        jingest.make_stream(times, dims, D, t_end=T)
    with pytest.raises(tingest.StreamValidationError) as et:
        tingest.make_stream(times, dims, D, t_end=T)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [dict(n_dims=4, t_end=10.0),
                                dict(n_dims=4, assign="modulo"),
                                dict(t_end=10.0),
                                dict(n_dims=3, max_rows=40, t_start=-1.0)])
def test_from_traces_grouping_equal(kw):
    traces = [np.sort(np.random.RandomState(u).uniform(0, 10, 5))
              for u in range(20)] + [np.zeros(0)]
    sj = jingest.from_traces(traces, **kw)
    st = tingest.from_traces(traces, **kw)
    assert (st.n_dims, st.t_end, st.t_start) == (sj.n_dims, sj.t_end,
                                                 sj.t_start)
    np.testing.assert_array_equal(st.times, sj.times)
    np.testing.assert_array_equal(st.dims, sj.dims)
    assert st.dims.dtype == sj.dims.dtype


def test_mix64_matches_the_serving_partitioner():
    from redqueen_tpu.serving.cluster import _mix64
    from redqueen_tpu_torch.serving import cluster as tcluster

    x = np.arange(0, 10 ** 6, 997, dtype=np.uint64)
    np.testing.assert_array_equal(tingest._splitmix64(x), _mix64(x))
    np.testing.assert_array_equal(tcluster._mix64(x), _mix64(x))


@pytest.fixture(scope="module")
def world_logs():
    """The closed-loop world on both packages' scan engines at seed 7
    (T cut from 600 to 120 to keep the CPU run short)."""
    jax.config.update("jax_threefry_partitionable", True)
    gbj = J.GraphBuilder(n_sinks=3, end_time=120.0)
    rows = gbj.add_hawkes(MU_T, ALPHA_T, BETA_T)
    gbt = rt.GraphBuilder(n_sinks=3, end_time=120.0)
    assert gbt.add_hawkes(MU_T, ALPHA_T, BETA_T) == rows
    cj, pj, aj = gbj.build(capacity=512)
    ct, pt, at = gbt.build(capacity=512, device="cpu")
    return (J.simulate(cj, pj, aj, seed=7),
            rt.simulate(ct, pt, at, seed=7, device="cpu"), rows)


def test_from_event_log_at_seed_7(world_logs):
    lj, lt, rows = world_logs
    sj = jingest.from_event_log(lj, sources=rows)
    st = tingest.from_event_log(lt, sources=rows)
    assert st.n_events == sj.n_events > 100
    assert (st.n_dims, st.t_end, st.t_start) == (3, 120.0, 0.0)
    np.testing.assert_array_equal(st.dims, sj.dims)
    np.testing.assert_allclose(st.times, sj.times, rtol=1e-6)
    # default source selection: every source that emitted, in row order
    assert tingest.from_event_log(lt).n_dims == jingest.from_event_log(
        lj).n_dims


def test_from_event_log_batched_needs_lane():
    gb = rt.GraphBuilder(n_sinks=2, end_time=30.0)
    gb.add_hawkes(0.5, 0.3, 1.0, sinks=[0])
    gb.add_poisson(0.5, sinks=[1])
    cfg, p, a = gb.build(capacity=128, device="cpu")
    P, A = rt.stack_components([p] * 2, [a] * 2)
    log = rt.simulate_batch(cfg, P, A, np.arange(2), device="cpu")
    with pytest.raises(ValueError, match="lane"):
        tingest.from_event_log(log)
    s = tingest.from_event_log(log, sources=[0], lane=1)
    assert s.n_dims == 1
    n1 = int(log.n_events[1])
    srcs = log.srcs[1, :n1].numpy()
    np.testing.assert_array_equal(
        s.times, log.times[1, :n1].numpy()[srcs == 0].astype(np.float64))
    with pytest.raises(tingest.StreamValidationError, match="no sources"):
        tingest.from_event_log(log, sources=[], lane=0)


def test_from_journal_waits_for_serving(tmp_path):
    """The serving layer is ported, so ``from_journal`` reads a serving
    journal: the port's runtime journals a stream, and both packages'
    adapters read it to the same stream; a directory with no journal
    gives the reference's empty stream."""
    from redqueen_tpu.learn import ingest as jingest
    from redqueen_tpu_torch import serving

    rt_ = serving.ServingRuntime(4, dir=str(tmp_path), device="cpu")
    with rt_:
        for b in serving.synthetic_stream(2, 6, 4, events_per_batch=5):
            rt_.submit(b)
            rt_.poll()
    for d in (str(tmp_path), str(tmp_path / "none")):
        got, want = tingest.from_journal(d), jingest.from_journal(d)
        np.testing.assert_array_equal(got.times, want.times)
        np.testing.assert_array_equal(got.dims, want.dims)
        assert (got.n_dims, got.t_start, got.t_end) == \
            (want.n_dims, want.t_start, want.t_end)
    assert tingest.from_journal(str(tmp_path)).n_events > 0


# ---------------------------------------------------------------------------
# the pass and the likelihood
# ---------------------------------------------------------------------------

PASS_CASES = {  # (n events, D, chunk size K): padding, several chunks
    "D3": (150, 3, 64), "D8": (500, 8, 128), "D64": (700, 64, 128)}


def reference_pass(ch, mu, alpha, beta):
    D = ch.n_dims
    mu, alpha, beta = (jnp.asarray(x) for x in f32(mu, alpha, beta))
    out = jloglik._stream_pass(jnp.asarray(ch.dt), jnp.asarray(ch.dims),
                               jnp.asarray(ch.mask), mu, alpha, beta,
                               n_dims=D)
    G = jloglik._censored_mass(
        jnp.asarray(ch.tail), jnp.asarray(ch.dims), jnp.asarray(ch.mask),
        jnp.asarray(ch.counts, jnp.float32), beta, n_dims=D)
    return [np.asarray(x) for x in out] + [np.asarray(G)]


def port_pass(ch, mu, alpha, beta):
    ev = tloglik.to_device(ch, CPU)
    mu, alpha, beta = (torch.from_numpy(x) for x in f32(mu, alpha, beta))
    st = tloglik._stream_pass(ev, mu, alpha, beta)
    counts = tloglik._f32(ch.counts, CPU)
    G = tloglik._censored_mass(st.E, counts, beta)
    # E depends on the times and beta only
    assert torch.equal(tloglik._compensator_G(ev, counts, beta), G)
    return [t.numpy() for t in (st.ll, st.s0, st.S, st.W, st.health, G)]


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_plain_pass_matches_stream_pass(case):
    n, D, K = PASS_CASES[case]
    ch = tingest.chunk_events(random_stream(D, n, D, 20.0, tingest), K)
    assert ch.dt.shape[0] > 1 and not ch.mask.all()
    mu, alpha, beta = params(D, D, degenerate=True)
    want = reference_pass(ch, mu, alpha, beta)
    got = port_pass(ch, mu, alpha, beta)
    for name, w, g in zip(("ll", "s0", "S", "W", "health", "G"), want, got):
        if name == "health":
            np.testing.assert_array_equal(g.astype(np.uint32), w)
            assert g[0] != 0 and not g[1:].any()
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6,
                                       err_msg=name)


def _np_loglik(times, dims, D, T, mu, alpha, beta):
    """O(n^2) reference log-likelihood (f64, direct double sum)."""
    ll = 0.0
    for k in range(len(times)):
        i = dims[k]
        lam = mu[i] + sum(alpha[i, dims[j]] * np.exp(
            -beta[dims[j]] * (times[k] - times[j])) for j in range(k))
        ll += np.log(lam)
    comp = mu.sum() * T
    for j in range(len(times)):
        u = dims[j]
        comp += alpha[:, u].sum() * (1 - np.exp(-beta[u] * (T - times[j]))
                                     ) / beta[u]
    return ll - comp


def test_hawkes_loglik_matches_reference_and_quadratic_sum():
    rng = np.random.RandomState(3)
    n, D, T = 150, 3, 20.0
    times = np.sort(rng.uniform(0, T, n))
    dims = rng.randint(0, D, n)
    mu = np.array([0.4, 0.8, 0.2])
    alpha = rng.uniform(0.0, 0.5, (D, D))
    beta = np.array([2.0, 1.0, 3.0])
    res = TL.hawkes_loglik(tingest.make_stream(times, dims, D, t_end=T),
                           mu, alpha, beta, device="cpu")
    ref = JL.hawkes_loglik(jingest.make_stream(times, dims, D, t_end=T),
                           mu, alpha, beta)
    assert res.health.tolist() == [0, 0, 0]
    assert res.health.dtype == np.uint32
    np.testing.assert_allclose(res.loglik,
                               _np_loglik(times, dims, D, T, mu, alpha,
                                          beta), rtol=2e-4)
    for f in ("loglik", "loglik_events", "compensator"):
        np.testing.assert_allclose(getattr(res, f), getattr(ref, f),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(res.loglik,
                               res.loglik_events - res.compensator,
                               rtol=1e-6)


def test_degenerate_dim_flags_health():
    s = tingest.make_stream([0.5, 1.0], [0, 1], 2, t_end=2.0)
    res = TL.hawkes_loglik(s, [0.0, 1.0], np.zeros((2, 2)), [1.0, 1.0],
                           device="cpu")
    ref = JL.hawkes_loglik(jingest.make_stream([0.5, 1.0], [0, 1], 2,
                                               t_end=2.0),
                           [0.0, 1.0], np.zeros((2, 2)), [1.0, 1.0])
    assert res.health[0] != 0 and res.health[1] == 0
    np.testing.assert_array_equal(res.health, ref.health)
    assert np.isfinite(res.loglik)
    np.testing.assert_allclose(res.loglik, ref.loglik, rtol=1e-6)


def test_hawkes_loglik_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    s = tingest.make_stream([0.5], [0], 1, t_end=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.hawkes_loglik(s, [1.0], [[0.1]], [1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.fit_hawkes(s, max_iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.holdout_nll(s, [1.0], [[0.1]], [1.0])


CARRY_CASES = {  # (n events, D, chunk size K, segments W)
    # K = 100 at W = 8: segments of 13, the last one of 9; 16 chunks of
    # which 1 is all padding
    "D3": (1500, 3, 100, 8),
    # W = 12: segments of 9, the last one of 1
    "D33": (1100, 33, 100, 12),
    "D64": (2500, 64, 256, 12),
    # segments of 6 in chunks of 64: the last one empty, and every
    # segment of the padded chunks all padding
    "empty": (300, 5, 64, 12)}


def walked_carries(ch, beta, W):
    """R and Q at every segment start, float64, walked event by event in
    global order (the recursion of the module docstring)."""
    C, K = ch.dt.shape
    L = -(-K // W)
    b = np.asarray(beta, np.float64)
    R = np.zeros(ch.n_dims)
    Q = np.zeros(ch.n_dims)
    r_in = np.zeros((C, W, ch.n_dims))
    q_in = np.zeros((C, W, ch.n_dims))
    for c in range(C):
        for s in range(W):
            if s * L >= K:          # an empty segment starts at the end
                continue
            for k in range(s * L, min(s * L + L, K)):
                if k == s * L:
                    r_in[c, s], q_in[c, s] = R, Q
                x = float(ch.dt[c, k])
                d = np.exp(-b * x)
                Q = d * (Q + x * R)
                R = d * R
                if ch.mask[c, k]:
                    R[ch.dims[c, k]] += 1.0
        for s in range(W):
            if s * L >= K:
                r_in[c, s], q_in[c, s] = R, Q
    return r_in, q_in


@pytest.mark.parametrize("grad", [False, True], ids=["stats", "grad"])
@pytest.mark.parametrize("case", sorted(CARRY_CASES))
def test_carry_plain_matches_a_float64_walk(case, grad):
    n, D, K, W = CARRY_CASES[case]
    ch = tingest.chunk_events(random_stream(D + 7, n, D, 20.0, tingest), K)
    C = ch.dt.shape[0]
    L = -(-K // W)
    assert C > 1 and not ch.mask[-1].any()     # a chunk of padding only
    assert K % L != 0 or W * L > K             # an uneven or empty segment
    _, _, beta = params(D + 7, D)
    ev = tloglik.to_device(ch, CPU)
    r_in, q_in = tloglik.hawkes_carry_plain(
        ev.dt, ev.dims, ev.mask, torch.tensor(beta, dtype=torch.float32),
        W, grad=grad)
    assert r_in.shape == q_in.shape == (C, W, D)
    r_ref, q_ref = walked_carries(ch, beta, W)
    assert np.abs(r_ref).max() > 1.0 and np.abs(q_ref).max() > 0.1
    np.testing.assert_allclose(r_in.double().numpy(), r_ref, rtol=0,
                               atol=2e-6 * np.abs(r_ref).max())
    if grad:
        assert not q_in.any()
    else:
        np.testing.assert_allclose(q_in.double().numpy(), q_ref, rtol=0,
                                   atol=2e-6 * np.abs(q_ref).max())
    # the CPU route of the dispatcher is the plain version
    r2, q2 = tloglik.hawkes_carry(ev.dt, ev.dims, ev.mask,
                                  torch.tensor(beta, dtype=torch.float32),
                                  W, grad=grad)
    assert torch.equal(r2, r_in) and torch.equal(q2, q_in)


def test_hawkes_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (the CPU route is the
    dispatchers' ``hawkes_pass``/``hawkes_carry``); they refuse before
    building anything."""
    from redqueen_tpu_torch.ops import kernels

    ch = tingest.chunk_events(random_stream(3, 50, 2, 5.0, tingest), 16)
    ev = tloglik.to_device(ch, CPU)
    mu, alpha, beta = (torch.tensor(x) for x in f32(*params(3, 2)))
    with pytest.raises(ValueError, match="launch_hawkes_pass takes CUDA"):
        kernels.launch_hawkes_pass(ev.dt, ev.dims, ev.mask, ev.tail, mu,
                                   alpha, beta)
    with pytest.raises(ValueError, match="launch_hawkes_carry takes CUDA"):
        kernels.launch_hawkes_carry(ev.dt, ev.dims, ev.mask, beta, 4)


@pytest.mark.parametrize("case", ["D3", "D8"])
def test_grad_mode_matches_autograd_and_jax(case):
    """Grad mode's gradient against ``torch.autograd`` through the plain
    pass and against ``jax.grad`` of ``_ll_events_fn``, with one event of
    lambda <= 0 (dim 0 has mu = 0 and no excitation; its first event
    also sees no history)."""
    n, D, K = PASS_CASES[case]
    ch = tingest.chunk_events(random_stream(D + 1, n, D, 20.0, tingest), K)
    mu, alpha, beta = params(D + 1, D, degenerate=True)
    mu32, a32, b32 = f32(mu, alpha, beta)
    ev = tloglik.to_device(ch, CPU)
    mu_t = torch.tensor(mu32, requires_grad=True)
    a_t = torch.tensor(a32, requires_grad=True)
    ll, g_mu, g_a, w, _e, _h = tloglik.hawkes_pass_plain(
        ev.dt, ev.dims, ev.mask, ev.tail, mu_t, a_t, torch.tensor(b32),
        grad=True)
    assert not w.any()
    ag_mu, ag_a = torch.autograd.grad(ll.sum(), (mu_t, a_t))
    g_mu, g_a = g_mu.sum(0).detach(), g_a.sum(0).detach()
    assert float(g_mu[0]) == 0.0       # lambda <= tiny: no gradient
    np.testing.assert_allclose(g_mu.numpy(), ag_mu.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_a.numpy(), ag_a.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ag_a.abs().max()))

    def f(m, a):
        return jloglik._ll_events_fn(jnp.asarray(ch.dt),
                                     jnp.asarray(ch.dims),
                                     jnp.asarray(ch.mask), m, a,
                                     jnp.asarray(b32))
    v, (jg_mu, jg_a) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(mu32), jnp.asarray(a32))
    np.testing.assert_allclose(float(ll.sum().detach()), float(v),
                               rtol=1e-5)
    np.testing.assert_allclose(g_mu.numpy(), np.asarray(jg_mu), rtol=1e-5)
    np.testing.assert_allclose(g_a.numpy(), np.asarray(jg_a), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg_a).max()))
    # the autograd Function the FW solver differentiates
    mu2 = torch.tensor(mu32, requires_grad=True)
    a2 = torch.tensor(a32, requires_grad=True)
    val = tloglik._ll_events_fn(ev, mu2, a2, torch.tensor(b32))
    gm2, ga2 = torch.autograd.grad(-2.0 * val, (mu2, a2))
    np.testing.assert_array_equal(gm2.numpy(), -2.0 * g_mu.numpy())
    np.testing.assert_array_equal(ga2.numpy(), -2.0 * g_a.numpy())


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

def _fit_stream(pkg, n=400, D=2, seed=5):
    rng = np.random.RandomState(seed)
    times = np.sort(rng.uniform(0, 100, n))
    return pkg.make_stream(times, rng.randint(0, D, n), D, t_end=100.0)


@pytest.mark.parametrize("solver", ["em", "fw"])
def test_trajectories_match_reference(solver):
    kw = dict(solver=solver, max_iters=20, tol=0.0, fw_beta_warmup=4,
              chunk_size=256, sync_every=3)
    ref = JL.fit_hawkes(_fit_stream(jingest, D=3), **kw)
    got = TL.fit_hawkes(_fit_stream(tingest, D=3), device="cpu", **kw)
    assert got.n_iter == ref.n_iter == 20
    assert got.converged == ref.converged
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=1e-5)
    for f in ("mu", "alpha", "beta"):
        a, b = getattr(got, f), getattr(ref, f)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=f)
    np.testing.assert_array_equal(got.health, ref.health)
    np.testing.assert_allclose(got.final_loglik, ref.final_loglik,
                               rtol=1e-6)
    np.testing.assert_allclose(got.branching(), ref.branching(), rtol=1e-5,
                               atol=1e-6)


def test_fw_converges_with_its_gap_certificate(world_logs):
    """FW's duality gap certifies convergence on the closed-loop world
    (f32 gradients floor the gap near 3e-3 relative, so 5e-3), at the
    same sync window as the reference."""
    lj, lt, rows = world_logs
    kw = dict(solver="fw", max_iters=400, tol=5e-3)
    fit = TL.fit_hawkes(tingest.from_event_log(lt, sources=rows),
                        device="cpu", **kw)
    ref = JL.fit_hawkes(jingest.from_event_log(lj, sources=rows), **kw)
    assert fit.converged and ref.converged
    assert fit.n_iter == ref.n_iter < 400


@pytest.mark.parametrize("bad,exc,match", [
    (dict(solver="sgd"), ValueError, "solver"),
    (dict(solver="fw", rho=1.5), ValueError, "rho"),
    (dict(max_iters=0), ValueError, "max_iters"),
    (dict(beta0=-1.0), ValueError, "beta0")])
def test_rejects_bad_args_like_reference(bad, exc, match):
    with pytest.raises(exc, match=match) as et:
        TL.fit_hawkes(_fit_stream(tingest), device="cpu", **bad)
    with pytest.raises(exc) as ej:
        JL.fit_hawkes(_fit_stream(jingest), **bad)
    assert str(et.value) == str(ej.value)


def test_rejects_a_non_stream():
    with pytest.raises(TypeError):
        TL.fit_hawkes([1, 2, 3], device="cpu")


class TestQuarantine:
    def _poisoning(self, monkeypatch, dims_to_poison):
        orig = tmle._em_iter

        def poisoned(*a, **k):
            mu, alpha, beta, ll, health = orig(*a, **k)
            mu = mu.clone()
            for d in dims_to_poison:
                mu[d] = float("nan")
            return mu, alpha, beta, ll, health

        monkeypatch.setattr(tmle, "_em_iter", poisoned)

    def test_one_sick_dim_is_sanitized_not_fatal(self, monkeypatch):
        times = np.sort(np.random.RandomState(0).uniform(0, 50, 200))
        s = tingest.make_stream(times, np.arange(200) % 3, 3, t_end=50.0)
        self._poisoning(monkeypatch, [0])
        fit = TL.fit_hawkes(s, solver="em", max_iters=8, device="cpu")
        assert fit.health[0] != 0
        assert fit.health[1] == 0 and fit.health[2] == 0
        assert np.isfinite(fit.mu).all() and (fit.mu >= 0).all()
        assert np.isfinite(fit.alpha).all() and (fit.alpha >= 0).all()
        assert fit.alpha[0].sum() == 0 and fit.alpha[:, 0].sum() == 0
        assert fit.mu[0] == pytest.approx(
            np.bincount(np.arange(200) % 3)[0] / 50.0)  # Poisson fallback

    def test_all_dims_dead_raises_fit_error(self, monkeypatch):
        times = np.sort(np.random.RandomState(0).uniform(0, 50, 90))
        s = tingest.make_stream(times, np.arange(90) % 3, 3, t_end=50.0)
        self._poisoning(monkeypatch, [0, 1, 2])
        with pytest.raises(TL.FitError) as ei:
            TL.fit_hawkes(s, solver="em", max_iters=8, device="cpu")
        assert len(ei.value.reasons) == 3
        assert str(ei.value).startswith("fit_hawkes[em]: all 3 dimension")

    @pytest.mark.parametrize("solver", ["em", "fw"])
    def test_never_nan_on_pathological_stream(self, solver):
        times = np.concatenate([np.full(50, 1e-6), [1e6]])
        dims = np.concatenate([np.zeros(50, int), [1]])
        kw = dict(solver=solver, max_iters=10, fw_beta_warmup=3)
        fit = TL.fit_hawkes(tingest.make_stream(times, dims, 3, t_end=2e6),
                            device="cpu", **kw)
        ref = JL.fit_hawkes(jingest.make_stream(times, dims, 3, t_end=2e6),
                            **kw)
        assert np.isfinite(fit.mu).all() and (fit.mu >= 0).all()
        assert np.isfinite(fit.alpha).all() and (fit.alpha >= 0).all()
        assert np.isfinite(fit.beta).all() and (fit.beta > 0).all()
        np.testing.assert_array_equal(fit.health, ref.health)


# ---------------------------------------------------------------------------
# checkpoint / resume (rq.learn.fit/1)
# ---------------------------------------------------------------------------

class TestFitCheckpoint:
    @pytest.mark.parametrize("solver", ["em", "fw"])
    def test_resume_is_bit_identical(self, tmp_path, solver):
        s = _fit_stream(tingest)
        p = str(tmp_path / f"fit_{solver}.npz")
        kw = dict(solver=solver, tol=0.0, sync_every=4, ckpt_every=8,
                  fw_beta_warmup=4, device="cpu")
        fit_a = TL.fit_hawkes(s, max_iters=16, ckpt_path=p, **kw)
        assert os.path.exists(p)
        fit_b = TL.fit_hawkes(s, max_iters=40, ckpt_path=p, **kw)
        assert fit_b.n_iter == 40
        fit_c = TL.fit_hawkes(s, max_iters=40, **kw)
        for f in ("mu", "alpha", "beta", "loglik"):
            np.testing.assert_array_equal(getattr(fit_b, f),
                                          getattr(fit_c, f))
        np.testing.assert_array_equal(fit_a.loglik,
                                      fit_c.loglik[: len(fit_a.loglik)])

    def test_fingerprint_is_the_reference_fingerprint(self, tmp_path):
        """Both packages key a fit by the same digest of the same inputs,
        and each reads the other's checkpoint envelope."""
        pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        JL.fit_hawkes(_fit_stream(jingest), max_iters=8, tol=0.0,
                      ckpt_path=pj, ckpt_every=8)
        TL.fit_hawkes(_fit_stream(tingest), max_iters=8, tol=0.0,
                      ckpt_path=pt, ckpt_every=8, device="cpu")
        from redqueen_tpu.runtime import integrity as jint

        fp_j = json.loads(str(jint.load_npz(pj)["fit_meta"]))["fingerprint"]
        fp_t = json.loads(str(jint.load_npz(pt)["fit_meta"]))["fingerprint"]
        assert fp_t == fp_j
        for load in (jckpt.load_fit, tckpt.load_fit):
            for path in (pj, pt):
                step, arrays, meta = load(path, fp_j)
                assert step == 8 and meta["solver"] == "em"
                assert arrays["curve"].shape == (8,)

    def test_changed_inputs_restart_not_mix(self, tmp_path):
        s = _fit_stream(tingest)
        p = str(tmp_path / "fit.npz")
        TL.fit_hawkes(s, solver="em", max_iters=16, tol=0.0, ckpt_path=p,
                      ckpt_every=8, device="cpu")
        fit = TL.fit_hawkes(s, solver="em", max_iters=8, tol=0.0,
                            ckpt_path=p, ckpt_every=8, chunk_size=2048,
                            device="cpu")
        assert fit.n_iter == 8
        assert len(fit.loglik) == 8

    def test_corrupt_checkpoint_quarantined_and_refit(self, tmp_path):
        s = _fit_stream(tingest)
        p = str(tmp_path / "fit.npz")
        TL.fit_hawkes(s, solver="em", max_iters=16, tol=0.0, ckpt_path=p,
                      ckpt_every=8, device="cpu")
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[: len(raw) // 2])  # torn write
        fit = TL.fit_hawkes(s, solver="em", max_iters=8, tol=0.0,
                            ckpt_path=p, ckpt_every=8, device="cpu")
        assert fit.n_iter == 8
        assert any(".corrupt-" in f for f in os.listdir(tmp_path))

    def test_preempt_clean(self, tmp_path):
        s = _fit_stream(tingest)
        p = str(tmp_path / "fit.npz")
        kw = dict(solver="em", max_iters=32, tol=0.0, ckpt_path=p,
                  ckpt_every=8, sync_every=4, device="cpu")
        tpreempt.reset()
        try:
            with rt.runtime.preemption_guard(log=None):
                os.kill(os.getpid(), signal.SIGTERM)
                with pytest.raises(tpreempt.PreemptedError):
                    TL.fit_hawkes(s, **kw)
        finally:
            tpreempt.reset()
        assert os.path.exists(p)
        assert tckpt.load_fit(p, "not-the-fingerprint") is None
        fit = TL.fit_hawkes(s, **kw)
        assert fit.n_iter == 32

    def test_heartbeat_at_each_save(self, tmp_path, monkeypatch):
        hb = tmp_path / "hb"
        monkeypatch.setenv("RQ_HEARTBEAT_FILE", str(hb))
        TL.fit_hawkes(_fit_stream(tingest), max_iters=8, tol=0.0,
                      ckpt_path=str(tmp_path / "f.npz"), ckpt_every=8,
                      device="cpu")
        assert float(hb.read_text()) > 0


# ---------------------------------------------------------------------------
# control and the held-out score
# ---------------------------------------------------------------------------

def _mk_fit(pkg, mu, alpha, beta, health=None):
    D = len(mu)
    return pkg.HawkesFit(
        mu=np.asarray(mu, np.float64), alpha=np.asarray(alpha, np.float64),
        beta=np.asarray(beta, np.float64),
        health=np.zeros(D, np.uint32) if health is None
        else np.asarray(health, np.uint32),
        loglik=np.zeros(1), final_loglik=0.0, converged=True, n_iter=1,
        solver="em", n_events=10, n_dims=D, t_end=10.0, t_start=0.0)


CONTROL_FITS = {
    "diagonal": ([0.3, 0.4, 0.5], np.diag([0.2, 0.3, 0.4]), [1.0, 2.0, 3.0]),
    "crossed": ([0.1, 0.1], [[0.1, 0.4], [0.4, 0.1]], [1.0, 1.0]),
    "supercritical": ([0.3, 0.3], [[2.5, 0.0], [0.0, 0.1]], [1.0, 1.0]),
    "dead": ([0.0, 0.0], np.zeros((2, 2)), [1.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(CONTROL_FITS))
def test_control_functions_equal_reference(name):
    mu, alpha, beta = CONTROL_FITS[name]
    fj = _mk_fit(jmle, mu, alpha, beta)
    ft = _mk_fit(tmle, mu, alpha, beta)
    c = TL.control
    assert c.cross_excitation_mass(ft) == JL.control.cross_excitation_mass(
        fj)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = c.builder_params(ft)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = JL.control.builder_params(fj)
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for normalize in (True, False):
        np.testing.assert_array_equal(
            c.fit_s_sink(ft, normalize=normalize),
            JL.control.fit_s_sink(fj, normalize=normalize))
        np.testing.assert_array_equal(
            c.fit_s_sink((ft.mu, ft.alpha, ft.beta), normalize=normalize),
            JL.control.fit_s_sink((fj.mu, fj.alpha, fj.beta),
                                  normalize=normalize))
    np.testing.assert_array_equal(
        c.stationary_rates(ft.mu, ft.alpha, ft.beta),
        JL.control.stationary_rates(fj.mu, fj.alpha, fj.beta))
    np.testing.assert_array_equal(
        c.stationary_rates(ft.mu, np.diag(ft.alpha), ft.beta),
        JL.control.stationary_rates(fj.mu, np.diag(fj.alpha), fj.beta))


def test_control_component_and_walls_equal_reference():
    fj = _mk_fit(jmle, [0.3, 0.4], np.diag([0.2, 0.2]), [1.0, 1.5])
    ft = _mk_fit(tmle, [0.3, 0.4], np.diag([0.2, 0.2]), [1.0, 1.5])
    (cj, pj, aj), oj = JL.control.control_component(fj, end_time=20.0,
                                                    q=0.7)
    for src in (ft, (ft.mu, np.diag(ft.alpha), ft.beta)):
        (ct, pt, at), ot = TL.control_component(src, end_time=20.0, q=0.7,
                                                device="cpu")
        assert ot == oj == 0
        assert ct == rt.sim_config_from_fields(
            {f: getattr(cj, f) for f in cj.__dataclass_fields__})
        for f in ("kind", "rate", "l0", "alpha", "beta", "q"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(pj, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    gbj = J.GraphBuilder(n_sinks=2, end_time=10.0)
    gbt = rt.GraphBuilder(n_sinks=2, end_time=10.0)
    assert (TL.add_fit_walls(gbt, ft, sinks_per_dim=[[1], [0]])
            == JL.add_fit_walls(gbj, fj, sinks_per_dim=[[1], [0]]))
    _, pt, at = gbt.build(capacity=64, device="cpu")
    _, pj, aj = gbj.build(capacity=64)
    np.testing.assert_array_equal(pt.l0.numpy(), np.asarray(pj.l0))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    crossed = _mk_fit(tmle, [0.1, 0.1], [[0.1, 0.4], [0.4, 0.1]],
                      [1.0, 1.0])
    with pytest.warns(UserWarning, match="off-diagonal"):
        TL.builder_params(crossed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TL.builder_params(crossed, warn=False)


@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_cross_exciting_equal_reference(seed):
    mu = [0.3, 0.2, 0.4]
    alpha = [[0.5, 0.3, 0.0], [0.2, 0.4, 0.1], [0.0, 0.3, 0.6]]
    beta = [2.0, 1.5, 2.5]
    tt, dt_ = TL.simulate_cross_exciting(mu, alpha, beta, 50.0, seed=seed)
    tj, dj = JL.simulate_cross_exciting(mu, alpha, beta, 50.0, seed=seed)
    assert len(tt) > 20
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(dt_, dj)
    with pytest.raises(ValueError, match="supercritical"):
        TL.simulate_cross_exciting([0.1], [2.0], [1.0], 10.0)
    with pytest.raises(ValueError, match="shape"):
        TL.simulate_cross_exciting([0.1, 0.1], [0.2], [1.0], 10.0)


def test_control_cost_equal_reference():
    from redqueen_tpu.sweep import SweepResult as JS

    kw = dict(time_in_top_k=np.ones((1, 2)), average_rank=np.ones((1, 2)),
              n_posts=np.full((1, 2), 3.0), int_rank2=np.array([[5.0, 7.0]]),
              health=np.zeros((1, 2), np.uint32))
    np.testing.assert_array_equal(
        TL.control_cost(rt.SweepResult(**kw), q=2.0),
        JL.control_cost(JS(**kw), q=2.0))


def test_holdout_nll_matches_reference():
    mu, alpha, beta = params(11, 3)
    sj = random_stream(11, 300, 3, 30.0, jingest)
    st = random_stream(11, 300, 3, 30.0, tingest)
    np.testing.assert_allclose(
        TL.holdout_nll(st, mu, alpha, beta, device="cpu"),
        JL.holdout_nll(sj, mu, alpha, beta), rtol=1e-6)


def test_fit_walls_close_the_loop(world_logs):
    """simulate → fit → control on the CPU at a small size: the fitted
    world builds through the same path as the true one."""
    _lj, lt, rows = world_logs
    s = tingest.from_event_log(lt, sources=rows)
    fit = TL.fit_hawkes(s, solver="em", max_iters=15, tol=1e-7,
                        device="cpu")
    assert fit.health.tolist() == [0, 0, 0]
    ll_true = TL.hawkes_loglik(s, MU_T, np.diag(ALPHA_T), BETA_T,
                               device="cpu").loglik
    assert fit.final_loglik >= ll_true - 1.0
    (cfg, p, a), row = TL.control_component(fit, end_time=20.0,
                                            warn=False, device="cpu")
    assert row == 0 and p.l0.shape[0] == 4
