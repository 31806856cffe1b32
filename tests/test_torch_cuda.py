"""The port on the card: its CUDA kernels held against their plain
PyTorch versions on the same inputs, and the scan engine's resume.
Every test here needs an NVIDIA card and skips with a reason where torch
sees none.  The file imports only the port (not the JAX package), so it
runs where the port runs:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerance for the event kernel: none.  The kernel is built without fast
math and without fused multiply-adds and does each operation in the
plain version's order, so ``srcs``, ``n_events``, health words, the
whole carry and ``times`` are held bit-identical on every lane of every
mix.  The same holds for the Hawkes thinning kernel
(``csrc/hawkes_thin.cu``): its streams are the plain loop's, bit for
bit.  The Hawkes pass (``csrc/hawkes_pass.cu``) has its tolerance where
its tests are, below."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import redqueen_tpu_torch as rt
from redqueen_tpu_torch.ops import event_engine, event_step, kernels
from redqueen_tpu_torch.ops import threefry as ttf
from redqueen_tpu_torch.runtime import faultinject, numerics

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def autotune_cache(tmp_path, monkeypatch):
    """The lane layer's autotune cache in the test's own directory."""
    monkeypatch.setenv("RQ_LANES_AUTOTUNE", str(tmp_path / "autotune.json"))

VECTORS = [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels are CUDA")
    return torch.device("cuda", 0)


def _mix(gb):
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_piecewise([0.0, 7.0], [1.0, 0.3], sinks=[2])
    gb.add_realdata([1.0, 2.5, 6.0, 14.0], sinks=[3])
    gb.add_poisson(rate=0.7, sinks=[4])


def _replay(gb):
    gb.add_realdata([0.5, 1.25, 2.0, 3.75, 9.5, 11.0], sinks=[0])
    gb.add_realdata([0.1, 4.2, 8.8], sinks=[1])


def _headline(gb):
    gb.add_opt(q=1.0)
    for i in range(gb.n_sinks):
        gb.add_poisson(rate=1.0, sinks=[i])


def _two_opt(gb):
    # Opt rows 0 and 3 share feed 1; source 5 shares no feed with row 0.
    gb.add_opt(q=1.0, sinks=[0, 1, 2])
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_opt(q=0.5, sinks=[1, 3])
    gb.add_poisson(rate=0.8, sinks=[2, 3])
    gb.add_poisson(rate=0.6, sinks=[3])


def _s32(gb):
    # S = 32 = MAX_S: a Hawkes source first (the numeric faults poison
    # source 0), Opt rows at 3, 10, 17 and 31 with two feeds each, and
    # Poisson walls on one feed each.
    opt = {3: [3, 4], 10: [2, 5], 17: [4, 6], 31: [0, 7]}
    for s in range(kernels.MAX_S):
        if s == 0:
            gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[0])
        elif s in opt:
            gb.add_opt(q=0.5 + 0.1 * s, sinks=opt[s])
        else:
            gb.add_poisson(rate=0.3 + 0.02 * s, sinks=[s % gb.n_sinks])


# (fill, n_sinks, end_time, capacity)
MIXES = {
    "full_mix": (_mix, 5, 15.0, 64),
    "replay": (_replay, 2, 10.0, 16),
    "headline": (_headline, 10, 20.0, 64),
    "two_opt": (_two_opt, 4, 15.0, 32),
    "s32": (_s32, 8, 4.0, 64),
}


def _batch(name, B, device):
    fill, F, T, cap = MIXES[name]
    gb = rt.GraphBuilder(n_sinks=F, end_time=T)
    fill(gb)
    cfg, p, a = gb.build(capacity=cap, device=device)
    params, adj = rt.stack_components([p] * B, [a] * B)
    return cfg, params, adj


def _drive_both(name, B, k, device):
    cfg, params, adj = _batch(name, B, device)
    prep = event_engine.prepare(cfg, params, adj, np.arange(B), k)
    kern = event_engine.drive(prep, kernels.launch_event_kernel, 100)
    plain = event_engine.drive(prep, event_step.run_launch, 100)
    torch.cuda.synchronize()
    return kern, plain


def _assert_bit_identical(kern, plain):
    (ck, tk, sk, dk), (cp, tp, sp, dp) = kern, plain
    assert dk == dp
    assert torch.equal(sk, sp)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    for nm in event_step.CARRY_NAMES:
        a, b = ck[nm], cp[nm]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), nm


@pytest.mark.parametrize("stem", sorted(kernels._API))
def test_each_library_loads_through_the_one_loader(card, stem):
    """Built, loaded and declared by ``kernels._library``, its bounds
    those of ``ops.kernels``, cached, and its CUDA errors named by its
    own error string."""
    lib = kernels._library(stem)
    assert kernels._library(stem) is lib and kernels._LIBS[stem] is lib
    api = kernels._API[stem]
    for name, (_, want) in api["bounds"].items():
        assert getattr(lib, name)() == want
    assert getattr(lib, api["error"])(0) == b"no error"
    kernels._raise_on(stem, 0, stem)
    with pytest.raises(RuntimeError, match=r"CUDA error 1 \(invalid "):
        kernels._raise_on(stem, 1, stem)


@pytest.mark.parametrize("words,want", VECTORS)
def test_device_threefry_random123_vectors(card, words, want):
    args = [ttf.to_bits32(torch.tensor([w])).to(card) for w in words]
    y0, y1 = kernels.threefry_on_device(*args)
    got = tuple(int(ttf.from_bits32(y.cpu())[0]) for y in (y0, y1))
    assert got == want


def test_device_threefry_matches_plain(card):
    rng = np.random.RandomState(5)
    words = [torch.from_numpy(rng.randint(0, 2**32, 4096, dtype=np.uint64)
                              .astype(np.int64)) for _ in range(4)]
    y0, y1 = kernels.threefry_on_device(
        *(ttf.to_bits32(w).to(card) for w in words))
    p0, p1 = ttf.threefry2x32(*words)
    assert torch.equal(ttf.from_bits32(y0.cpu()), p0)
    assert torch.equal(ttf.from_bits32(y1.cpu()), p1)


# B = 37 and 1001 are multiples of no block width.
@pytest.mark.parametrize("name,B,k", [("full_mix", 64, 4),
                                      ("headline", 128, 8),
                                      ("two_opt", 64, 2),
                                      ("s32", 37, 2),
                                      ("s32", 1001, 1)])
def test_event_kernel_matches_plain_version(card, name, B, k):
    _assert_bit_identical(*_drive_both(name, B, k, card))


@pytest.mark.parametrize("started", [False, True])
def test_event_kernel_with_every_source_an_opt_row(card, started):
    # S = MAX_S with every source an Opt row takes the most shared memory a
    # block takes (over 48 KB, so the launch raises the block's limit), at
    # B = 37, a multiple of no block width.  An Opt clock starts at +inf,
    # so nothing fires unless the clocks are started inside the horizon;
    # started, the rows react to each other: the fire paired with the first
    # reacting row, the other reacting rows two at a time.
    cfg, params, adj, mc = chip_smoke.s32_all_opt_component(37, card)
    prep = event_engine.prepare(cfg, params, adj, np.arange(37), 1)
    if started:
        prep = chip_smoke.started_clocks(prep)
    kern = event_engine.drive(prep, kernels.launch_event_kernel, mc)
    plain = event_engine.drive(prep, event_step.run_launch, mc)
    torch.cuda.synchronize()
    _assert_bit_identical(kern, plain)
    nev = int(kern[0]["nev"].sum())
    draws = int((ttf.from_bits32(kern[0]["ctr"])
                 - ttf.from_bits32(prep.carry["ctr"])).sum())
    if started:
        assert nev > 37 and draws > 2 * nev
    else:
        assert nev == 0 and draws == 0


def test_event_kernel_replay_only_bit_identical(card):
    (ck, tk, sk, _), (cp, tp, sp, _) = _drive_both("replay", 32, 1, card)
    assert torch.equal(tk, tp) and torch.equal(sk, sp)
    assert torch.equal(ck["nev"], cp["nev"])


@pytest.mark.parametrize("mode,want", [
    ("nan", numerics.BIT_NONFINITE_TIME),
    ("inf", numerics.BIT_NONFINITE_STATE),
])
def test_poisoned_lane_at_max_s_bit_identical(card, monkeypatch, mode, want):
    cfg, params, adj = _batch("s32", 101, card)
    monkeypatch.setenv(faultinject.ENV_FAULT, f"numeric:{mode}@lane7")
    prep = event_engine.prepare(cfg, params, adj, np.arange(101), 2)
    kern = event_engine.drive(prep, kernels.launch_event_kernel, 100)
    plain = event_engine.drive(prep, event_step.run_launch, 100)
    _assert_bit_identical(kern, plain)
    health = ttf.from_bits32(kern[0]["health"]).cpu()
    assert health[7] & want
    assert int((health != 0).sum()) == 1


@pytest.mark.parametrize("mode,want", [
    ("nan", numerics.BIT_NONFINITE_TIME),
    ("inf", numerics.BIT_NONFINITE_STATE),
])
def test_health_under_numeric_fault_matches_plain(card, monkeypatch, mode,
                                                  want):
    # Lane 1's source 0 is the Hawkes wall in this layout.
    gb = rt.GraphBuilder(n_sinks=2, end_time=12.0)
    gb.add_hawkes(l0=0.8, alpha=0.3, beta=1.0, sinks=[0])
    gb.add_poisson(rate=1.0, sinks=[1])
    gb.add_opt(q=1.0)
    cfg, p, a = gb.build(capacity=64, device=card)
    params, adj = rt.stack_components([p] * 4, [a] * 4)
    monkeypatch.setenv(faultinject.ENV_FAULT, f"numeric:{mode}@lane1")
    prep = event_engine.prepare(cfg, params, adj, np.arange(4), 1)
    ck, _, sk, _ = event_engine.drive(prep, kernels.launch_event_kernel, 100)
    cp, _, sp, _ = event_engine.drive(prep, event_step.run_launch, 100)
    assert torch.equal(ck["health"], cp["health"]) and torch.equal(sk, sp)
    health = ttf.from_bits32(ck["health"]).cpu()
    assert health[1] & want
    assert (health[[0, 2, 3]] == 0).all()


def test_headline_slice_on_card_counts_its_launches(card):
    cfg, params, adj = _batch("headline", 256, card)
    kernels.reset_launch_counts()
    log = rt.simulate_batch(cfg, params, adj, np.arange(256), engine="fused")
    assert log.engine == "cuda" and log.times.is_cuda
    assert kernels.LAUNCHES["event_kernel"] == log.dispatches > 0
    top1 = rt.feed_metrics_batch(log.times, log.srcs, adj, 0, 20.0) \
        .mean_time_in_top_k()
    assert torch.isfinite(top1).all()
    cpu = rt.simulate_batch(cfg, params.to("cpu"), adj.cpu(), np.arange(256),
                            engine="fused", device="cpu")
    assert cpu.engine == "plain"
    assert torch.equal(cpu.srcs, log.srcs.cpu())
    assert torch.equal(cpu.n_events, log.n_events.cpu())


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    cfg, params, adj = _batch("full_mix", 8, card)
    prep = event_engine.prepare(cfg, params, adj, np.arange(8), 1)
    kernels.reset_launch_counts()
    bad = dict(prep.params, rate=prep.params["rate"].double())
    with pytest.raises(ValueError, match="rate has dtype"):
        kernels.launch_event_kernel(prep.spec, bad, prep.carry)
    bad = dict(prep.params, adj=prep.params["adj"][:, :, :4].contiguous())
    with pytest.raises(ValueError, match="adj has shape"):
        kernels.launch_event_kernel(prep.spec, bad, prep.carry)
    assert kernels.LAUNCHES["event_kernel"] == 0  # refused, never launched


def test_scan_resume_equals_continuous_run_on_card(card):
    """The scan engine on the card: T = 10 with return_state, then resume
    to T = 20, gives the continuous T = 20 log bit for bit on every lane
    (the mix of every non-neural kind, two Opt rows among them)."""
    cfg, params, adj, mc = chip_smoke.scan_mix_component(64, card)
    cfg = dataclasses.replace(cfg, end_time=20.0)
    half = dataclasses.replace(cfg, end_time=10.0)
    seeds = np.arange(64)
    cont = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc)
    log1, state = rt.simulate_batch(half, params, adj, seeds, max_chunks=mc,
                                    return_state=True)
    log2, _ = rt.resume(cfg, params, adj, state, max_chunks=mc)
    assert cont.engine == log1.engine == log2.engine == "scan"
    assert cont.times.is_cuda and state.t_next.is_cuda
    t, s, n = chip_smoke.joined(log1, log2)
    assert int(n.sum()) > 64
    assert chip_smoke.same_prefix("resume", t, s, n, cont) == 0


def _star(device, walls="hawkes", F=40):
    sb = rt.StarBuilder(n_feeds=F, end_time=30.0)
    for f in range(F):
        if walls == "hawkes":
            sb.wall_hawkes(f, 0.5, 0.8, 2.0)
        else:
            sb.wall_poisson(f, 1.0 + 0.05 * f)
    sb.ctrl_opt(q=0.5)
    return sb.build(wall_cap=256, post_cap=1024, device=device)


@pytest.mark.parametrize("walls", ["hawkes", "poisson"])
def test_star_doubling_equals_loop_on_card(card, walls):
    """The star engine's two fire modes, compressed and not, give the same
    posts and metrics bit for bit on the card."""
    from redqueen_tpu_torch.parallel import star_run

    cfg, wall, ctrl = _star(card, walls)
    ref = rt.simulate_star(cfg, wall, ctrl, seed=3, device=card)
    loop = rt.simulate_star(cfg, wall, ctrl, seed=3, fire_mode="loop",
                            device=card)
    assert ref.n_posts == loop.n_posts > 0
    assert torch.equal(ref.own_times.view(torch.int32),
                       loop.own_times.view(torch.int32))
    keys = rt.sim._as_keys(np.array([3]), card)
    wb, cb = wall.map(lambda x: x[None]), ctrl.map(lambda x: x[None])
    outs = [star_run._get_fn(cfg, 1, c, m, card)(wb, cb, keys)
            for c in (True, False) for m in ("loop", "doubling")]
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0])
        assert torch.equal(o[4].time_in_top_k, outs[0][4].time_in_top_k)


def test_star_batch_lanes_equal_single_runs_on_card(card):
    cfg, wall, ctrl = _star(card, "poisson")
    rb = rt.simulate_star_batch(cfg, *rt.broadcast_star(wall, ctrl, 3),
                                np.array([4, 5, 6]), device=card)
    for i, s in enumerate((4, 5, 6)):
        one = rt.simulate_star(cfg, wall, ctrl, seed=s, device=card)
        assert torch.equal(one.own_times, rb.own_times[i])


def test_star_hawkes_batch_matches_the_reference_on_card(card):
    """Config 2's model at a small size on the card: each lane's walls as
    its single run's, and walls, posts and time on top within
    ``tests/test_torch_star_reference.py``'s tolerances of the
    benchmark's plain reference."""
    from portbench.reference import star as ref

    F, T, seeds = 24, 20.0, np.array([5, 2 ** 31 + 17, 123456789])
    rng = np.random.RandomState(0)
    l0 = rng.uniform(0.3, 1.0, F).astype(np.float32)
    beta = rng.uniform(1.0, 3.0, F).astype(np.float32)
    alpha = (beta * rng.uniform(0.2, 0.8, F)).astype(np.float32)
    sb = rt.StarBuilder(n_feeds=F, end_time=T)
    for f in range(F):
        sb.wall_hawkes(f, float(l0[f]), float(alpha[f]), float(beta[f]))
    sb.ctrl_opt(q=1.0)
    cfg, wall, ctrl = sb.build(wall_cap=128, post_cap=1024, device=card)
    rb = rt.simulate_star_batch(cfg, *rt.broadcast_star(wall, ctrl, 3),
                                seeds, device=card)
    for i, s in enumerate(seeds):
        one = rt.simulate_star(cfg, wall, ctrl, seed=int(s), device=card)
        assert torch.equal(one.wall_times, rb.wall_times[i])
    star = ref.Star(*(torch.tensor(x, dtype=torch.float64)
                      for x in (l0, alpha, beta, np.ones(F))),
                    end_time=T, post_cap=1024, wall_cap=128)
    times, n = rb.wall_times.cpu(), rb.wall_n.cpu()
    own, n_p = rb.own_times.cpu(), rb.n_posts.cpu()
    wg, _, _ = ref.check_walls(star, seeds, times, n)
    pg = ref.check_posts(star, seeds, times, n, own, n_p)
    top, mean = ref.top1(star, times, n, own, n_p)
    assert float(wg.max()) <= 1e-4 and float(pg.max()) <= 1e-4
    assert float((rb.metrics.time_in_top_k.cpu().double() - top).abs()
                 .max()) <= 1e-4
    assert float((rb.metrics.mean_time_in_top_k().cpu().double() - mean)
                 .abs().max()) <= 1e-4


def _thin_case(case, dev):
    """``(key, l0, alpha, beta, t0, T, cap)`` of a thinning case."""
    from redqueen_tpu_torch.ops import prng

    g = torch.Generator().manual_seed(0)
    if case == "config 2 at 4 lanes":
        N = 4 * 1000
        l0, alpha, beta = (torch.full((N,), x) for x in (0.5, 0.8, 2.0))
        t0, T, cap = 0.0, 100.0, 1024
    else:
        N = 5000
        l0 = 0.2 + torch.rand(N, generator=g)
        beta = 1.0 + 2.0 * torch.rand(N, generator=g)
        alpha = beta * (0.2 + 0.6 * torch.rand(N, generator=g))
        t0, T, cap = 0.0, 50.0, 256
        if case == "a small cap":
            cap = 8
        elif case == "t0 > 0, some l0 = 0":
            l0[::7] = 0.0
            t0, T = 3.7, 20.3
    key = prng.fold_in(prng.PRNGKey(torch.tensor(2 ** 31 + 3)),
                       torch.arange(N))
    return (key.to(dev), l0.to(dev), alpha.to(dev), beta.to(dev), t0, T,
            cap)


@pytest.mark.parametrize("case", ["config 2 at 4 lanes", "random l0/α/β",
                                  "a small cap", "t0 > 0, some l0 = 0"])
def test_hawkes_stream_kernel_equals_plain_on_card(card, case):
    """The thinning kernel's streams are the plain loop's on the card, bit
    for bit, from one launch a stream; its exact step count is the one
    the loop rounds up to a multiple of ``PROBE_EVERY``."""
    from redqueen_tpu_torch.ops import streams
    from redqueen_tpu_torch.ops.sampling import PROBE_EVERY
    from redqueen_tpu_torch.runtime import telemetry

    args = _thin_case(case, card)
    kernels.reset_launch_counts()
    steps = []
    try:
        telemetry.configure(enabled=True, reset=True)
        got = streams.hawkes_stream(*args)
        steps.append(telemetry.get().counters["star.hawkes.steps"])
        assert kernels.LAUNCHES["hawkes_thin"] == 1
        telemetry.configure(enabled=True, reset=True)
        want = streams._hawkes_stream_plain(*args)
        steps.append(telemetry.get().counters["star.hawkes.steps"])
        assert kernels.LAUNCHES["hawkes_thin"] == 1
    finally:
        telemetry.configure(enabled=False, reset=True)
    assert steps[1] == PROBE_EVERY * -(-steps[0] // PROBE_EVERY) > 0
    assert torch.equal(got.times.view(torch.int32),
                       want.times.view(torch.int32))
    assert torch.equal(got.n, want.n)
    assert torch.equal(got.truncated, want.truncated)
    n = want.n.cpu()
    assert int(n.sum()) > 5 * len(n)
    if case == "a small cap":
        assert float(want.truncated.float().mean()) > 0.5
    if case == "t0 > 0, some l0 = 0":
        assert int(n[::7].sum()) == 0 and float(want.times.min()) > 3.7


def test_a_config2_star_batch_launches_the_thinning_kernel_once(card):
    """A star batch of config 2 runs its 4 x 1,000 Hawkes walls through one
    launch of the thinning kernel, and telemetry counts it and its steps
    (read from the card) with no host read of the stream's own."""
    from redqueen_tpu_torch.presets import config2_hawkes
    from redqueen_tpu_torch.runtime import telemetry

    _, cfg, wall, ctrl = config2_hawkes(end_time=30.0, device=card)
    kernels.reset_launch_counts()
    telemetry.configure(enabled=True, reset=True)
    try:
        rb = rt.simulate_star_batch(cfg, *rt.broadcast_star(wall, ctrl, 4),
                                    np.arange(4) + 9, device=card)
        counters = dict(telemetry.get().counters)
    finally:
        telemetry.configure(enabled=False, reset=True)
    assert kernels.LAUNCHES["hawkes_thin"] == 1
    assert counters["star.hawkes.kernel"] == 1
    assert counters["star.hawkes.host_reads"] == 0
    assert 0 < counters["star.hawkes.steps"] < 10_000
    assert int(rb.wall_n.min()) > 0


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_simulate_ragged_bucketed_equals_dense_on_card(card, engine):
    counts = np.array([1, 2, 3, 9, 16, 5, 12, 2, 16, 7] * 3)
    seeds = np.arange(len(counts)) + 11
    kernels.reset_launch_counts()
    rb = rt.simulate_ragged(counts, seeds, end_time=8.0, engine=engine,
                            max_buckets=4, return_logs=True, device=card)
    launches = kernels.LAUNCHES["event_kernel"]
    rd = rt.simulate_ragged(counts, seeds, end_time=8.0, engine=engine,
                            max_buckets=1, return_logs=True, device=card)
    assert rb.engine == ("cuda" if engine == "fused" else "scan")
    assert launches == (rb.dispatches if engine == "fused" else 0)
    for f in ("n_events", "top_k", "posts", "health"):
        np.testing.assert_array_equal(getattr(rb, f), getattr(rd, f))
    for (tb, sb), (td, sd) in zip(rb.logs, rd.logs):
        assert np.array_equal(tb.view(np.int32), td.view(np.int32))
        assert np.array_equal(sb, sd)


# ---- config 5 (RMTPP) and the headline bench on the card ----


def _rmtpp_batch(dev, B=32, T=30.0, hidden=8):
    from redqueen_tpu_torch.models import rmtpp

    w = rmtpp.init_weights(3, hidden=hidden, device=dev)
    return chip_smoke.rmtpp_batch(w, B, T, 512, dev, hidden) + (w,)


def test_config5_card_against_cpu_and_its_state(card):
    """Config 5's component with fixed weights: the card's scan run
    against the CPU's (near-ties only, at most 2% of lanes), and resume
    on the card equal to the continuous run bit for bit (``h`` too)."""
    cfg, params, adj, row, w = _rmtpp_batch(card)
    res = chip_smoke.config5_cross(w, card, B=32, end_time=30.0,
                                   capacity=512)
    assert res["events_card"] > 32 * 200
    seeds = np.arange(32)
    full, s_full = rt.simulate_batch(cfg, params, adj, seeds,
                                     return_state=True, device=card)
    half = dataclasses.replace(cfg, end_time=15.0)
    l1, st = rt.simulate_batch(half, params, adj, seeds, return_state=True,
                               device=card)
    l2, s2 = rt.resume(cfg, params, adj, st)
    assert torch.equal(l1.n_events + l2.n_events, full.n_events)
    assert torch.equal(s2.h, s_full.h) and torch.equal(s2.t_next,
                                                       s_full.t_next)


def test_rmtpp_fit_on_card_matches_cpu(card):
    from redqueen_tpu_torch.models import rmtpp
    from redqueen_tpu_torch.presets import config5_data

    taus, mask = config5_data()
    _, _, lc = rmtpp.fit(0, taus, mask, hidden=8, steps=20, device=card)
    _, _, lp = rmtpp.fit(0, taus, mask, hidden=8, steps=20, device="cpu")
    np.testing.assert_allclose(lc, lp, rtol=chip_smoke.FIT_RTOL)


def test_rmtpp_stream_and_star_on_card(card):
    from redqueen_tpu_torch.models import rmtpp

    w = rmtpp.init_weights(4, hidden=8, device=card)
    res = chip_smoke.rmtpp_stream_cross(w, card, n=64, T=50.0, cap=256)
    assert res["events"] > 64 and res["counts_differing"] <= 1


def test_bench_quick_on_card_names_the_card():
    """``python -m redqueen_tpu_torch.bench --quick`` on the card: both
    engines inside the oracle's gate, the fused one through the
    kernel, and the card's name as ``platform``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the bench refuses to run "
                    "without one unless --device cpu is given")
    line = chip_smoke.bench_run(["--quick"])
    assert line["platform"] == torch.cuda.get_device_name(0)
    assert line["engines"]["fused"]["launches"] > 0


# ---- the learn path: the hawkes_pass kernel and the fits on the card ----
# Tolerance (stated in chip_smoke): every per-chunk output of the kernel
# within chip_smoke.PASS_RTOL (1e-4) of its largest magnitude against the
# plain version on the same tensors (expf/logf ulps and the order of the
# sum over dimensions), health equal; a resumed fit bit-identical to the
# uninterrupted one (the pass sums in a fixed order).


@pytest.mark.parametrize("grad", [False, True], ids=["stats", "grad"])
@pytest.mark.parametrize("D,n,K", [(5, 3000, 1024), (64, 3840, 512),
                                   (33, 700, 100),
                                   # the world's shape: one chunk, 1,093
                                   # events, three dimensions
                                   (3, 1093, 4096),
                                   # three dimensions a lane, and
                                   # the widest D the kernel takes
                                   (96, 2000, 512), (128, 2000, 512),
                                   # 16 chunks of the corpus's width
                                   (64, 16 * 4096 - 2048, 4096)])
def test_hawkes_pass_matches_plain_on_card(card, grad, D, n, K):
    ch, mu, alpha, beta = chip_smoke.pass_stream(D, n, K, seed=D)
    before = kernels.LAUNCHES["hawkes_pass"]
    out = chip_smoke.pass_cross(f"D={D}", ch, mu, alpha, beta, card, grad)
    assert kernels.LAUNCHES["hawkes_pass"] == before + 1
    assert out["health"][0] != 0 and not any(out["health"][1:])


def test_hawkes_pass_is_deterministic_on_card(card):
    from redqueen_tpu_torch.learn import loglik

    ch, mu, alpha, beta = chip_smoke.pass_stream(16, 5000, 512, seed=1)
    args = chip_smoke.pass_inputs(ch, mu, alpha, beta, card)
    a = loglik.hawkes_pass(*args)
    b = loglik.hawkes_pass(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_hawkes_pass_is_deterministic_on_card_across_chunks(card):
    from redqueen_tpu_torch.learn import loglik

    ch, mu, alpha, beta = chip_smoke.pass_stream(64, 16 * 4096 - 2048, 4096,
                                                 seed=64)
    args = chip_smoke.pass_inputs(ch, mu, alpha, beta, card)
    for grad in (False, True):
        a = loglik.hawkes_pass(*args, grad=grad)
        b = loglik.hawkes_pass(*args, grad=grad)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# The carries: the kernel's phases (A) and (B) against hawkes_carry_plain,
# within chip_smoke.CARRY_RTOL (1e-5) of the largest magnitude.
@pytest.mark.parametrize("grad", [False, True], ids=["stats", "grad"])
@pytest.mark.parametrize("D,n,K,W", [
    (3, 1093, 4096, None), (33, 1100, 100, 8), (64, 16 * 4096 - 2048, 4096,
                                                None),
    (96, 2000, 512, None), (128, 2000, 512, None),
    (5, 300, 64, 12)])   # segments of 6: the last one empty
def test_hawkes_carry_matches_plain_on_card(card, grad, D, n, K, W):
    ch, _, _, beta = chip_smoke.pass_stream(D, n, K, seed=D)
    before = kernels.LAUNCHES["hawkes_carry"]
    out = chip_smoke.carry_cross(f"D={D}", ch, beta, card, grad, segments=W)
    assert kernels.LAUNCHES["hawkes_carry"] == before + 1
    assert out["segments"] == (W or kernels.hawkes_segments(D))


def test_hawkes_wrapper_refuses_what_the_kernel_does_not_take(card):
    D = kernels.HAWKES_MAX_D + 1
    ch, mu, alpha, beta = chip_smoke.pass_stream(D, 100, 64, seed=0)
    args = chip_smoke.pass_inputs(ch, mu, alpha, beta, card)
    with pytest.raises(ValueError, match="HAWKES_MAX_D=128"):
        kernels.launch_hawkes_pass(*args)
    ch, mu, alpha, beta = chip_smoke.pass_stream(4, 100, 64, seed=0)
    args = list(chip_smoke.pass_inputs(ch, mu, alpha, beta, card))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_hawkes_pass(*[a.cpu() for a in args])
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="dims has dtype"):
        kernels.launch_hawkes_pass(*bad)
    bad = list(args)
    bad[5] = bad[5][:, :3].contiguous()
    with pytest.raises(ValueError, match="alpha has shape"):
        kernels.launch_hawkes_pass(*bad)


def test_hawkes_carry_wrapper_refuses_segments_it_does_not_take(card):
    ch, _, _, beta = chip_smoke.pass_stream(64, 500, 128, seed=0)
    dt, dims, mask, _, _, _, b = chip_smoke.pass_inputs(
        ch, np.ones(64), np.zeros((64, 64)), beta, card)
    top = kernels.hawkes_segments(64)
    assert kernels.launch_hawkes_carry(dt, dims, mask, b, top)[0].shape[1] \
        == top
    for bad in (0, top + 1):
        with pytest.raises(ValueError, match="segments a chunk at D=64"):
            kernels.launch_hawkes_carry(dt, dims, mask, b, bad)


@pytest.mark.parametrize("solver", ["em", "fw"])
def test_fit_resume_bit_identical_on_card(card, tmp_path, solver):
    rng = np.random.RandomState(5)
    times = np.sort(rng.uniform(0, 100, 400))
    s = rt.learn.ingest.make_stream(times, rng.randint(0, 2, 400), 2,
                                    t_end=100.0)
    p = str(tmp_path / "fit.npz")
    kw = dict(solver=solver, tol=0.0, sync_every=4, ckpt_every=8,
              fw_beta_warmup=4, device=card)
    rt.learn.fit_hawkes(s, max_iters=16, ckpt_path=p, **kw)
    before = kernels.LAUNCHES["hawkes_pass"]
    fit_b = rt.learn.fit_hawkes(s, max_iters=40, ckpt_path=p, **kw)
    # the resumed 24 iterations and the final score, one launch each
    # (a resumed FW fit also computes G once)
    assert kernels.LAUNCHES["hawkes_pass"] - before == 24 + 1 + (
        solver == "fw")
    fit_c = rt.learn.fit_hawkes(s, max_iters=40, **kw)
    for f in ("mu", "alpha", "beta", "loglik"):
        np.testing.assert_array_equal(getattr(fit_b, f), getattr(fit_c, f))
    cpu = rt.learn.fit_hawkes(s, max_iters=40, **dict(kw, device="cpu"))
    np.testing.assert_allclose(fit_c.loglik, cpu.loglik, rtol=1e-5)


def test_hawkes_loglik_on_card_matches_cpu(card):
    ch, mu, alpha, beta = chip_smoke.pass_stream(3, 2000, 4096, seed=2,
                                                 degenerate=False)
    a = rt.learn.hawkes_loglik(ch, mu, alpha, beta, device=card)
    b = rt.learn.hawkes_loglik(ch, mu, alpha, beta, device="cpu")
    np.testing.assert_allclose(a.loglik, b.loglik, rtol=1e-5)
    np.testing.assert_array_equal(a.health, b.health)
    s = rt.learn.ingest.make_stream(np.sort(np.random.RandomState(0)
                                            .uniform(0, 10, 50)),
                                    np.zeros(50, int), 1, t_end=10.0)
    np.testing.assert_allclose(
        rt.learn.holdout_nll(s, [1.0], [[0.2]], [1.0], device=card),
        rt.learn.holdout_nll(s, [1.0], [[0.2]], [1.0], device="cpu"),
        rtol=1e-5)


# ---- the serving path (chip_smoke.py phase 10's parts, smaller) ----

def test_serving_apply_on_card_matches_cpu(card):
    """Each batch applied on the card and on the CPU from the same carry:
    decisions equal but for counted near-ties (at most 2%), the digests
    equal after every equal decision, intensities within 1e-5."""
    out = chip_smoke.card_against_cpu(card, n_feeds=2048, n_batches=128)
    assert len(out["near_ties"]) <= 0.02 * out["batches"]


def test_serving_coalesce_and_width_invariance_on_card(card):
    chip_smoke.coalesce_invariance(card, n_feeds=2048, n_batches=96)
    chip_smoke.width_invariance(card, n_feeds=2048, n_rounds=3)


def test_serving_recover_on_card(card):
    out = chip_smoke.recover_mid_stream(card, n_feeds=2048, n_batches=96,
                                        close_at=50)
    assert out["replayed"] == 50


def test_fit_while_serving_on_card(card):
    """Its count starts from 0 at the fit and is read right after it (the
    CPU's fit beside it launches nothing)."""
    out = chip_smoke.fit_while_serving(card, D=16, t_end=600.0)
    assert out["launches"] >= 1 and out["epoch"] == 1
    assert kernels.LAUNCHES["hawkes_pass"] == out["launches"]


# ---- the serving cluster (chip_smoke.py phase 11's parts, smaller) ----

def test_cluster_in_process_on_card_matches_cpu(card):
    out = chip_smoke.cluster_card_against_cpu(card, n_feeds=256,
                                              n_batches=64, n_shards=2)
    assert out["decisions"] == 2 * (64 + 8) and out["posts"] > 0


def test_cluster_workers_hold_the_card(card):
    """Two worker processes, each with a context on the card, serve the
    in-process cluster's digest."""
    from redqueen_tpu_torch.smoke import cluster as smoke_cluster

    batches = smoke_cluster.bench_stream(256, 64)
    ip = chip_smoke.cluster_bench(card, "in-process", 2, batches,
                                  n_feeds=256)
    w = chip_smoke.cluster_bench(card, "workers", 2, batches, n_feeds=256,
                                 check_contexts=True)
    assert w["digest"] == ip["digest"]
    assert w["contexts"]["method"] in ("pid", "count")


def test_cluster_reshard_on_card(card):
    from redqueen_tpu_torch.smoke import cluster as smoke_cluster

    out = chip_smoke.reshard_offline(card, smoke_cluster.bench_stream(256, 32),
                                     n_feeds=256)
    assert out["to"] == 2 and out["seq"] == 32 + 8 - 1


def test_supervised_checkpointed_sweep_on_card(card, tmp_path, monkeypatch):
    """Phase 12 (a) at 192 lanes a half: the supervised checkpointed
    trade-off experiment on the event kernel, SIGTERMed after its first
    chunk, resumed bit for bit, reported as a card run, its launches
    counted by the wrapper and by ``engine.pallas.launches``; the corrupt
    chunk recomputed alone."""
    from redqueen_tpu_torch.smoke import runtime as R

    monkeypatch.delenv("RQ_FAULT", raising=False)
    settings = dict(q_grid=(0.1, 1.0, 10.0), n_seeds=64, F=10, T=100.0,
                    wall_rate=1.0)
    out, ref = R.supervised_sweep(card, settings, str(tmp_path))
    assert out["backend_used"] == "cuda" and out["child"]["platform"] == \
        "cuda"
    assert out["child"]["event_kernel_launches"] == \
        out["child"]["pallas_launches"] > 0
    assert out["uninterrupted_launches"] > 0
    assert ref[0].n_posts.shape == ref[1].n_posts.shape == (3, 64)


def test_native_loader_on_the_card_machine(card, tmp_path):
    """Phase 12 (f) at 2,000 users: built with g++ there, equal to the
    Python engine."""
    from redqueen_tpu_torch.smoke import runtime as R

    out = R.native_load(str(tmp_path), dict(seed=5, n_users=2000,
                                            end_time=10.0))
    assert out["rows"] > 10_000 and out["native_rows_per_s"] > 0


def test_world_of_one_on_nccl_shards_bit_identically(card, tmp_path):
    """Phase 13 (a) small: a world of one rank on NCCL, the headline's
    component at B = 64 through ``simulate_sharded`` equal to the
    unsharded scan run on every lane, and the star engine on a feed axis
    of one rank equal to its unsharded run."""
    from redqueen_tpu_torch.parallel import comm, multihost
    from redqueen_tpu_torch.smoke.fused import headline_component

    cfg, params, adj, _, mc = headline_component(64, 20.0, card)
    ref = rt.simulate_batch(cfg, params, adj, np.arange(64), max_chunks=mc,
                            engine="scan", device=card)
    sb = rt.StarBuilder(n_feeds=8, end_time=20.0)
    for f in range(8):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_opt(q=1.0)
    scfg, wall, ctrl = sb.build(wall_cap=64, post_cap=256, device=card)
    sref = rt.simulate_star(scfg, wall, ctrl, seed=0, device=card)
    multihost.initialize(f"file://{tmp_path}/pg", 1, 0, device=card)
    try:
        assert multihost.process_summary()["backend"] == "nccl"
        log = rt.parallel.simulate_sharded(
            cfg, params, adj, np.arange(64), comm.make_mesh({"data": 1}),
            max_chunks=mc, device=card)
        got = multihost.gather_global([log.times, log.srcs, log.n_events])
        star = rt.simulate_star(scfg, wall, ctrl, seed=0,
                                mesh=comm.make_mesh({"feed": 1}),
                                device=card)
        sgot = multihost.gather_global([star.own_times, star.wall_n])
    finally:
        multihost.shutdown()
    for g, w in zip(got, (ref.times, ref.srcs, ref.n_events)):
        np.testing.assert_array_equal(g, w.cpu().numpy())
    assert log.engine == "scan"
    np.testing.assert_array_equal(sgot[0], sref.own_times.cpu().numpy())
    np.testing.assert_array_equal(sgot[1], sref.wall_n.cpu().numpy())


def test_two_ranks_share_the_card_over_gloo(card, tmp_path):
    """Phase 13 (b)-(c) small: the multi-process demo as two ranks on one
    card (gloo, the ``RQ_*`` environment) gives the summary of one rank
    on the card, but for the topology."""
    import json
    import os
    import subprocess
    import sys

    def demo(n, d):
        d.mkdir()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "redqueen_tpu_torch.parallel."
             "multihost_demo", "--out", str(d / "r0.json")],
            env=dict(os.environ, RQ_COORDINATOR=f"file://{d}/pg",
                     RQ_NUM_PROCESSES=str(n), RQ_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-3000:]
        return json.loads((d / "r0.json").read_text())

    one, two = demo(1, tmp_path / "one"), demo(2, tmp_path / "two")
    assert (one["backend"], two["backend"]) == ("nccl", "gloo")
    assert two["platform"] == "cuda" and two["process_count"] == 2
    topo = ("process_index", "process_count", "global_devices",
            "mesh_shape", "backend")
    assert {k: v for k, v in one.items() if k not in topo} == \
        {k: v for k, v in two.items() if k not in topo}


def test_event_kernel_launches_lie_inside_their_spans_on_the_card(card):
    """The spans and ``torch.profiler``'s records share one clock: in a
    traced fused batch at small T, every event-kernel launch record lies
    inside an ``engine.pallas.launch`` span."""
    from redqueen_tpu_torch.smoke import span_cost

    system = span_cost.Headline("fused", 256, 10.0, card)
    system.batch(np.arange(256))
    out = span_cost.traced_batch(system, np.arange(256) + 1, True)
    assert out["launch_records"] > 0, \
        "the profiler delivered no runtime records with the device's"
    ek = out["event_kernel_launches"]
    assert ek["of"] >= 1 and ek["inside_launch_span"] == ek["of"], ek
