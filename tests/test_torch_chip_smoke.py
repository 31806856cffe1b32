"""``chip_smoke.py`` rehearsed on the CPU: each phase-4 comparison runs
with the kernel's wrapper replaced by its plain PyTorch version (the
kernel itself runs only on the card), so the mixes build, the faults
poison the lane they name, the started clocks drive the all-Opt mix, and
the comparison and its checks run as they do there.  Phase 6 (the scan
engine) runs its parts (a)-(e) at B = 8 with ``device="cpu"`` on both
sides, and its card-against-CPU gate is fed made-up logs.

Tolerance: none; every lane is held bit-identical, as on the card (the
gate of phase 6 (b) is itself under test: rtol 1e-5, 2% near-ties)."""

import numpy as np
import pytest
import torch

import chip_smoke
import redqueen_tpu_torch as rt
from redqueen_tpu_torch.ops import event_step, kernels
from redqueen_tpu_torch.ops.threefry import from_bits32

KEYS = list(chip_smoke.PARITY_MIXES) + [
    f"s32_poisoned_{m}" for m in chip_smoke.POISON_MODES]


@pytest.fixture(autouse=True)
def autotune_cache(tmp_path, monkeypatch):
    """The lane layer's autotune cache in the test's own directory."""
    monkeypatch.setenv("RQ_LANES_AUTOTUNE", str(tmp_path / "autotune.json"))


@pytest.fixture
def plain_wrapper(monkeypatch):
    monkeypatch.setattr(kernels, "launch_event_kernel", event_step.run_launch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("key", KEYS)
def test_phase4_comparison_runs_on_the_plain_version(plain_wrapper, key):
    if key.startswith("s32_poisoned_"):
        out = chip_smoke.poisoned(key.rsplit("_", 1)[1], "cpu")
    else:
        label, prep, mc = chip_smoke.parity_prep(key, "cpu")
        out, (carry, _, srcs, _) = chip_smoke.compare_runs(label, prep, mc)
        if key == "s32_all_opt":
            # Every source is an Opt row: events come only from the started
            # clocks, and every event after the first reacts on some row.
            draws = int((from_bits32(carry["ctr"])
                         - from_bits32(prep.carry["ctr"])).sum())
            assert out["events"] > prep.B and draws > 2 * out["events"]
            assert int((srcs >= 0).sum()) == out["events"]
    assert out["bit_identical"] and out["lanes_differing"] == 0
    assert out["events"] > 0


# ---- phase 6, the scan engine, rehearsed on the CPU at a tiny batch ----

SCAN_B = 8


@pytest.fixture(scope="module")
def scan_ctx():
    """Phase 6 (a) at B = 8 on the CPU: the headline through the scan
    engine, gated against the fused engine's plain version at the timed
    seeds of phase 5; returns (result, context for (c)-(e))."""
    cfg, params, adj, opt, mc = chip_smoke.headline_component(SCAN_B, 100.0,
                                                              "cpu")
    fl = rt.simulate_batch(cfg, params, adj, np.arange(SCAN_B) + 10_000,
                           max_chunks=mc, engine="fused", device="cpu")
    top = rt.feed_metrics_batch(fl.times, fl.srcs, adj, opt, 100.0) \
        .mean_time_in_top_k().double().numpy()
    return chip_smoke.scan_headline("cpu", SCAN_B, 100.0,
                                    (top.mean(), top.std(), SCAN_B))


def test_phase6a_scan_headline(scan_ctx):
    res, ctx = scan_ctx
    assert res["launches"]["event_kernel"] == 0
    assert res["events"] == int(ctx[-1].n_events.sum()) > 0
    assert res["dispatches"] == ctx[-1].dispatches >= 2
    assert res["host_syncs"] >= res["dispatches"]
    assert res["steps"] == ctx[-1].times.shape[1]


@pytest.mark.parametrize("key", list(chip_smoke.SCAN_CROSS_B))
def test_phase6b_same_code_on_two_devices(key):
    out = chip_smoke.scan_cross(key, SCAN_B, "cpu")
    assert out["lanes"] == SCAN_B and out["lanes_differing"] == 0
    assert out["events_card"] == out["events_cpu"] > 0


def test_phase6c_resume(scan_ctx):
    out = chip_smoke.scan_resume(scan_ctx[1], "cpu")
    assert out["lanes_differing"] == 0 and out["events_resumed"] > 0


def test_phase6d_max_events(scan_ctx):
    out = chip_smoke.scan_max_events(scan_ctx[1], "cpu")
    assert out["lanes_not_prefix"] == 0
    assert 0 < out["events"] < int(scan_ctx[1][-1].n_events.sum())


def test_phase6e_auto(scan_ctx):
    out = chip_smoke.scan_auto(scan_ctx[1], "cpu")
    assert out["headline_engine"] == "scan"   # the kernel runs on the card
    assert out["bounded_engine"] == "scan"
    assert "max_events" in out["bounded_reason"]


def _fake_log(times, srcs):
    t = torch.tensor(times, dtype=torch.float32)
    s = torch.tensor(srcs, dtype=torch.int32)
    return rt.EventLog(t, s, (s >= 0).sum(1).to(torch.int32), None)


def test_phase6b_gate_counts_near_ties_and_fails_on_the_rest():
    inf = float("inf")
    cpu = _fake_log([[1.0, 2.0, 3.0]] * 100, [[0, 1, 2]] * 100)
    near = _fake_log([[1.0, 2.0000048, 3.0]] + [[1.0, 2.0, 3.0]] * 99,
                     [[0, 2, 1]] + [[0, 1, 2]] * 99)
    out = chip_smoke.compare_devices("near", near, cpu, 10.0)
    assert out["near_ties"] == 1 and out["lanes_differing"] == 1
    edge = _fake_log([[1.0, 2.0, inf]] + [[1.0, 2.0, 3.0]] * 99,
                     [[0, 1, -1]] + [[0, 1, 2]] * 99)
    at_end = _fake_log([[1.0, 2.0, 3.0]] * 100, [[0, 1, 2]] * 100)
    at_end.times[0, 2] = 9.99995
    assert chip_smoke.compare_devices("edge", edge, at_end, 10.0)[
        "near_ties"] == 1
    far = _fake_log([[1.0, 2.5, 3.0]] + [[1.0, 2.0, 3.0]] * 99,
                    [[0, 2, 1]] + [[0, 1, 2]] * 99)
    with pytest.raises(SystemExit):
        chip_smoke.compare_devices("far", far, cpu, 10.0)
    many = _fake_log([[1.0, 2.0000048, 3.0]] * 3 + [[1.0, 2.0, 3.0]] * 97,
                     [[0, 2, 1]] * 3 + [[0, 1, 2]] * 97)
    with pytest.raises(SystemExit):
        chip_smoke.compare_devices("many", many, cpu, 10.0)
    drift = _fake_log([[1.0, 2.0001, 3.0]] * 100, [[0, 1, 2]] * 100)
    with pytest.raises(SystemExit):
        chip_smoke.compare_devices("drift", drift, cpu, 10.0)


# ---- phase 7, the presets and the star engine, rehearsed on the CPU ----

SMALL_FULL = {
    1: dict(scale=1.0, end_time=8.0, capacity=128),
    2: dict(scale=0.01, end_time=20.0, wall_cap=128, post_cap=512),
    3: dict(scale=0.004, end_time=8.0, capacity=128),
    4: dict(scale=0.0002, end_time=20.0, q=2.0, post_cap=512),
}


def test_phase7ab_config3_lanes_equal_config1(monkeypatch):
    monkeypatch.setitem(chip_smoke.PRESET_SEEDS, 1, np.arange(6))
    # the fused mean: config 1's own scan lanes, so the 4-sigma gate holds
    out = rt.run_preset(rt.build_preset(1, device="cpu", **SMALL_FULL[1]),
                        np.arange(6), device="cpu")
    top = np.asarray(out["per_seed_top_k"])
    res = chip_smoke.preset_batch("cpu", (top.mean(), top.std(), 6),
                                  full=SMALL_FULL)
    assert res["config3"]["lanes"] == 4
    assert res["config3"]["lanes_differing_from_config1"] == 0
    assert res["config1"]["seeds"] == 6 and res["config1"]["events"] > 0


def test_phase7a_gate_fails_far_from_the_fused_mean(monkeypatch):
    monkeypatch.setitem(chip_smoke.PRESET_SEEDS, 1, np.arange(4))
    with pytest.raises(SystemExit):
        chip_smoke.preset_batch("cpu", (0.5, 0.01, 1000), full=SMALL_FULL)


@pytest.mark.parametrize("which", [2, 4])
def test_phase7c_star_cross_on_one_device(which):
    out = chip_smoke.star_cross(which, SMALL_FULL[which], "cpu")
    assert out["feeds_differing"] == 0 and out["max_rel_post"] == 0.0
    assert out["lanes_compared"] == len(chip_smoke.STAR_CROSS_SEEDS)


def test_phase7c_gate_counts_diverged_feeds():
    class R:
        def __init__(self, walls):
            self.wall_times = torch.tensor(walls, dtype=torch.float32)
            self.wall_n = torch.isfinite(self.wall_times).sum(1)

    inf = float("inf")
    cpu = R([[1.0, 2.0, inf], [0.5, inf, inf]])
    same = R([[1.0, 2.0000005, inf], [0.5, inf, inf]])
    assert not chip_smoke.star_feed_divergence(same, cpu).any()
    moved = R([[1.0, 2.5, inf], [0.5, inf, inf]])
    assert chip_smoke.star_feed_divergence(moved, cpu).tolist() == \
        [True, False]
    longer = R([[1.0, 2.0, inf], [0.5, 0.7, inf]])
    assert chip_smoke.star_feed_divergence(longer, cpu).tolist() == \
        [False, True]


def test_phase7d_config2_hawkes_gate():
    res = chip_smoke.star_config2("cpu", kw=SMALL_FULL[2],
                                  seeds=np.arange(2))
    assert set(res["stages_s"]) == {"streams", "fires", "metrics"}
    assert res["thin_launches"] == 0    # the plain loop on the CPU
    assert res["stages_s"]["streams"] > 0 and res["stages_s"]["fires"] > 0
    assert abs(res["wall_mean"] - res["wall_closed_form"]) < res["wall_4se"]
    # the closed form: stationary mean less the start-up transient
    assert chip_smoke.hawkes_mean_count(0.5, 0.8, 2.0, 100.0) == \
        pytest.approx(83.333333 - 0.277778, abs=1e-5)


def test_phase7e_config4_modes_bit_identical():
    res = chip_smoke.star_config4("cpu", kw=SMALL_FULL[4],
                                  seeds=np.arange(2))
    assert res["modes_identical"] == 4 and res["seed0_posts"] > 0
    assert res["stages_s"]["fires"] > 0


def test_phase7fg_power_law_routes():
    res = chip_smoke.power_law(
        "cpu", fused_kw=dict(B=24, max_followers=16, end_time=3.0),
        scan_kw=dict(B=12, max_followers=40, end_time=0.5))
    assert res["fused"]["engine"] == "plain"
    assert res["fused"]["launches"] == 0     # the plain version on the CPU
    assert res["scan"]["launches"] == 0
    for r in res.values():
        assert r["lanes_differing"] == 0 and r["events"] > 0


# ---- phase 8, the headline bench and config 5, rehearsed on the CPU ----


def _bench_line(gate_ok=(True, True), route="cuda", launches=3,
                platform="NVIDIA H100 80GB HBM3"):
    eng = {n: {"route": r, "events": 1000, "secs": 1.0, "launches": l,
               "events_per_sec": 1000.0, "top1": 80.0, "oracle_top1": 80.1,
               "gate": 0.1, "gate_tol": 2.0, "gate_ok": ok}
           for n, r, l, ok in (("scan", "scan", 0, gate_ok[0]),
                               ("fused", route, launches, gate_ok[1]))}
    return {"metric": "simulated events/sec (10000x100000 graph)",
            "value": 1000.0, "unit": "events/s", "vs_baseline": 10.0,
            "oracle_events_per_sec": 100.0, "engine": "fused",
            "platform": platform, "engines": eng}


def _fake_bench(monkeypatch, line, rc=0):
    import json
    import subprocess
    import types

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(returncode=rc, stdout=json.dumps(line)
                                     + "\n", stderr="oracle ...\n")
    monkeypatch.setattr(subprocess, "run", run)
    return calls


def test_phase8a_bench_line_is_checked(monkeypatch):
    calls = _fake_bench(monkeypatch, _bench_line())
    line = chip_smoke.bench_run(platform="NVIDIA H100 80GB HBM3")
    assert calls[0][1:3] == ["-m", "redqueen_tpu_torch.bench"]
    assert line["engines"]["fused"]["launches"] == 3


@pytest.mark.parametrize("bad", ["gate", "platform", "route", "rc"])
def test_phase8a_fails_on_a_bad_bench_line(monkeypatch, bad):
    line = _bench_line(gate_ok=(True, False) if bad == "gate" else
                       (True, True), route="plain" if bad == "route"
                       else "cuda")
    _fake_bench(monkeypatch, line, rc=3 if bad == "rc" else 0)
    with pytest.raises(SystemExit):
        chip_smoke.bench_run(platform="cpu" if bad == "platform" else
                             "NVIDIA H100 80GB HBM3")


@pytest.fixture(scope="module")
def config5_small():
    """Phase 8 (b) at a small size on the CPU: a 3-step fit, 8 seeds,
    T = 10, gated against 8 oracle seeds."""
    return chip_smoke.config5_full(
        "cpu", kw=dict(scale=1.0, end_time=10.0, hidden=8, capacity=128),
        n_seeds=8, fit_steps=3, oracle_seeds=8)


def test_phase8b_config5_gated_against_the_oracle(config5_small):
    res, weights = config5_small
    assert res["events"] > 8 * 50 and res["fit_steps"] == 3
    assert res["posts"]["diff"] <= res["posts"]["tol"]
    assert res["top1"]["diff"] <= res["top1"]["tol"]
    assert len(res["losses"]) == 3 and weights["v"]["kernel"].shape == (8, 1)


def test_phase8cdef_on_one_device(config5_small):
    res, weights = config5_small
    c = chip_smoke.config5_cross(weights, "cpu", B=4, end_time=10.0,
                                 capacity=64)
    assert c["lanes_differing"] == 0 and c["events_card"] > 0
    d = chip_smoke.rmtpp_stream_cross(weights, "cpu", n=8, T=10.0, cap=64)
    assert d["counts_differing"] == 0 and d["max_rel"] == 0.0
    e = chip_smoke.config5_npz("cpu", B=4, end_time=10.0, capacity=64,
                               oracle_seeds=8, cross=dict(
                                   B=4, end_time=10.0, capacity=64))
    assert e["events"] > 0 and e["cross"]["lanes_differing"] == 0
    f = chip_smoke.fit_cross(res["losses"], fit_steps=3)
    assert f["max_rel_gap"] == 0.0


def test_phase8f_gate_fails_on_a_diverged_fit():
    from redqueen_tpu_torch.models import rmtpp
    from redqueen_tpu_torch.presets import config5_data

    taus, mask = config5_data()

    _, _, cpu = rmtpp.fit(0, taus, mask, hidden=8, steps=2, device="cpu")
    with pytest.raises(SystemExit):
        chip_smoke.fit_cross(cpu * (1 + 2e-3), fit_steps=2)


# ---- phase 9, the learn path, rehearsed on the CPU at small sizes ----
# On the CPU ``hawkes_pass`` runs its plain version, so the kernel-side
# and the plain side of each comparison agree exactly; the gates
# themselves are checked by feeding them bad inputs.


class _HostEvent:
    """A host stand-in for ``torch.cuda.Event`` (milliseconds between
    two records on the host clock)."""

    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self, *a):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def host_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("device_alone", [True, False])
def test_time_launches_warms_then_times_each_rep(host_events, monkeypatch,
                                                 device_alone):
    import time

    from redqueen_tpu_torch.smoke import common

    slept = []
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: (slept.append(cycles),
                                        time.sleep(0.02)))
    calls = []

    def fn(x, y=0):
        calls.append((x, y))
        return x + y + len(calls)

    dev_ms, host_ms, out = common.time_launches(
        fn, 1, y=2, reps=3, device_alone=device_alone)
    per_rep = 2 if device_alone else 1
    assert calls == [(1, 2)] * (1 + 3 * per_rep) and out == 3 + len(calls)
    assert len(host_ms) == 3 and all(m >= 0 for m in host_ms)
    assert len(dev_ms) == (3 if device_alone else 0)
    assert slept == [common.SLEEP_CYCLES] * len(dev_ms)


def test_time_launches_fails_when_the_host_outlasts_the_sleep(host_events,
                                                              monkeypatch):
    import time

    from redqueen_tpu_torch.smoke import common

    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    with pytest.raises(SystemExit):
        common.time_launches(time.sleep, 0.005)


def test_the_event_kernel_bound_is_the_benchmark_s_least_time():
    """The headline's count (12,300,664 events, 2,303,004 of them Opt
    posts) at the benchmark's own events-only reckoning, a third a
    launch: 0.0314 ms, where counting padded steps gave 0.0353."""
    from portbench import roofline as bench

    hl = {"B": 10_000, "kernel_ms_per_launch": [0.39] * 3,
          "source_events": [2_303_004] + [999_766] * 10,
          "kind_is_opt": [True] + [False] * 10,
          "adj": [[True] * 10] + [[f == s for f in range(10)]
                                  for s in range(10)]}
    b = chip_smoke.event_kernel_bound(hl)
    w = bench.work(hl["kind_is_opt"], hl["adj"], hl["source_events"],
                   hl["B"])
    assert w["events"] == 12_300_664
    assert b["bound_ms"] == pytest.approx(bench.least_s(w) * 1e3 / 3,
                                          rel=1e-12)
    assert b["bound_by"] == "operations"
    assert 0.0314 < b["bound_ms"] < 0.0315


def test_phase9a_pass_parity_on_the_plain_version():
    out = chip_smoke.pass_parity("cpu", small=(5, 300, 128),
                                 wide=(64, 2, 64))
    assert sorted(out) == ["d5_grad", "d5_stats", "d64_grad", "d64_stats"]
    for r in out.values():
        assert r["max_abs_err"] == 0.0
    assert out["d5_stats"]["health"][0] != 0


@pytest.mark.parametrize("bad", ["value", "health", "nan"])
def test_phase9a_gate_fails_on_a_bad_kernel_output(monkeypatch, bad):
    from redqueen_tpu_torch.learn import loglik

    real = loglik.hawkes_pass_plain

    def skewed(*a, **k):
        out = list(real(*a, **k))
        if bad == "value":
            out[2] = out[2] * (1 + 3 * chip_smoke.PASS_RTOL)
        elif bad == "health":
            out[5] = out[5] | 1
        else:
            out[0] = out[0] + float("nan")
        return tuple(out)

    monkeypatch.setattr(loglik, "hawkes_pass", skewed)
    ch = chip_smoke.pass_stream(5, 300, 128, seed=5)
    with pytest.raises(SystemExit):
        chip_smoke.pass_cross("bad", *ch, "cpu", grad=False)


SMALL_WORLD = dict(end_time=200.0, capacity=1024, seed=7)


@pytest.fixture(scope="module")
def recovered():
    """Phase 9 (b) on the CPU with T cut from 600 to 200: both solvers at
    their full iteration counts, "card" and CPU the same device."""
    return chip_smoke.recover("cpu", world=SMALL_WORLD)


def test_phase9b_recover_gates_pass(recovered):
    r = recovered
    assert r["n_events"] > 300 and r["launches"] == 0
    for solver in ("em", "fw"):
        s = r[solver]
        assert s["iters"] <= chip_smoke.RECOVER_ITERS[solver]
        assert all(v == 0.0 for v in s["card_vs_cpu"].values())
        for k, tol in chip_smoke.RECOVER_TOLERANCES.items():
            assert s["errors"][k] <= tol
    assert r["fw"]["sweeps"] == r["fw"]["iters"] + 30


def _fit(**kw):
    from redqueen_tpu_torch.learn.hawkes_mle import HawkesFit

    f = HawkesFit(mu=chip_smoke.WORLD_MU.copy(),
                  alpha=np.diag(chip_smoke.WORLD_ALPHA),
                  beta=chip_smoke.WORLD_BETA.copy(),
                  health=np.zeros(3, np.uint32), loglik=np.zeros(3),
                  final_loglik=-100.0, converged=True, n_iter=3,
                  solver="em", n_events=10, n_dims=3, t_end=1.0,
                  t_start=0.0)
    return f._replace(**kw)


@pytest.mark.parametrize("bad", [
    dict(health=np.array([0, 2, 0], np.uint32)),
    dict(mu=chip_smoke.WORLD_MU * 1.5),
    dict(beta=chip_smoke.WORLD_BETA * 1.7),
    dict(alpha=np.diag(chip_smoke.WORLD_ALPHA) + 0.4 * np.eye(3)),
    dict(final_loglik=-101.5)])
def test_phase9b_recover_gate_fails(bad):
    chip_smoke.recover_check("ok", _fit(), -100.0)
    with pytest.raises(SystemExit):
        chip_smoke.recover_check("bad", _fit(**bad), -100.0)


@pytest.mark.parametrize("field,scale", [("mu", 1.01), ("beta", 0.99),
                                         ("alpha", 1.01),
                                         ("final_loglik", 1.001)])
def test_phase9b_card_against_cpu_gate_fails(field, scale):
    good = _fit()
    chip_smoke.fits_agree("ok", good, good)
    with pytest.raises(SystemExit):
        chip_smoke.fits_agree("bad", _fit(**{field: getattr(good, field)
                                             * scale}), good)


SMALL_CORPUS = dict(seed=7, n_users=400, end_time=20.0, mean_rate=1.0,
                    max_len=64, n_dims=8)


def _reference_corpus_shape():
    """Rows and chunk shape of SMALL_CORPUS through the JAX package's
    own pipeline (its synthetic_twitter, from_traces, chunk_events)."""
    from redqueen_tpu.data import synthetic_twitter
    from redqueen_tpu.learn import ingest

    c = SMALL_CORPUS
    tr = synthetic_twitter(c["seed"], c["n_users"], c["end_time"],
                           mean_rate=c["mean_rate"], max_len=c["max_len"])
    ch = ingest.chunk_events(ingest.from_traces(
        tr, n_dims=c["n_dims"], assign="hash", t_end=c["end_time"]))
    return ch.n_events, tuple(ch.dt.shape)


@pytest.fixture(scope="module")
def corpus_small():
    rows, shape = _reference_corpus_shape()
    return chip_smoke.corpus_fit("cpu", corpus=SMALL_CORPUS, rows=rows,
                                 chunk_shape=shape), rows


def test_phase9c_corpus_fit_and_pass_checks(corpus_small, host_events):
    (res, ch, fit), rows = corpus_small
    assert res["rows"] == rows and res["launches"] == 0
    assert len(res["walls_s"]) == 3 and res["events_per_s_fitted"] > 0
    assert len(res["curve"]) == chip_smoke.CORPUS_ITERS[-1]
    checks = chip_smoke.corpus_pass_checks(ch, fit, "cpu", n_compare=2)
    assert checks["responsibility_gap"] <= 1e-4 * rows
    assert checks["cross"]["max_abs_err"] == 0.0
    b = checks["bound"]
    assert b["ops"] == rows * 8 * 13  # the events the run has, D = 8
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == ("bytes" if b["bytes_ms"] >= b["ops_ms"]
                             else "operations")


@pytest.mark.parametrize("bad", ["rows", "shape", "curve", "health"])
def test_phase9c_corpus_gates_fail(monkeypatch, bad):
    rows, shape = _reference_corpus_shape()
    if bad == "rows":
        rows += 1
    elif bad == "shape":
        shape = (shape[0] * 2, shape[1])
    else:
        real = rt.learn.fit_hawkes

        def skewed(*a, **k):
            f = real(*a, **k)
            if bad == "curve":
                return f._replace(loglik=f.loglik - np.arange(
                    len(f.loglik)) * 0.01 * abs(f.loglik[-1]))
            return f._replace(health=f.health | 2)

        monkeypatch.setattr(rt.learn, "fit_hawkes", skewed)
    with pytest.raises(SystemExit):
        chip_smoke.corpus_fit("cpu", corpus=SMALL_CORPUS, rows=rows,
                              chunk_shape=shape)


def test_phase9c_responsibility_identity_fails_when_broken():
    n = 1000
    ok = (None, torch.full((2, 4), 25.0), torch.full((2, 4, 4), 25.0))
    chip_smoke.responsibilities_identity(ok, n)
    with pytest.raises(SystemExit):
        chip_smoke.responsibilities_identity(
            (None, ok[1], ok[2] * 1.001), n)


# ---- phase 10, the serving path, rehearsed on the CPU at small sizes ----


@pytest.fixture
def no_fault(monkeypatch):
    monkeypatch.delenv("RQ_FAULT", raising=False)


def test_phase10a_serving_bench_accounting(no_fault):
    from redqueen_tpu_torch.smoke import serving as sv

    batches = sv.bench_stream(256, 96)
    a = chip_smoke.serve_bench("cpu", 256, batches)
    at = chip_smoke.serve_bench("cpu", 256, batches, traced=True)
    assert a["digest"] == at["digest"]
    rep = a["report"]
    assert rep["applied"] == 96 and rep["reconciles"]
    assert a["events_per_s"] > 0 and a["latency"]["p50_ms"] is not None
    stages = sv.stage_table(at["breakdown"])
    for name in ("serving.admit", "serving.coalesce", "serving.dispatch",
                 "serving.sync", "serving.ack"):
        assert name in stages
    assert a["durability"]["tier"] == "quorum"


def test_phase10b_apply_bound():
    assert chip_smoke.apply_bound_ms(1_000_000) == pytest.approx(
        20e6 / 3.35e12 * 1e3)


def test_phase10c_invariances_on_the_cpu(no_fault):
    chip_smoke.coalesce_invariance("cpu", n_feeds=128, n_batches=70)
    chip_smoke.width_invariance("cpu", n_feeds=128, n_rounds=3)
    out = chip_smoke.recover_mid_stream("cpu", n_feeds=128, n_batches=70,
                                        close_at=40)
    assert out["replayed"] == 40 and out["recovered_seq"] == 39
    cross = chip_smoke.card_against_cpu("cpu", n_feeds=128, n_batches=64)
    assert cross["near_ties"] == [] and cross["final_digests_equal"]


def test_phase10c_cross_gate_fails_on_a_diverged_decision(monkeypatch):
    """A device whose apply posts where the CPU's does not, far from a
    near-tie, fails the run."""
    from redqueen_tpu_torch.smoke import serving as sv
    from redqueen_tpu_torch.serving import state as sstate

    real = sstate._apply
    calls = []

    def flip(st, *a):
        new, (p, t, lam) = real(st, *a)
        calls.append(1)
        return new, ((~p) if len(calls) % 2 else p, t, lam)

    monkeypatch.setattr(sv.sstate, "_apply", flip)
    with pytest.raises(SystemExit):
        sv.card_against_cpu("cpu", n_feeds=64, n_batches=8)


def test_phase10d_fit_while_serving(no_fault):
    out = chip_smoke.fit_while_serving("cpu", D=8, t_end=300.0)
    assert out["epoch"] == 1 and out["launches"] == 0
    assert max(out["gaps"].values()) == 0.0
