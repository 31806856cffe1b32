"""The port's lane layer (``redqueen_tpu_torch/parallel/lanes.py``) on the
CPU: bucketed ragged dispatch bit-identical per lane to the dense-padded
plan (``max_buckets=1``) on both engines, and equal to the JAX package's
``simulate_ragged`` at the same seeds (``jax_threefry_partitionable``
pinned to True); the autotune cache's schema, its own backend names and
a torn file; ``slab=`` equal to the unslabbed run; fault addressing
through the bucket reordering; the pad-waste telemetry.

Tolerances: the port against itself bit for bit.  Against JAX:
``srcs``, ``n_events``, posts and health identical, ``times`` within
rtol 1e-6, time-in-top-1 within rtol 1e-5."""

import json

import numpy as np
import pytest
import torch

from redqueen_tpu.parallel import lanes as jlanes
from redqueen_tpu_torch import GraphBuilder, simulate, simulate_batch, \
    stack_components
from redqueen_tpu_torch.parallel import lanes
from redqueen_tpu_torch.runtime import faultinject, telemetry
from torch_parity import autotune_cache, partitionable  # noqa: F401,E501  (autouse fixtures)

COUNTS = np.array([1, 2, 3, 9, 17, 5, 33, 2, 64, 31])
# The event kernel takes at most MAX_S = 32 sources (width 16 + the Opt
# row fits, width 32 does not).
FUSED_COUNTS = np.minimum(COUNTS, 16)
SEEDS = np.arange(len(COUNTS)) + 7
T = 6.0


def _ragged(engine="scan", max_buckets=3, **kw):
    counts = FUSED_COUNTS if engine == "fused" else COUNTS
    return lanes.simulate_ragged(
        counts, SEEDS, end_time=T, q=1.0, wall_rate=1.0, engine=engine,
        max_buckets=max_buckets, return_logs=True, device="cpu", **kw)


@pytest.fixture(scope="module")
def dense_scan():
    return _ragged("scan", max_buckets=1)


# ---------------------------------------------------------------------------
# Plans (host arithmetic, the same as JAX's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_buckets", [1, 2, 3, 8])
def test_plan_buckets_equals_jax(max_buckets):
    pt = lanes.plan_buckets(COUNTS, max_buckets=max_buckets)
    pj = jlanes.plan_buckets(COUNTS, max_buckets=max_buckets)
    assert pt.widths == pj.widths
    np.testing.assert_array_equal(pt.lane_bucket, pj.lane_bucket)
    assert pt.pad_frac_bucketed == pj.pad_frac_bucketed
    assert pt.padded_elem_reduction == pj.padded_elem_reduction


def test_widths_tiles_and_slab_sizes():
    assert [lanes.bucket_width(n) for n in (1, 3, 64, 65)] == [1, 4, 64, 128]
    assert lanes.bucket_width(3, floor=16) == 16
    with pytest.raises(ValueError, match="exceeds the cap"):
        lanes.bucket_width(200, cap=128)
    assert [lanes.pad_to_tile(n, 128) for n in (1, 128, 129)] == \
        [128, 128, 256]
    assert lanes.slab_size(10_000, 3000) == 2500
    assert lanes.slab_size(9973, 2500) == 9973
    assert list(lanes.iter_slabs(10, 4)) == [(0, 4), (4, 8), (8, 10)]
    assert lanes.shape_budget(16, 100.0, 1.0) == \
        jlanes.shape_budget(16, 100.0, 1.0)
    with pytest.raises(ValueError, match="non-empty"):
        lanes.plan_buckets([])


# ---------------------------------------------------------------------------
# The bit-identity contract, and parity with JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_bucketed_bit_identical_to_dense(engine, dense_scan):
    rb = _ragged(engine, max_buckets=3)
    rd = dense_scan if engine == "scan" else _ragged(engine, max_buckets=1)
    assert rb.engine == ("scan" if engine == "scan" else "plain")
    for f in ("n_events", "top_k", "posts", "health"):
        np.testing.assert_array_equal(getattr(rb, f), getattr(rd, f))
    for i, ((tb, sb), (td, sd)) in enumerate(zip(rb.logs, rd.logs)):
        assert np.array_equal(tb.view(np.int32), td.view(np.int32)), i
        assert np.array_equal(sb, sd), i
    assert (rb.health == 0).all()
    assert rb.plan.pad_frac_bucketed < rd.plan.pad_frac_dense


def test_ragged_matches_jax(dense_scan):
    rj = jlanes.simulate_ragged(COUNTS, SEEDS, end_time=T, q=1.0,
                                wall_rate=1.0, max_buckets=1,
                                return_logs=True)
    np.testing.assert_array_equal(dense_scan.n_events, rj.n_events)
    np.testing.assert_array_equal(dense_scan.posts, rj.posts)
    np.testing.assert_array_equal(dense_scan.health, rj.health)
    np.testing.assert_allclose(dense_scan.top_k, rj.top_k, rtol=1e-5)
    for (tt, st), (tj, sj) in zip(dense_scan.logs, rj.logs):
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_allclose(tt, tj, rtol=1e-6, atol=0)


def test_ragged_lane_equals_unpadded_graphbuilder(dense_scan):
    rb = _ragged("scan", max_buckets=3)
    for lane in (0, 4, 8):
        F = int(COUNTS[lane])
        width = rb.plan.widths[rb.plan.lane_bucket[lane]]
        cap = lanes.shape_budget(width, T, 1.0, None)[0]
        gb = GraphBuilder(n_sinks=F, end_time=T)
        gb.add_opt(q=1.0)
        for i in range(F):
            gb.add_poisson(rate=1.0, sinks=[i])
        cfg, p0, a0 = gb.build(capacity=cap, device="cpu")
        log = simulate(cfg, p0, a0, int(SEEDS[lane]), device="cpu")
        ne = int(log.n_events)
        assert ne == rb.n_events[lane]
        t, s = rb.logs[lane]
        assert np.array_equal(log.times[:ne].numpy(), t)
        assert np.array_equal(log.srcs[:ne].numpy(), s)


def test_memory_ceiling_takes_remainder_slabs():
    counts, seeds = np.full(7, 6), np.arange(7) + 2
    small = lanes.simulate_ragged(counts, seeds, end_time=3.0,
                                  max_lane_elems=8 * 8 * 2, device="cpu")
    big = lanes.simulate_ragged(counts, seeds, end_time=3.0, device="cpu")
    assert small.dispatches >= 4
    np.testing.assert_array_equal(small.n_events, big.n_events)
    np.testing.assert_array_equal(small.top_k, big.top_k)


@pytest.mark.parametrize("max_buckets", [1, 3])
def test_health_bits_flow_through_bucket_reordering(max_buckets, monkeypatch,
                                                    dense_scan):
    monkeypatch.setenv(faultinject.ENV_FAULT, "numeric:nan@lane4")
    r = lanes.simulate_ragged(COUNTS, SEEDS, end_time=T,
                              max_buckets=max_buckets, device="cpu")
    assert list(np.flatnonzero(r.health != 0)) == [4]
    keep = np.arange(len(COUNTS)) != 4
    np.testing.assert_array_equal(r.n_events[keep], dense_scan.n_events[keep])
    np.testing.assert_array_equal(r.top_k[keep], dense_scan.top_k[keep])


def test_numeric_scope_translates_and_gates_chunks(monkeypatch):
    monkeypatch.setenv(faultinject.ENV_FAULT, "numeric:inf@lane5,chunk2")
    assert faultinject.active_numeric_lane(10) is None
    with faultinject.numeric_scope(chunk=2, lane_base=3):
        assert faultinject.active_numeric_lane(10) == (2, "inf")
        assert faultinject.numeric_scope_ctx() == (2, 3)
    with faultinject.numeric_scope(chunk=1):
        assert faultinject.active_numeric_lane(10) is None


# ---------------------------------------------------------------------------
# Slabs and the autotune cache
# ---------------------------------------------------------------------------


def test_slabbed_dispatch_bit_identical():
    gb = GraphBuilder(n_sinks=10, end_time=T)
    gb.add_opt(q=1.0)
    for i in range(10):
        gb.add_poisson(rate=1.0, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=64, device="cpu")
    B = 12
    params, adj = stack_components([p0] * B, [a0] * B)
    seeds = np.arange(B) + 100
    full = simulate_batch(cfg, params, adj, seeds, device="cpu")
    slabbed = simulate_batch(cfg, params, adj, seeds, slab=5, device="cpu")
    assert torch.equal(full.n_events, slabbed.n_events)
    for i in range(B):
        n = int(full.n_events[i])
        assert torch.equal(full.times[i, :n], slabbed.times[i, :n])
        assert torch.equal(full.srcs[i, :n], slabbed.srcs[i, :n])
    assert slabbed.chunk_steps >= slabbed.times.shape[-1]


def test_autotuner_measures_caches_and_reuses(tmp_path):
    path = str(tmp_path / "autotune.json")
    calls = []

    def time_fn(slab):
        calls.append(slab)
        return {4: 0.5, 6: 0.2, 12: 0.9}[slab]

    backend = lanes.backend_name("cpu")
    assert backend == "torch.cpu"
    ch = lanes.measured_slab(12, backend=backend, shape_key="t",
                             time_fn=time_fn, candidates=(4, 6, 12),
                             cache_path=path)
    assert ch.source == "measured" and ch.slab == 6
    obj = json.load(open(path))
    assert obj["schema"] == lanes.AUTOTUNE_SCHEMA == jlanes.AUTOTUNE_SCHEMA
    assert set(obj["entries"]["torch.cpu|t"]["per_lane_cost"]) == \
        {"4", "6", "12"}
    ch2 = lanes.measured_slab(12, backend=backend, shape_key="t",
                              time_fn=time_fn, candidates=(4, 6, 12),
                              cache_path=path)
    assert ch2.source == "cache" and len(calls) == 3
    ch3 = lanes.measured_slab(12, backend=backend, shape_key="t",
                              time_fn=time_fn, candidates=(4, 6, 12),
                              cache_path=path, force=True)
    assert ch3.source == "measured" and len(calls) == 6


def test_autotune_ignores_jax_entries_torn_and_foreign_files(tmp_path,
                                                             monkeypatch):
    path = str(tmp_path / "autotune.json")
    # an entry the JAX package measured on its "cpu" backend is not read
    json.dump({"schema": lanes.AUTOTUNE_SCHEMA,
               "entries": {"cpu|ragged/W4": {"target": 3}}}, open(path, "w"))
    monkeypatch.setenv(lanes.ENV_AUTOTUNE_PATH, path)
    assert lanes.autotune_cache_path() == path
    ch = lanes.measured_slab(10_000, backend=lanes.backend_name("cpu"),
                             shape_key="ragged/W4")
    assert ch.source == "fallback"
    with open(path, "w") as f:
        f.write('{"schema": "rq.other/9", "entries": {"cpu|t": ')
    assert lanes.load_autotune_cache(path) == {}
    json.dump({"schema": "rq.other/9", "entries": {"cpu|t": {}}},
              open(path, "w"))
    assert lanes.load_autotune_cache(path) == {}
    monkeypatch.delenv(lanes.ENV_AUTOTUNE_PATH)
    assert "redqueen_tpu_torch" in lanes.autotune_cache_path()
    ch = lanes.measured_slab(8, backend="torch.cpu", shape_key="x",
                             candidates=(1250, 2500, 5000), cache_path=path)
    assert ch.source == "unslabbed" and ch.slab == 8


def test_probe_slab_cost_is_per_lane_seconds():
    class Log:
        n_events = torch.tensor([1, 2])

    cost = lanes.probe_slab_cost(lambda: Log(), 2)
    assert 0.0 <= cost < 1.0


# ---------------------------------------------------------------------------
# Pad-waste telemetry
# ---------------------------------------------------------------------------


def test_ragged_dispatch_records_pad_counters():
    tel = telemetry.get()
    tel.configure(enabled=True, reset=True)
    try:
        r = lanes.simulate_ragged(COUNTS, SEEDS, end_time=1.0, max_buckets=3,
                                  device="cpu")
        counters = tel.payload()["counters"]
        assert counters["lanes.pad.real_elems"] == r.plan.real_elems
        assert counters["lanes.pad.padded_elems"] == \
            r.plan.bucketed_elems - r.plan.real_elems
        names = {s["name"] for s in tel.drain_spans()}
        assert {"lanes.ragged", "lanes.ragged.bucket",
                "lanes.bucket_plan"} <= names
    finally:
        tel.configure(enabled=False, reset=True)
    assert telemetry.span("x") is telemetry.NULL_SPAN
