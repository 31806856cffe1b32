"""The reference agrees with the port's CPU paths at a small size, and
its lower precision (the control) does not."""

import os

import numpy as np
import pytest

import redqueen_tpu_torch as rt
from portbench.drivers import serve
from portbench.reference import serving as rserve
from portbench.reference import sim as ref
from portbench.reference.threefry import threefry2x32

COMP = dict(followers=10, wall_rate=1.0, q=1.0, s_sink=1.0, end_time=20.0)


def test_threefry_known_answer():
    """Salmon et al.'s known-answer vector for threefry-2x32, 20 rounds:
    key and counter all ones -> (0x1cb996fc, 0xbb002be7)."""
    m = 0xFFFFFFFF
    w0, w1 = threefry2x32(m, m, m, m)
    assert (int(w0), int(w1)) == (0x1CB996FC, 0xBB002BE7)


def _port_log(engine, B, seeds):
    cap, mc = rt.shape_budget(10, COMP["end_time"], 1.0)
    gb = rt.GraphBuilder(n_sinks=10, end_time=COMP["end_time"])
    opt = gb.add_opt(q=1.0)
    for f in range(10):
        gb.add_poisson(rate=1.0, sinks=[f])
    cfg, p0, a0 = gb.build(capacity=cap, device="cpu")
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    log = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                            engine=engine, device="cpu")
    m = rt.feed_metrics_batch(log.times, log.srcs, adj, opt,
                              COMP["end_time"])
    return (log.times.numpy(), log.srcs.numpy(), log.n_events.numpy(),
            m.mean_time_in_top_k().numpy(),
            rt.num_posts(log.srcs, opt).numpy())


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_reference_follows_the_port(engine):
    B = 12
    seeds = (np.arange(B) + 2 ** 32 - 5) % 2 ** 32
    times, srcs, nev, top1, posts = _port_log(engine, B, seeds)
    comp = ref.headline_component(COMP)
    gap = ref.check_events(comp, ref.draws_for(engine, seeds, comp.S),
                           times, srcs, nev)
    assert gap.max() < 1e-5
    r_top1, r_posts = ref.feed_metrics(comp, times, srcs, nev)
    assert np.abs(top1 - r_top1).max() < 1e-4
    assert np.array_equal(posts, r_posts)
    # Run free in float32, the reference gives logs the same check
    # passes; in bfloat16 (the control) it does not.
    for precision, ok in (("float32", True), ("bfloat16", False)):
        ft, fs, fn = ref.simulate(comp, ref.draws_for(engine, seeds, comp.S),
                                  B, precision, 1024)
        g = ref.check_events(comp, ref.draws_for(engine, seeds, comp.S),
                             ft, fs, fn)
        assert (g.max() < 1e-5) == ok


def test_check_catches_a_wrong_draw_stream():
    B = 6
    seeds = np.arange(B) + 3
    times, srcs, nev, _, _ = _port_log("fused", B, seeds)
    comp = ref.headline_component(COMP)
    gap = ref.check_events(comp, ref.draws_for("scan", seeds, comp.S),
                           times, srcs, nev)
    assert gap.min() > 1e-3


def test_serving_reference_matches_the_runtime(tmp_path):
    """Decisions, carry and journal of the port's runtime on the CPU at
    the configuration's settings against the reference."""
    from redqueen_tpu_torch import serving
    from redqueen_tpu_torch.serving.state import state_to_numpy

    F, key = 128, 2 ** 32 - 3
    batches = serve.stream(11, 160, F, 64.0, 1.0)
    d = str(tmp_path / "s")
    rt_ = serving.ServingRuntime(
        F, q=1.0, s_sink=np.ones(F), seed=key, dir=d, device="cpu",
        snapshot_every=10 ** 9, queue_capacity=64, reorder_window=8,
        max_batch_events=256, coalesce=32, flush_mode="group",
        max_unflushed_records=64, max_flush_delay_ms=25.0,
        journal_format="binary", replication_factor=2,
        replication_quorum=1)
    got = []
    for i, (seq, t, f) in enumerate(batches):
        rt_.submit(serving.EventBatch(seq, t, f))
        if i % 5 == 4:
            got += rt_.poll()
    got += rt_.poll()
    carry = state_to_numpy(rt_.carry)
    rt_.close()
    want, r_carry = rserve.apply_stream(batches, F, 1.0, 1.0, key)
    assert [d_.seq for d_ in got] == list(range(160))
    assert np.array_equal([d_.post for d_ in got], want[:, 1] != 0)
    assert np.array_equal([d_.post_time for d_ in got], want[:, 2])
    assert np.array_equal([d_.intensity for d_ in got], want[:, 3])
    assert np.array_equal(carry["rank"], r_carry["rank"])
    assert float(carry["t"]) == r_carry["t"]
    assert int(carry["n_posts"]) == r_carry["n_posts"]
    for path in (os.path.join(d, "journal.jsonl"),
                 os.path.join(d, "replicas", "replica0", "journal.jsonl"),
                 os.path.join(d, "replicas", "replica1", "journal.jsonl")):
        j = rserve.read_journal(path)
        assert sorted(j) == list(range(160))
        for seq, t, f in batches:
            assert np.array_equal(j[seq][0], t)
            assert np.array_equal(j[seq][1], f)
        records = [j[seq][3] for seq in range(160)]
        assert records[0] == 1
        assert all(0 <= b - a <= 1 for a, b in zip(records, records[1:]))
    bf, _ = rserve.apply_stream(batches, F, 1.0, 1.0, key, "bfloat16")
    assert np.abs(bf[:, 2] - want[:, 2]).max() > 0
