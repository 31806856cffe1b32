"""The port's serving device core and runtime against the JAX package's
``redqueen_tpu.serving`` on the CPU, at the same seeds.

``serving.state``'s apply step against the reference's jitted one (F =
64 and 2,048): each batch applied by both from the same carry, decisions
and digests equal but for counted near-ties (``tests/torch_serving``).
Within the port, bit for bit: the coalesced apply against the sequential
one for every group size K and pad width.  ``poison_edge`` freezes one
edge with the reference's health bits.  The runtime's admission, shed
and reconcile accounting on an overload stream, and its journal (JSONL
and binary), equal to the reference's."""

import os

import numpy as np
import pytest
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu.serving import journal as jjournal
from redqueen_tpu.serving import state as jstate
from redqueen_tpu_torch import serving as T
from redqueen_tpu_torch.serving import journal as tjournal
from redqueen_tpu_torch.serving import state as tstate
from redqueen_tpu_torch.serving.service import _pad_events, _pad_width
from torch_serving import (J, LAM_RTOL, MAX_NEAR_TIE_SHARE, Q_MIXED,
                           assert_decisions_agree, jax_fields, near_tie,
                           no_fault, runtimes, serve)  # noqa: F401

E_MAX = 64


def _stream(F, n=60, epb=16, seed=0):
    return T.synthetic_stream(seed, n, F, events_per_batch=epb)


def _weights(F, seed=1):
    return np.random.RandomState(seed).uniform(0.0, 2.0, F)


# ---------------------------------------------------------------------------
# The apply step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("F,q", [(64, Q_MIXED), (2048, Q_MIXED),
                                 (2048, 1.0)])
def test_apply_matches_the_reference_step_by_step(F, q):
    """Each batch through both packages' apply from the same carry (the
    reference's, carried into the port by ``feed_state_from_numpy``):
    posts, clocks and digests equal but for near-ties, intensities within
    rtol 1e-6."""
    s = _weights(F)
    apply_j = jstate.make_apply_fn()
    st_j = jstate.init_feed_state(F, 7)
    ties = posts = 0
    batches = _stream(F)
    for b in batches:
        t, f, n = _pad_events(b.times, b.feeds, _pad_width(b.n_events,
                                                           E_MAX))
        st_t = rt.feed_state_from_numpy(jax_fields(st_j), device="cpu")
        assert tstate.state_digest(st_t) == jstate.state_digest(st_j)
        new_j, (pj, tj, lj) = apply_j(st_j, t, f, n, np.int32(b.seq),
                                      np.float32(s), np.float32(q))
        new_t, out_t = tstate._apply(st_t, t, f, n, np.int32(b.seq),
                                     s.astype(np.float32), np.float32(q))
        pt, tt, lt = (a[0] for a in tstate.read_decisions(*out_t))
        assert float(tt) == float(tj)
        np.testing.assert_allclose(float(lt), float(lj), rtol=LAM_RTOL)
        posts += bool(pj)
        if bool(pt) != bool(pj):
            assert near_tie(np.asarray(st_j.key), b.seq, lj,
                            float(tj) - float(st_j.t)), b.seq
            ties += 1
        else:
            assert tstate.state_digest(new_t) == jstate.state_digest(new_j)
        st_j = new_j
    assert ties <= MAX_NEAR_TIE_SHARE * len(batches)
    assert 0 < posts


@pytest.mark.parametrize("F,K,k", [(64, 8, 5), (2048, 4, 4)])
def test_apply_many_matches_the_reference(F, K, k):
    """One coalesced group through both packages: posts, clocks, the
    padding slots (posted False, t = the carry's clock, lam 0) and the
    digest."""
    s = _weights(F).astype(np.float32)
    batches = _stream(F, n=k, epb=24)
    E = _pad_width(max(b.n_events for b in batches), E_MAX)
    times = np.zeros((K, E), np.float32)
    feeds = np.zeros((K, E), np.int32)
    nv = np.zeros(K, np.int32)
    seqs = np.zeros(K, np.int32)
    for j, b in enumerate(batches):
        times[j], feeds[j], nv[j] = _pad_events(b.times, b.feeds, E)
        seqs[j] = b.seq
    st_j = jstate.init_feed_state(F, 3)
    new_j, (pj, tj, lj) = jstate.make_coalesced_apply_fn()(
        st_j, times, feeds, nv, seqs, np.int32(k), s, np.float32(Q_MIXED))
    st_t = tstate.init_feed_state(F, 3, device="cpu")
    new_t, out = tstate._apply_many(st_t, times, feeds, nv, seqs, k, s,
                                    np.float32(Q_MIXED))
    pt, tt, lt = tstate.read_decisions(*out)
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_array_equal(tt, np.asarray(tj))
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=LAM_RTOL)
    assert not pt[k:].any() and (lt[k:] == 0).all()
    assert tstate.state_digest(new_t) == jstate.state_digest(new_j)


def test_init_state_and_digest_match_the_reference():
    for F, seed, start in ((1, 0, 0), (64, 5, 17), (2048, 2**31 + 3, 0)):
        assert tstate.state_digest(
            tstate.init_feed_state(F, seed, start_seq=start,
                                   device="cpu")) == \
            jstate.state_digest(jstate.init_feed_state(F, seed,
                                                       start_seq=start))


# ---------------------------------------------------------------------------
# Invariance within the port, bit for bit
# ---------------------------------------------------------------------------


def _port_run(F, coalesce, batches, poll_every=None, **kw):
    r = T.ServingRuntime(F, q=Q_MIXED, s_sink=_weights(F), seed=4,
                         coalesce=coalesce, max_batch_events=E_MAX,
                         queue_capacity=256, device="cpu", **kw)
    _, decs = serve(r, batches, poll_every or max(coalesce, 1))
    return r.state_digest(), decs


@pytest.mark.parametrize("F", [64, 2048])
def test_coalesce_is_bit_identical_across_group_sizes(F):
    """K = 1 (the per-batch path) against K = 2, 5, 32, and groups cut
    by polling at other strides: the same digest and the same decisions,
    intensities to the bit."""
    batches = _stream(F, n=70)
    base_d, base = _port_run(F, 1, batches)
    for K, every in ((2, 2), (5, 3), (32, 32), (32, 7)):
        d, decs = _port_run(F, K, batches, every)
        assert d == base_d, (K, every)
        assert decs == base, (K, every)


def test_coalesce_is_bit_identical_across_widths():
    """The bucketed pow-2 pad widths against the full configured width
    (what replay uses): the same carry and outputs, bit for bit."""
    F = 64
    batches = _stream(F, n=12, epb=5)
    s = _weights(F).astype(np.float32)
    outs = []
    for width in (None, E_MAX, 256):
        st = tstate.init_feed_state(F, 9, device="cpu")
        res = []
        for b in batches:
            E = width or _pad_width(b.n_events, E_MAX)
            t, f, n = _pad_events(b.times, b.feeds, E)
            st, out = tstate._apply(st, t, f, n, np.int32(b.seq), s,
                                    np.float32(Q_MIXED))
            res.append(tuple(a.tobytes() for a in
                             tstate.read_decisions(*out)))
        outs.append((tstate.state_digest(st), res))
    assert outs[0] == outs[1] == outs[2]


def test_runtime_decisions_match_the_reference():
    """Whole runtimes (coalesce 8, bucketed widths) in both packages on
    the same stream: equal decisions and final digest."""
    F = 256
    batches = _stream(F, n=64)
    kw = dict(q=Q_MIXED, s_sink=_weights(F), seed=2, coalesce=8,
              max_batch_events=E_MAX, queue_capacity=128)
    rj, rt_ = runtimes(F, **kw)
    _, dj = serve(rj, batches, 8)
    _, dt = serve(rt_, batches, 8)
    assert_decisions_agree(dj, dt)
    assert rt_.state_digest() == rj.state_digest()
    gj, gt = rj.gather(), rt_.gather()
    for a, b in zip(gj[:2], gt[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert gj[2:] == gt[2:]


# ---------------------------------------------------------------------------
# Edge quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_poison_edge_freezes_one_edge_with_the_reference_bits(mode):
    F = 16
    batches = _stream(F, n=20, epb=12)
    st_j = jstate.poison_edge(jstate.init_feed_state(F, 1), 5, mode)
    st_t = tstate.poison_edge(tstate.init_feed_state(F, 1, device="cpu"),
                              5, mode)
    assert tstate.state_digest(st_t) == jstate.state_digest(st_j)
    apply_j = jstate.make_apply_fn()
    s = np.ones(F, np.float32)
    for b in batches:
        t, f, n = _pad_events(b.times, b.feeds, E_MAX)
        st_j, (pj, _, lj) = apply_j(st_j, t, f, n, np.int32(b.seq), s,
                                    np.float32(Q_MIXED))
        st_t, out = tstate._apply(st_t, t, f, n, np.int32(b.seq), s,
                                  np.float32(Q_MIXED))
        assert np.isfinite(tstate.read_decisions(*out)[2]).all()
    hj = np.asarray(st_j.health)
    ht = tstate.state_to_numpy(st_t)["health"]
    assert np.flatnonzero(ht).tolist() == [5]
    np.testing.assert_array_equal(ht, hj)
    assert tstate.state_digest(st_t) == jstate.state_digest(st_j)


def test_numeric_fault_poisons_the_addressed_edge(monkeypatch):
    monkeypatch.setenv("RQ_FAULT", "numeric:nan@lane3")
    rj, rt_ = runtimes(8, q=Q_MIXED)
    for r in (rj, rt_):
        serve(r, _stream(8, n=6))
    assert rt_.state_digest() == rj.state_digest()
    assert np.flatnonzero(rt_.gather()[1]).tolist() == [3]


def test_poison_edge_rejects_unknown_mode():
    with pytest.raises(ValueError, match="poison mode"):
        tstate.poison_edge(tstate.init_feed_state(4, 0, device="cpu"), 1,
                           "zero")


# ---------------------------------------------------------------------------
# Admission, shed and reconcile accounting
# ---------------------------------------------------------------------------


def _overload(r):
    """Submit 40 batches to a queue of 8 without polling, some out of
    order, some duplicated and one malformed; then drain and retransmit
    what was shed."""
    batches = _stream(r.n_feeds, n=40, epb=6)
    order = batches[:3] + [batches[4], batches[3]] + batches[5:]
    order.insert(10, batches[9])
    bad = T.EventBatch(41, np.array([2.0, 1.0]), np.array([0, 1]))
    adms = [r.submit(b) for b in order] + [r.submit(bad)]
    decs = r.poll()
    adms += [r.submit(b) for b in batches if b.seq > r.applied_seq]
    decs += r.poll()
    return adms, decs


def test_overload_accounting_equals_the_reference():
    kw = dict(q=Q_MIXED, queue_capacity=8, reorder_window=4, coalesce=4,
              max_batch_events=E_MAX)
    rj, rt_ = runtimes(24, **kw)
    aj, dj = _overload(rj)
    at, dt = _overload(rt_)
    assert [(a.status, a.seq, a.backpressure, a.missing) for a in at] == \
        [(a.status, a.seq, a.backpressure, a.missing) for a in aj]
    assert any(a.status == "shed" for a in at)
    assert_decisions_agree(dj, dt)
    keys = ("ingested", "applied", "shed", "rejected", "duplicates",
            "reordered", "reconciles", "shed_seqs")
    mj = rj.metrics.report(pending=rj.pending)
    mt = rt_.metrics.report(pending=rt_.pending)
    assert {k: mt[k] for k in keys} == {k: mj[k] for k in keys}
    assert mt["reconciles"]


def test_decide_serves_stale_while_the_backlog_grows():
    r = T.ServingRuntime(8, q=Q_MIXED, device="cpu")
    assert r.decide() is None
    batches = _stream(8, n=5)
    r.submit(batches[0])
    r.poll()
    for b in batches[1:]:
        r.submit(b)
    d = r.decide()
    assert d.seq == 0 and d.stale_batches == 4
    assert r.metrics.stale_decisions == 1


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,coalesce", [(None, 1), (None, 4),
                                          ("binary", 4)])
def test_journal_records_equal_the_reference(tmp_path, fmt, coalesce):
    """Both packages journal the same stream; each package's replay of
    each directory gives the reference's records: seq, times, feeds and
    post exact, intensity within rtol 1e-6, digests equal."""
    F = 32
    batches = _stream(F, n=24, epb=7)
    kw = dict(q=Q_MIXED, coalesce=coalesce, journal_format=fmt,
              snapshot_every=10 ** 6, max_batch_events=E_MAX)
    dirs = [str(tmp_path / "jax"), str(tmp_path / "torch")]
    for d, r in zip(dirs, (J.ServingRuntime(F, dir=dirs[0], **kw),
                           T.ServingRuntime(F, dir=dirs[1], device="cpu",
                                            **kw))):
        with r:
            serve(r, batches, coalesce)
    path = lambda d: os.path.join(d, T.journal.JOURNAL_FILENAME)  # noqa
    rec_j, _ = jjournal.replay(path(dirs[0]), quarantine_torn_tail=False)
    for d in dirs:
        for replay in (jjournal.replay, tjournal.replay):
            recs, torn = replay(path(d), quarantine_torn_tail=False)
            assert torn is None and len(recs) == len(rec_j)
            for a, b in zip(rec_j, recs):
                assert a["state_digest"] == b["state_digest"]
                for k in ("seq", "seqs", "counts", "times", "feeds"):
                    assert np.array_equal(a.get(k, []), b.get(k, [])), k
                da = a["decisions"] if "decisions" in a else [a["decision"]]
                db = b["decisions"] if "decisions" in b else [b["decision"]]
                assert [x["post"] for x in da] == [x["post"] for x in db]
                assert [x["post_time"] for x in da] == \
                    [x["post_time"] for x in db]
                np.testing.assert_allclose(
                    [x["intensity"] for x in db],
                    [x["intensity"] for x in da], rtol=LAM_RTOL)
    dj = J.journal_decisions(dirs[0])
    assert_decisions_agree(dj, T.journal_decisions(dirs[1]))
    assert_decisions_agree(dj, T.journal_decisions(dirs[0]))


def test_install_carry_and_range_roundtrip(tmp_path):
    """The carry seams the cluster layer drives: ``install_carry`` of
    a migrated carry, ``extract_range``/``install_range`` (journaled and
    digest-asserted), and replay of the range record."""
    F = 12
    src = T.ServingRuntime(F, q=Q_MIXED, device="cpu")
    serve(src, _stream(F, n=8, epb=9))
    idx = [1, 4, 7]
    r, h = src.extract_range(idx)
    dst = T.ServingRuntime(F, q=Q_MIXED, dir=str(tmp_path), seed=3,
                           device="cpu")
    dst.install_carry(tstate.init_feed_state(F, 3, start_seq=0,
                                             device="cpu"))
    from redqueen_tpu_torch.serving.topology import range_digest \
        as _range_digest
    feeds = [101, 104, 107]
    dst.install_range(idx, r, h, feeds=feeds, topo_epoch=1,
                      digest=_range_digest(feeds, r, h), plan_id="p",
                      range_id=0)
    got_r, got_h = dst.extract_range(idx)
    np.testing.assert_array_equal(got_r, r)
    with pytest.raises(RuntimeError, match="digest mismatch"):
        dst.install_range(idx, r + 1, h, feeds=feeds, topo_epoch=2,
                          digest=_range_digest(feeds, r, h), plan_id="p",
                          range_id=1)
    serve(dst, _stream(F, n=4, epb=5))
    want = dst.state_digest()
    dst.close()
    rec, info = T.recover(str(tmp_path), device="cpu")
    assert rec.state_digest() == want and info.replayed == 4
    rec.close()


def test_metrics_artifact_and_durability(tmp_path):
    r = T.ServingRuntime(8, q=Q_MIXED, dir=str(tmp_path), coalesce=4,
                         flush_mode="group", device="cpu")
    with r:
        serve(r, _stream(8, n=9), 4)
        rep = r.write_metrics()
    assert rep["applied"] == 9 and rep["reconciles"]
    assert rep["durability"]["flush_mode"] == "group"
    assert rep["health_sick_edges"] == 0
    assert os.path.exists(os.path.join(str(tmp_path), "metrics.json"))


def test_runtime_refuses_a_mismatched_directory(tmp_path):
    T.ServingRuntime(8, dir=str(tmp_path), device="cpu").close()
    with pytest.raises(ValueError, match="n_feeds"):
        T.ServingRuntime(9, dir=str(tmp_path), device="cpu")


def test_carry_lives_on_the_asked_device():
    r = T.ServingRuntime(4, device="cpu")
    assert r.carry.rank.device == torch.device("cpu")
    assert r.carry.health.dtype == torch.int32
    assert r.carry.key.dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.ServingRuntime(4)
