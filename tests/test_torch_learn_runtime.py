"""The runtime pieces the port's fits use, against the JAX package's:
checksummed envelopes (``runtime.integrity``) read across packages,
atomic artifacts, preemption, the supervisor's heartbeat, and the
checkpointed resume of ``models.rmtpp.fit`` (mirroring
``tests/test_learn.py::TestRmtppCheckpoint``: bit-identical on the CPU).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from redqueen_tpu.runtime import integrity as jint
from redqueen_tpu.runtime import preempt as jpreempt
from redqueen_tpu_torch.learn import ckpt as tckpt
from redqueen_tpu_torch.models import rmtpp as TR
from redqueen_tpu_torch.runtime import artifacts as tart
from redqueen_tpu_torch.runtime import integrity as tint
from redqueen_tpu_torch.runtime import preempt as tpreempt
from redqueen_tpu_torch.runtime import supervisor as tsup

PAYLOAD = {"a": [1, 2.5, None], "b": {"c": "x"}}


def _arrays():
    rng = np.random.RandomState(0)
    return {"mu": rng.rand(3), "alpha": rng.rand(3, 3).astype(np.float32),
            "health": np.array([0, 2, 0], np.uint32)}


@pytest.mark.parametrize("writer,reader", [(jint, tint), (tint, jint),
                                           (tint, tint)],
                         ids=["jax->torch", "torch->jax", "torch->torch"])
def test_envelopes_cross_packages(tmp_path, writer, reader):
    pj, pz = str(tmp_path / "a.json"), str(tmp_path / "a.npz")
    writer.write_json(pj, PAYLOAD, schema="rq.test/1")
    assert reader.read_json(pj, schema="rq.test/1") == PAYLOAD
    writer.savez(pz, schema="rq.test/1", **_arrays())
    got = reader.load_npz(pz, schema="rq.test/1")
    assert sorted(got) == sorted(_arrays())
    for k, v in _arrays().items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    env = writer.make_envelope(PAYLOAD, schema="rq.test/1")
    assert reader.verify_envelope(env, schema="rq.test/1") == PAYLOAD


@pytest.mark.parametrize("writer,reader", [(jint, tint), (tint, jint)],
                         ids=["jax->torch", "torch->jax"])
def test_corruption_quarantined_across_packages(tmp_path, writer, reader):
    p = str(tmp_path / "a.npz")
    writer.savez(p, schema="rq.test/1", **_arrays())
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(reader.CorruptArtifactError) as ei:
        reader.load_npz(p, schema="rq.test/1")
    assert not os.path.exists(p)
    assert os.path.exists(ei.value.quarantined_to)
    rep = reader.read_json(ei.value.report_path,
                           schema="rq.quarantine-report/1")
    assert rep["original"] == os.path.abspath(p)
    # a schema mismatch can stay on disk (stale is not corrupt)
    q = str(tmp_path / "b.npz")
    writer.savez(q, schema="rq.test/1", **_arrays())
    with pytest.raises(reader.CorruptArtifactError, match="schema"):
        reader.load_npz(q, schema="rq.other/1",
                        quarantine_schema_mismatch=False)
    assert os.path.exists(q)
    # a JSON file without an envelope is corruption unless allowed
    r = str(tmp_path / "c.json")
    open(r, "w").write(json.dumps(PAYLOAD))
    assert tint.read_json(r, allow_unverified=True) == PAYLOAD
    with pytest.raises(tint.CorruptArtifactError, match="no integrity"):
        tint.read_json(r)


def test_fit_checkpoints_cross_packages(tmp_path):
    from redqueen_tpu.learn import ckpt as jckpt

    fp = tckpt.fingerprint_arrays({"x": 1}, np.arange(5), np.ones(2))
    assert fp == jckpt.fingerprint_arrays({"x": 1}, np.arange(5),
                                          np.ones(2))
    for save, load in ((tckpt.save_fit, jckpt.load_fit),
                       (jckpt.save_fit, tckpt.load_fit)):
        p = str(tmp_path / "fit.npz")
        save(p, fp, 7, _arrays(), meta={"solver": "em"})
        step, arrays, meta = load(p, fp)
        assert step == 7 and meta == {"solver": "em"}
        np.testing.assert_array_equal(arrays["alpha"], _arrays()["alpha"])
        assert load(p, "another") is None
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_fit(p, fp, 1, {"fit_meta": np.zeros(1)})


def test_atomic_artifacts(tmp_path):
    p = str(tmp_path / "lines.txt")
    tart.atomic_write_lines(p, (f"{i}\n" for i in range(1000)))
    assert open(p).read().splitlines()[-1] == "999"
    z = str(tmp_path / "z.npz")
    tart.atomic_savez(z, a=np.arange(4))
    assert os.path.exists(z) and not os.path.exists(z + ".npz")
    with np.load(z) as f:
        np.testing.assert_array_equal(f["a"], np.arange(4))
    assert sorted(os.listdir(tmp_path)) == ["lines.txt", "z.npz"]


def test_preempt_guard_and_flush():
    flushed = []

    def flush():
        flushed.append(1)

    tpreempt.reset()
    tpreempt.register_flush(flush)
    try:
        tpreempt.check_preempt("nothing pending")
        with tpreempt.preemption_guard(log=None):
            os.kill(os.getpid(), signal.SIGTERM)
            assert tpreempt.preempt_requested()
            with pytest.raises(tpreempt.PreemptedError) as ei:
                tpreempt.check_preempt("the test")
        assert ei.value.signum == signal.SIGTERM
        assert "during the test" in str(ei.value)
        assert flushed == [1]
    finally:
        tpreempt.unregister_flush(flush)
        tpreempt.reset()
    # the two packages' registries are separate, their messages equal
    assert not jpreempt.preempt_requested()
    with tpreempt.preemption_guard(log=None):
        pass
    assert not tpreempt.preempt_requested()


def test_heartbeat(tmp_path, monkeypatch):
    monkeypatch.delenv(tsup.ENV_HEARTBEAT, raising=False)
    tsup.heartbeat()  # unsupervised: a no-op
    hb = tmp_path / "hb"
    monkeypatch.setenv(tsup.ENV_HEARTBEAT, str(hb))
    tsup.heartbeat()
    assert float(hb.read_text()) > 0
    assert tsup.ENV_HEARTBEAT == "RQ_HEARTBEAT_FILE"


class TestRmtppCheckpoint:
    def _data(self):
        rng = np.random.RandomState(2)
        return rng.exponential(1.0, (4, 6)), np.ones((4, 6), bool)

    def test_fit_resume_bit_identical(self, tmp_path):
        taus, mask = self._data()
        p = str(tmp_path / "rmtpp.npz")
        kw = dict(hidden=4, device="cpu")
        TR.fit(0, taus, mask, steps=10, ckpt_path=p, ckpt_every=5, **kw)
        w_b, st_b, losses_b = TR.fit(0, taus, mask, steps=30, ckpt_path=p,
                                     ckpt_every=5, **kw)
        w_c, st_c, losses_c = TR.fit(0, taus, mask, steps=30, **kw)
        assert len(losses_b) == 30
        np.testing.assert_array_equal(losses_b, losses_c)
        leaves_b, leaves_c = [], []
        TR._flatten((w_b, st_b), leaves_b)
        TR._flatten((w_c, st_c), leaves_c)
        assert len(leaves_b) == len(leaves_c) > 10
        for lb, lc in zip(leaves_b, leaves_c):
            assert torch.equal(lb, lc)
        assert st_b["count"] == st_c["count"] == 30

    def test_different_key_restarts_not_reuses(self, tmp_path):
        taus, mask = self._data()
        p = str(tmp_path / "rmtpp.npz")
        TR.fit(0, taus, mask, hidden=4, steps=10, ckpt_path=p,
               ckpt_every=5, device="cpu")
        _, _, l1 = TR.fit(1, taus, mask, hidden=4, steps=10, ckpt_path=p,
                          ckpt_every=5, device="cpu")
        _, _, l2 = TR.fit(1, taus, mask, hidden=4, steps=10, device="cpu")
        np.testing.assert_array_equal(l1, l2)

    def test_stale_hyperparams_restart(self, tmp_path):
        taus, mask = self._data()
        p = str(tmp_path / "rmtpp.npz")
        TR.fit(0, taus, mask, hidden=4, steps=10, ckpt_path=p,
               ckpt_every=5, device="cpu")
        _, _, losses = TR.fit(0, taus, mask, hidden=4, steps=8, lr=5e-3,
                              ckpt_path=p, ckpt_every=5, device="cpu")
        assert len(losses) == 8
        # a smaller budget returns the stored, further-trained state
        _, _, longer = TR.fit(0, taus, mask, hidden=4, steps=4,
                              ckpt_path=p, ckpt_every=5, lr=5e-3,
                              device="cpu")
        assert len(longer) == 8

    def test_custom_optimizer_resumes(self, tmp_path):
        taus, mask = self._data()
        p = str(tmp_path / "rmtpp.npz")

        def sgd(params):
            return torch.optim.SGD(params, lr=1e-2, momentum=0.9)

        kw = dict(hidden=4, optimizer=sgd, device="cpu")
        TR.fit(0, taus, mask, steps=6, ckpt_path=p, ckpt_every=3, **kw)
        _, _, lb = TR.fit(0, taus, mask, steps=12, ckpt_path=p,
                          ckpt_every=3, **kw)
        _, _, lc = TR.fit(0, taus, mask, steps=12, **kw)
        np.testing.assert_array_equal(lb, lc)

    def test_preempt_after_a_save(self, tmp_path):
        taus, mask = self._data()
        p = str(tmp_path / "rmtpp.npz")
        tpreempt.reset()
        try:
            with tpreempt.preemption_guard(log=None):
                os.kill(os.getpid(), signal.SIGTERM)
                with pytest.raises(tpreempt.PreemptedError,
                                   match="rmtpp.fit step 5"):
                    TR.fit(0, taus, mask, hidden=4, steps=20, ckpt_path=p,
                           ckpt_every=5, device="cpu")
        finally:
            tpreempt.reset()
        _, _, resumed = TR.fit(0, taus, mask, hidden=4, steps=20,
                               ckpt_path=p, ckpt_every=5, device="cpu")
        _, _, whole = TR.fit(0, taus, mask, hidden=4, steps=20,
                             device="cpu")
        np.testing.assert_array_equal(resumed, whole)
