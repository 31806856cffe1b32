"""The port's ``sweep.run_sweep_checkpointed`` (with ``_heal_sick_lanes``
and ``_chunk_fingerprint``): the checkpoint cases of
``tests/test_sweep.py`` and the SIGTERM-mid-sweep resume of
``tests/test_runtime.py``, on the port, and against the JAX package.

Tolerances: a checkpointed sweep against the port's own one-dispatch
sweep, resumed, healed or recomputed, is bit-identical.  Against the JAX
package's sweep at the same points and seeds (scan engine), the
tolerance ``tests/test_torch_sweep.py`` states: ``n_posts`` and
``health`` identical, the float grids within rtol 1e-5.

The scan engine's events do not depend on the chunk capacity, only its
cost does, so these components use a small one."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import redqueen_tpu as J
from redqueen_tpu import sweep as jsweep
import redqueen_tpu_torch as rt
import redqueen_tpu_torch.sweep as sweep_mod
from redqueen_tpu_torch.parallel import bigf as TB
from redqueen_tpu_torch.runtime import faultinject, integrity
from redqueen_tpu_torch.sweep import (run_sweep, run_sweep_checkpointed,
                                      run_sweep_star)
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


def q_points(pkg, q_grid, F=3, T=12.0, capacity=64, **kw):
    pts = []
    for q in q_grid:
        gb = pkg.GraphBuilder(n_sinks=F, end_time=T)
        gb.add_opt(q=q)
        for i in range(F):
            gb.add_poisson(rate=1.0, sinks=[i])
        pts.append(gb.build(capacity=capacity, **kw))
    return pts


def tq(q_grid, **kw):
    return q_points(rt, q_grid, device="cpu", **kw)


def star_q_points(q_grid, F=4, T=20.0):
    pts = []
    for q in q_grid:
        sb = TB.StarBuilder(n_feeds=F, end_time=T)
        for f in range(F):
            sb.wall_poisson(f, 1.0 + 0.2 * f)
        sb.ctrl_opt(q=q)
        pts.append(sb.build(wall_cap=64, post_cap=256, device="cpu"))
    return pts


def same(a, b):
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def counting(monkeypatch, name="run_sweep"):
    calls = []
    real = getattr(sweep_mod, name)

    def run(p, n, **kw):
        calls.append((len(p), n))
        return real(p, n, **kw)

    monkeypatch.setattr(sweep_mod, name, run)
    return calls, real


def test_checkpointed_sweep_matches_and_resumes(tmp_path, monkeypatch):
    pts = tq([0.25, 0.5, 1.0, 2.0, 4.0])
    want = run_sweep(pts, n_seeds=3, **CPU)
    calls, real = counting(monkeypatch)
    d = str(tmp_path / "ck")
    same(run_sweep_checkpointed(pts, 3, d, chunk_points=2, **CPU), want)
    assert [c for c, _ in calls] == [2, 2, 1]
    calls.clear()
    same(run_sweep_checkpointed(pts, 3, d, chunk_points=2, **CPU), want)
    assert calls == []
    os.remove(os.path.join(d, "chunk_00001.npz"))
    same(run_sweep_checkpointed(pts, 3, d, chunk_points=2, **CPU), want)
    assert calls == [(2, 3)]
    # an input change recomputes the affected chunk only
    pts2 = list(pts)
    pts2[0] = tq([0.3])[0]
    calls.clear()
    got = run_sweep_checkpointed(pts2, 3, d, chunk_points=2, **CPU)
    assert calls == [(2, 3)]
    same(got, real(pts2, 3, **CPU))


def test_checkpointed_sweep_rejects_bad_chunk_points(tmp_path):
    with pytest.raises(ValueError, match="chunk_points"):
        run_sweep_checkpointed(tq([1.0]), 2, str(tmp_path), chunk_points=0,
                               **CPU)


def test_checkpointed_sweep_survives_corrupt_chunk(tmp_path):
    pts = tq([0.5, 2.0])
    want = run_sweep(pts, n_seeds=2, **CPU)
    d = str(tmp_path / "ck")
    run_sweep_checkpointed(pts, 2, d, chunk_points=1, **CPU)
    with open(os.path.join(d, "chunk_00000.npz"), "wb") as f:
        f.write(b"not a zipfile")
    same(run_sweep_checkpointed(pts, 2, d, chunk_points=1, **CPU), want)


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "badsum"])
def test_checkpointed_sweep_quarantines_corrupt_chunk_and_reruns(
        tmp_path, monkeypatch, mode):
    pts = tq([0.5, 1.0, 2.0])
    want = run_sweep(pts, n_seeds=2, **CPU)
    d = str(tmp_path / "ck")
    run_sweep_checkpointed(pts, 2, d, chunk_points=1, **CPU)
    victim = os.path.join(d, "chunk_00001.npz")
    faultinject.corrupt_file(victim, mode)
    calls, _ = counting(monkeypatch)
    same(run_sweep_checkpointed(pts, 2, d, chunk_points=1, **CPU), want)
    assert calls == [(1, 2)], "exactly the corrupt chunk re-runs"
    names = sorted(os.listdir(d))
    q = [n for n in names if n.startswith("chunk_00001.npz.corrupt-")
         and not n.endswith(".report.json")]
    reports = [n for n in names if n.startswith("chunk_00001")
               and n.endswith(".report.json")]
    assert len(q) == 1 and len(reports) == 1
    rep = integrity.read_json(os.path.join(d, reports[0]),
                              schema="rq.quarantine-report/1")
    assert rep["quarantined_to"].endswith(q[0])
    integrity.load_npz(victim, schema="rq.sweep.chunk/2")


def test_checkpointed_sweep_rejects_empty_points(tmp_path):
    with pytest.raises(ValueError, match="empty sweep"):
        run_sweep_checkpointed([], 2, str(tmp_path / "x"), **CPU)


def test_checkpointed_sweep_rejects_cfg_change_at_chunk_boundary(tmp_path):
    pts = tq([1.0], F=3) + tq([1.0], F=4)
    d = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="different static config"):
        run_sweep_checkpointed(pts, 2, d, chunk_points=1, **CPU)
    assert not os.path.exists(d) or not os.listdir(d)


def test_checkpointed_sweep_star_engine(tmp_path, monkeypatch):
    pts = star_q_points([0.3, 1.0, 3.0])
    want = run_sweep_star(pts, n_seeds=2, **CPU)
    calls, _ = counting(monkeypatch, "run_sweep_star")
    d = str(tmp_path / "ck")
    same(run_sweep_checkpointed(pts, 2, d, chunk_points=2, star=True,
                                **CPU), want)
    assert calls == [(2, 2), (1, 2)]
    calls.clear()
    same(run_sweep_checkpointed(pts, 2, d, chunk_points=2, star=True,
                                **CPU), want)
    assert calls == []


def test_checkpointed_fused_engine_equals_its_sweep(tmp_path):
    """``engine`` passes through: the fused engine (its plain version on
    the CPU), under the JAX package's name, chunked and resumed."""
    pts = tq([0.3, 1.0, 3.0])
    want = run_sweep(pts, 4, engine="pallas", **CPU)
    d = str(tmp_path / "ck")
    same(run_sweep_checkpointed(pts, 4, d, chunk_points=2, engine="pallas",
                                **CPU), want)
    os.remove(os.path.join(d, "chunk_00000.npz"))
    same(run_sweep_checkpointed(pts, 4, d, chunk_points=2, engine="pallas",
                                **CPU), want)


def test_checkpointed_grids_match_the_references(tmp_path):
    grid = [0.3, 1.0, 4.0]
    rj = jsweep.run_sweep_checkpointed(q_points(J, grid), 3,
                                       str(tmp_path / "j"), chunk_points=2,
                                       seed0=5)
    rt_ = run_sweep_checkpointed(tq(grid), 3, str(tmp_path / "t"),
                                 chunk_points=2, seed0=5, **CPU)
    np.testing.assert_array_equal(rt_.n_posts, np.asarray(rj.n_posts))
    np.testing.assert_array_equal(rt_.health, np.asarray(rj.health))
    for f in ("time_in_top_k", "average_rank", "int_rank2"):
        np.testing.assert_allclose(getattr(rt_, f),
                                   np.asarray(getattr(rj, f)),
                                   rtol=1e-5, atol=1e-6)


def test_a_chunk_the_reference_wrote_is_recomputed(tmp_path, monkeypatch):
    """Same directory, same points and seeds: the JAX package's chunks
    carry its own fingerprint (its repr of the config and its options),
    so the port recomputes and overwrites every one, never trusting or
    quarantining them."""
    grid = [0.5, 2.0]
    d = str(tmp_path / "ck")
    jsweep.run_sweep_checkpointed(q_points(J, grid), 2, d, chunk_points=1)
    jfps = [str(integrity.load_npz(os.path.join(d, f"chunk_0000{i}.npz"),
                                   schema="rq.sweep.chunk/2")["fingerprint"])
            for i in range(2)]
    calls, real = counting(monkeypatch)
    got = run_sweep_checkpointed(tq(grid), 2, d, chunk_points=1, **CPU)
    assert calls == [(1, 2), (1, 2)]
    same(got, real(tq(grid), 2, **CPU))
    fps = [str(integrity.load_npz(os.path.join(d, f"chunk_0000{i}.npz"),
                                  schema="rq.sweep.chunk/2")["fingerprint"])
           for i in range(2)]
    assert set(fps).isdisjoint(jfps)
    assert not [n for n in os.listdir(d) if "corrupt" in n]


def test_checkpointed_sweep_quarantines_and_heals_sick_lane(
        tmp_path, monkeypatch):
    """``numeric:nan`` in one lane of a 32-lane checkpointed sweep (4
    points x 8 seeds, chunks of 2 points): the lane is recorded sick, the
    others are untouched, and the next run re-runs exactly that lane,
    healed to the unfaulted run's values."""
    pts = tq(list(np.linspace(0.3, 3.0, 4)))
    want = run_sweep_checkpointed(pts, 8, str(tmp_path / "ref"),
                                  chunk_points=2, **CPU)
    assert not want.health.any()
    d = str(tmp_path / "inj")
    monkeypatch.setenv(faultinject.ENV_FAULT, "numeric:nan@lane5,chunk1")
    got1 = run_sweep_checkpointed(pts, 8, d, chunk_points=2, **CPU)
    monkeypatch.delenv(faultinject.ENV_FAULT)
    h1 = got1.health.reshape(-1)
    assert np.flatnonzero(h1).tolist() == [21]
    mask = np.arange(32) != 21
    for f in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).reshape(-1)[mask],
            np.asarray(getattr(got1, f)).reshape(-1)[mask], err_msg=f)
    z = integrity.load_npz(os.path.join(d, "chunk_00001.npz"),
                           schema="rq.sweep.chunk/2")
    assert np.flatnonzero(z["health"].reshape(-1)).tolist() == [5]
    calls, _ = counting(monkeypatch)
    same(run_sweep_checkpointed(pts, 8, d, chunk_points=2, **CPU), want)
    assert calls == [(1, 1)]
    calls.clear()
    same(run_sweep_checkpointed(pts, 8, d, chunk_points=2, **CPU), want)
    assert calls == []


def test_stale_schema_recomputes_without_quarantine(tmp_path):
    pts = tq([0.5, 1.0])
    d = str(tmp_path / "ck")
    want = run_sweep_checkpointed(pts, 2, d, chunk_points=2, **CPU)
    path = os.path.join(d, "chunk_00000.npz")
    z = integrity.load_npz(path, schema="rq.sweep.chunk/2")
    integrity.savez(path, schema="rq.sweep.chunk/1", **z)
    same(run_sweep_checkpointed(pts, 2, d, chunk_points=2, **CPU), want)
    assert not [n for n in os.listdir(d) if "corrupt" in n]


def sigterm_points():
    pts = []
    for q in (0.5, 1.0, 2.0, 4.0):
        gb = rt.GraphBuilder(n_sinks=2, end_time=20.0)
        gb.add_opt(q=q)
        gb.add_poisson(rate=1.0, sinks=[0])
        gb.add_poisson(rate=1.0, sinks=[1])
        pts.append(gb.build(capacity=64, device="cpu"))
    return pts


_CHILD = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from redqueen_tpu_torch import runtime
import redqueen_tpu_torch as rt
import redqueen_tpu_torch.sweep as sweep_mod

{points_src}

# A real SIGTERM at the first durable chunk boundary: the sweep
# heartbeats right after each chunk's atomic rename lands.
_orig_hb = sweep_mod._heartbeat
_n = {{"chunks": 0}}

def _hb():
    _n["chunks"] += 1
    if _n["chunks"] == 2:
        os.kill(os.getpid(), signal.SIGTERM)
    _orig_hb()

sweep_mod._heartbeat = _hb
if __name__ == "__main__":
    with runtime.preemption_guard():
        try:
            sweep_mod.run_sweep_checkpointed(sigterm_points(), n_seeds=2,
                                             ckpt_dir={ckpt!r},
                                             chunk_points=1, device="cpu")
            print("COMPLETED")
            sys.exit(0)
        except runtime.PreemptedError:
            print("PREEMPTED")
            sys.exit(143)
"""


def test_sigterm_mid_sweep_resumes_bit_identically(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(
        repo=REPO, ckpt=ckpt,
        points_src=inspect.getsource(sigterm_points)))
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 143 and "PREEMPTED" in r.stdout, (
        r.returncode, r.stdout, r.stderr)
    done = sorted(f for f in os.listdir(ckpt) if f.endswith(".npz"))
    assert 1 <= len(done) < 4, done
    mtimes = {f: os.path.getmtime(os.path.join(ckpt, f)) for f in done}
    resumed = run_sweep_checkpointed(sigterm_points(), n_seeds=2,
                                     ckpt_dir=ckpt, chunk_points=1, **CPU)
    for f, t in mtimes.items():
        assert os.path.getmtime(os.path.join(ckpt, f)) == t, f
    same(resumed, run_sweep(sigterm_points(), n_seeds=2, **CPU))
