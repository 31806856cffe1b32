"""The port's experiment modules (``redqueen_tpu_torch.experiments``) on
the CPU, each held against the JAX package's ``experiments/*.run`` on
the same inputs and seeds: ``tests/test_experiments.py``'s three smoke
cases at their sizes, with the paper's orderings (RedQueen above
budget-matched Poisson, every policy running through the comparison),
and the trade-off CLI through ``--ckpt-dir`` equal to the plain run, its
result enveloped with the platform.

The port runs at the chunk its command lines pick
(``parallel.lanes.shape_budget``'s, 64 events at these sizes) and the
reference at its own (1,024 or 4,096): the scan engine's events do not
depend on the chunk, only its cost does, and these comparisons show it.

Tolerances, as ``tests/test_torch_sweep.py`` states them: posts and
budgets identical; time-in-top-1 and average rank within rtol 1e-5
(float32 sums in another order); event times within rtol 1e-6 (the scan
engines' stated parity, ``tests/torch_parity.py``)."""

import os
import sys

import numpy as np
import pytest

from redqueen_tpu_torch.parallel.lanes import shape_budget
from redqueen_tpu_torch.runtime import integrity
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CPU = dict(device="cpu")
RTOL = 1e-5


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL,
                               atol=RTOL)


def test_compare_policies_smoke(monkeypatch):
    """The port's run, then the reference's on the weights the port
    trained (the training itself is held to the reference in
    ``tests/test_torch_rmtpp.py``): every policy's posts identical."""
    from experiments import compare_policies as jcp
    from redqueen_tpu_torch import convert
    from redqueen_tpu_torch.experiments import compare_policies as tcp

    trained = {}
    real = tcp._trained_rmtpp_weights

    def keep(*a, **k):
        trained["w"] = real(*a, **k)
        return trained["w"]

    monkeypatch.setattr(tcp, "_trained_rmtpp_weights", keep)
    _, walls = tcp.diurnal_profile(40.0)
    cap, _ = shape_budget(4, 40.0, float(walls.mean()))
    results, budget, T = tcp.run(n_seeds=6, F=4, T=40.0, q=0.5,
                                 capacity=cap, rmtpp_steps=40, **CPU)
    assert set(results) == {"opt", "poisson", "hawkes", "offline", "replay",
                            "rmtpp"}
    assert budget > 0
    for name, (top, rank, posts) in results.items():
        assert top.shape == (6,)
        assert np.all(top >= 0) and np.all(top <= T)
        assert np.all(rank >= 0)
    assert results["opt"][0].mean() > results["poisson"][0].mean()
    assert results["rmtpp"][2].mean() > 0
    assert results["opt"][0].mean() > results["rmtpp"][0].mean()
    assert results["opt"][0].mean() > results["hawkes"][0].mean()
    assert abs(results["hawkes"][2].mean() - budget) < 0.5 * budget

    weights, info = trained["w"]
    monkeypatch.setattr(jcp, "_trained_rmtpp_weights", lambda *a, **k: (
        convert.rmtpp_weights_to_jax(weights), info))
    ref, budget_j, T_j = jcp.run(n_seeds=6, F=4, T=40.0, q=0.5,
                                 capacity=1024, rmtpp_steps=40)
    assert (budget, T) == (budget_j, T_j) and cap != 1024
    assert set(ref) == set(results)
    for name, (top, rank, posts) in results.items():
        np.testing.assert_array_equal(posts, np.asarray(ref[name][2]),
                                      err_msg=name)
        close(top, ref[name][0])
        close(rank, ref[name][1])


def test_tradeoff_smoke():
    from experiments import tradeoff as jto
    from redqueen_tpu_torch.experiments.tradeoff import run

    cap, mc = shape_budget(4, 30.0, 1.0)
    budgets, top_o, top_p, posts_p = run([0.2, 2.0], n_seeds=4, F=4, T=30.0,
                                         capacity=cap, max_chunks=mc, **CPU)
    assert budgets.shape == (2,)
    assert budgets[0] > budgets[1]
    assert np.allclose(posts_p.mean(1), budgets, rtol=0.35)
    assert np.all(top_o.mean(1) >= top_p.mean(1))
    # The reference at its default chunk (4,096 events).
    jb, jo, jp, jposts = jto.run([0.2, 2.0], n_seeds=4, F=4, T=30.0)
    np.testing.assert_array_equal(budgets, np.asarray(jb))
    np.testing.assert_array_equal(posts_p, np.asarray(jposts))
    close(top_o, jo)
    close(top_p, jp)


def test_rank_timeline_smoke():
    from redqueen_tpu_torch.experiments.rank_timeline import rank_steps, run
    from redqueen_tpu_torch.utils.metrics_pandas import (num_posts_of_src,
                                                         time_in_top_k)

    from experiments import rank_timeline as jrt

    cap, _ = shape_budget(3, 40.0, 1.0)
    results, budget = run(T=40.0, F=3, seed=1, capacity=cap, **CPU)
    ref, budget_j = jrt.run(T=40.0, F=3, seed=1)
    assert budget == budget_j and set(ref) == set(results)
    for name, (df, src) in results.items():
        jdf, jsrc = ref[name]
        assert src == jsrc and list(df.columns) == list(jdf.columns)
        for c in ("event_id", "src_id", "sink_id"):
            np.testing.assert_array_equal(df[c].to_numpy(),
                                          jdf[c].to_numpy(), err_msg=c)
        for c in ("t", "time_delta"):
            np.testing.assert_allclose(df[c].to_numpy(), jdf[c].to_numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=c)
        assert num_posts_of_src(df, src) > 0, name
        t, r = rank_steps(df, src, 0, 40.0)
        assert t[0] == 0.0 and t[-1] == 40.0
        assert np.all(np.diff(t) >= 0) and np.all(r >= 0)
        frac_steps = float(np.sum(np.diff(t)[r[:-1] == 0]))
        want = time_in_top_k(df, 1, 40.0, src, per_sink=True)[0]
        assert frac_steps == pytest.approx(want, abs=1e-9)


def test_tradeoff_cli_through_ckpt_dir_equals_the_plain_run(tmp_path):
    from redqueen_tpu_torch.experiments import tradeoff

    args = ["--qgrid", "0.3", "1", "3", "--seeds", "3", "--followers", "3",
            "--horizon", "20", "--device", "cpu"]
    plain, ckpt = str(tmp_path / "plain.json"), str(tmp_path / "ck.json")
    assert tradeoff.main(args + ["--out", plain]) == 0
    d = str(tmp_path / "ck")
    assert tradeoff.main(args + ["--out", ckpt, "--ckpt-dir", d,
                                 "--chunk-points", "2"]) == 0
    a = integrity.read_json(plain, schema="rq.experiment.tradeoff/1")
    b = integrity.read_json(ckpt, schema="rq.experiment.tradeoff/1")
    assert a == b
    assert a["platform"] == "cpu" and a["device_name"] == "cpu"
    assert sorted(os.listdir(os.path.join(d, "opt"))) == [
        "chunk_00000.npz", "chunk_00001.npz"]
    # resumed from its chunks, the same again
    assert tradeoff.main(args + ["--out", ckpt, "--ckpt-dir", d,
                                 "--chunk-points", "2"]) == 0
    assert integrity.read_json(ckpt, schema="rq.experiment.tradeoff/1") == a


def test_tradeoff_grids_through_ckpt_dir_on_the_fused_engine(tmp_path):
    """``run_grids`` on the fused engine (its plain version here), the
    path ``chip_smoke.py`` phase 12 (a) takes: checkpointed equals plain,
    every field of both halves."""
    from redqueen_tpu_torch.experiments import tradeoff

    kw = dict(q_grid=[0.3, 1.0, 3.0], n_seeds=3, F=3, T=20.0, capacity=64,
              engine="pallas", max_chunks=64, **CPU)
    plain = tradeoff.run_grids(**kw)
    d = str(tmp_path / "ck")
    for _ in range(2):  # computed, then loaded
        ck = tradeoff.run_grids(**kw, ckpt_dir=d, chunk_points=2)
        for p, c in zip(plain, ck):
            for x, y in zip(p, c):
                np.testing.assert_array_equal(x, y)
    assert sorted(os.listdir(os.path.join(d, "poisson"))) == [
        "chunk_00000.npz", "chunk_00001.npz"]
    budgets, top_o, top_p, posts_p = tradeoff.run(**kw)
    np.testing.assert_array_equal(budgets, plain[0].n_posts.mean(axis=1))
    np.testing.assert_array_equal(top_p, plain[1].time_in_top_k)


def test_default_device_is_the_card(monkeypatch):
    """Without ``--device`` an experiment runs on the card, and without
    one it raises (it never falls back to the CPU)."""
    import torch

    from redqueen_tpu_torch.experiments import rank_timeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_timeline.main(["--horizon", "5"])
