"""``chip_smoke.py`` phase 12 (the runtime and the experiments) rehearsed
on the CPU at a tiny size through the same code the card runs, with the
checks it makes there: the supervised trade-off experiment (48 lanes a
half) SIGTERMed after its first chunk and resumed bit for bit, backend
``"cpu"`` here, the corrupt chunk quarantined and alone recomputed; the
Poisson half behind RedQueen; ``closed_loop`` inside its tolerances;
``compare_policies`` and ``rank_timeline``; ``live_swap --quick``; the
native loader equal to the Python one.  The probe is faked (a real one needs a card); the
gates' failures are shown on crafted inputs."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke  # noqa: F401  (chip_smoke.py imports phase 12)
from redqueen_tpu_torch.runtime import integrity
from redqueen_tpu_torch.smoke import runtime as R
from redqueen_tpu_torch.sweep import SweepResult

CPU = torch.device("cpu")
SMALL = dict(
    sweep=dict(q_grid=(0.1, 1.0, 10.0), n_seeds=16, F=3, T=20.0,
               wall_rate=1.0),
    compare=dict(n_seeds=4, F=3, T=20.0, q=0.5, capacity=64,
                 rmtpp_steps=20, engine="auto"),
    rank=dict(T=20.0, F=3, seed=1, capacity=64),
    corpus=dict(seed=5, n_users=300, end_time=10.0),
    closed_loop_kw=dict(T_fit=200.0, em_iters=40, fw_iters=60, n_seeds=4,
                        T_ctrl=40.0),
    budget_s=600.0)


@pytest.fixture
def no_fault(monkeypatch):
    monkeypatch.delenv("RQ_FAULT", raising=False)
    monkeypatch.delenv("RQ_FAULT_POINT", raising=False)


@pytest.fixture
def fake_probe(monkeypatch):
    from redqueen_tpu_torch.utils import backend

    monkeypatch.setattr(backend, "probe_default_backend",
                        lambda d=120.0, log=None: (False, 0, ""))
    monkeypatch.setattr(backend.time, "sleep", lambda s: None)


def test_phase12_on_the_cpu(no_fault, fake_probe):
    res = R.phase_runtime(CPU, **SMALL)
    sw = res["sweep"]
    assert sw["lanes"] == 48 <= 64 and sw["chunks"] == 4
    assert sw["backend_used"] == "cpu" and sw["recomputed_share"] == 0.75
    assert [a["outcome"] for a in sw["attempts"]] == ["crash", "ok"]
    assert sw["attempts"][0]["returncode"] == -15
    assert sw["child"]["platform"] == "cpu"
    assert sw["child"]["pallas_launches"] > 0  # the plain version's
    assert sw["events"] > 0 and sw["quarantined"].startswith(
        "opt/chunk_00001.npz.corrupt-")
    f = res["finding"]
    assert all(d > 0 for d in f["diff"]) and f["z"][1] > R.SE_GATE
    assert res["closed_loop"]["n_events_fit"] > 0
    assert set(res["compare"]["card_vs_cpu_sigma"]) == {
        "opt", "poisson", "hawkes", "offline", "replay", "rmtpp"}
    assert res["live_swap"]["platform"] == "cpu"
    n = res["native"]
    assert n["rows"] > 1000 and n["users"] <= 300
    assert res["probe"]["probe"] == [False, 0, ""]
    assert res["probe"]["ensure_backend"] == "cpu"
    assert res["total_s"] <= SMALL["budget_s"]
    json.dumps(res)  # the phase's line


def test_flipped_payload_byte_is_caught(tmp_path):
    p = str(tmp_path / "c.npz")
    integrity.savez(p, schema="rq.sweep.chunk/2",
                    time_in_top_k=np.arange(12, dtype=np.float32),
                    fingerprint=np.asarray("x"))
    R.flip_payload_byte(p)
    with pytest.raises(integrity.CorruptArtifactError):
        integrity.load_npz(p, schema="rq.sweep.chunk/2")
    assert [f for f in os.listdir(tmp_path) if ".corrupt-" in f]


def _grid(top, posts):
    top = np.asarray(top, np.float32)
    return SweepResult(time_in_top_k=top, average_rank=top,
                       n_posts=np.asarray(posts, np.int32), int_rank2=top,
                       health=np.zeros(top.shape, np.uint32))


def test_finding_gate_fails_when_redqueen_does_not_lead(monkeypatch):
    """(b) on a crafted RedQueen grid that never reaches the top: the
    gate fails the run."""
    settings = dict(SMALL["sweep"], n_seeds=8)
    opt = _grid(np.zeros((3, 8)), np.full((3, 8), 20))
    poisson = _grid(np.linspace(1, 3, 24).reshape(3, 8),
                    np.full((3, 8), 20))
    with pytest.raises(SystemExit):
        R.tradeoff_finding(settings, opt, poisson)
    R.tradeoff_finding(settings, poisson, opt)  # the other way: it leads


def test_compare_gate_fails_far_from_the_cpu(tmp_path):
    """(d) on two crafted results whose Poisson means lie far apart."""
    def doc(shift):
        pol = {k: {"top1": list(np.linspace(10, 12, 8) + (
            shift if k == "poisson" else 0) + (5 if k == "opt" else 0)),
            "avg_rank": [1.0] * 8, "posts": [20.0] * 8}
            for k in ("opt", "poisson", "hawkes", "offline", "replay",
                      "rmtpp")}
        return {"T": 40.0, "budget": 20.0, "platform": "cpu", "wall_s": 1.0,
                "device_name": "cpu", "policies": pol}
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    integrity.write_json(a, doc(0.0),
                         schema="rq.experiment.compare_policies/1")
    integrity.write_json(b, doc(0.0),
                         schema="rq.experiment.compare_policies/1")
    out = R.compare_checks(a, b, "cpu")
    assert all(v == 0 for v in out["card_vs_cpu_sigma"].values())
    integrity.write_json(b, doc(3.0),
                         schema="rq.experiment.compare_policies/1")
    with pytest.raises(SystemExit):
        R.compare_checks(a, b, "cpu")
