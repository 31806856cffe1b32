"""The port's headline bench (``redqueen_tpu_torch/bench.py``) on the CPU:
its result line audits itself, a failed gate exits non-zero with its line
printed, ``--no-oracle`` gives a null gate, and without CUDA the bench
refuses to run unless ``--device cpu`` is given.  The orchestration tests
replace the oracle and the engines with canned results; one run of
``python -m redqueen_tpu_torch.bench --quick --device cpu`` drives the
real thing."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from redqueen_tpu.oracle import numpy_ref as jref
from redqueen_tpu.utils import metrics_pandas as jmp
from redqueen_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LINE_KEYS = {"metric", "value", "unit", "vs_baseline",
             "oracle_events_per_sec", "top1", "oracle_top1", "gate",
             "gate_tol", "gate_ok", "engine", "platform", "engines"}


def _cli(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "redqueen_tpu_torch.bench",
                           *args], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


def _canned_engine(top1, eps=1000.0):
    def run_engine(name, B, F, T, q, wall_rate, device, **kw):
        secs = 2.0 if name == "scan" else 1.0
        return {"engine": name, "route": "scan" if name == "scan" else
                "plain", "events": int(eps * secs * (1 if name == "scan"
                                                     else 3)),
                "secs": secs, "simulate_s": 0.6 * secs,
                "metrics_s": 0.4 * secs, "top1": top1[name],
                "top1_std": 2.0, "top1_n": B, "posts": 10.0,
                "dispatches": 2, "launches": 0, "capacity": 64,
                "max_chunks": 64}
    return run_engine


def _canned_oracle(calls):
    def run_oracle(n, F, T, q, wall_rate, budget_s=380.0):
        calls.append(n)
        return {"events": 500, "secs": 0.5, "top1": 15.0, "top1_std": 2.0,
                "top1_n": n, "comps": n}
    return run_oracle


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_quick_cpu_run_ends_with_a_self_auditing_line():
    """``--quick --device cpu`` end to end: the last stdout line carries
    every field, ``platform: "cpu"``, both engines with their gates, and
    its numbers agree with each other."""
    out = _cli("--quick", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = _lines(out.stdout)
    assert len(lines) == 2 and out.stdout.strip().splitlines()[-1] \
        == json.dumps(lines[-1])
    line = lines[-1]
    assert LINE_KEYS <= set(line)
    assert line["platform"] == "cpu" and line["unit"] == "events/s"
    assert line["metric"] == "simulated events/sec (64x640 graph)"
    assert set(line["engines"]) == {"scan", "fused"}
    assert line["engines"]["fused"]["route"] == "plain"
    assert line["engines"]["scan"]["route"] == "scan"
    best = line["engines"][line["engine"]]
    assert line["value"] == best["events_per_sec"] == max(
        e["events_per_sec"] for e in line["engines"].values())
    assert line["vs_baseline"] == round(
        line["value"] / line["oracle_events_per_sec"], 2)
    o = line["oracle"]
    assert o["comps"] == 2 and line["oracle_events_per_sec"] == round(
        o["events"] / o["secs"], 1)
    for e in line["engines"].values():
        assert e["gate_ok"] is True and e["gate"] <= e["gate_tol"]
        assert e["top1_n"] == 64 and e["events"] > 64 * 200
        assert 0 <= e["top1"] <= 20.0
    assert "numpy oracle" in out.stderr


def test_without_cuda_it_refuses_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--quick"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "--device cpu" in cap.err
    if not torch.cuda.is_available():
        out = _cli("--quick")
        assert out.returncode == 2 and out.stdout == ""


def test_failed_gate_exits_nonzero_with_its_line_printed(monkeypatch,
                                                         capsys):
    calls = []
    monkeypatch.setattr(bench, "run_oracle", _canned_oracle(calls))
    monkeypatch.setattr(bench, "run_engine",
                        _canned_engine({"scan": 15.1, "fused": 19.0}))
    assert bench.main(["--device", "cpu"]) == 3
    cap = capsys.readouterr()
    lines = _lines(cap.out)
    assert calls == [32] and len(lines) == 2
    last = lines[-1]
    assert last["engine"] == "fused" and last["gate_ok"] is False
    assert last["engines"]["scan"]["gate_ok"] is True
    assert last["gate"] == 4.0 and last["gate_tol"] == max(
        round(4 * np.sqrt(4 / 10_000 + 4 / 32), 4), 2.0)
    assert "QUALITY GATE FAILED" in cap.err


def test_a_failed_slower_engine_also_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(bench, "run_oracle", _canned_oracle([]))
    monkeypatch.setattr(bench, "run_engine",
                        _canned_engine({"scan": 30.0, "fused": 15.0}))
    assert bench.main(["--device", "cpu", "--quick"]) == 3
    last = _lines(capsys.readouterr().out)[-1]
    assert last["gate_ok"] is True and last["engines"]["scan"]["gate_ok"] \
        is False


def test_no_oracle_gives_a_null_gate(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bench, "run_oracle", _canned_oracle(calls))
    monkeypatch.setattr(bench, "run_engine",
                        _canned_engine({"scan": 1.0, "fused": 1.0}))
    assert bench.main(["--device", "cpu", "--no-oracle",
                       "--engines", "scan"]) == 0
    (line,) = _lines(capsys.readouterr().out)
    assert calls == []
    for k in ("vs_baseline", "oracle_events_per_sec", "oracle_top1", "gate",
              "gate_tol", "gate_ok"):
        assert line[k] is None
    assert line["top1"] == 1.0 and list(line["engines"]) == ["scan"]
    assert "oracle" not in line


def test_bad_engine_names_are_refused(capsys):
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--engines", "scan,pallas"])


def test_gate_fields_floor_and_four_sigma():
    o = {"top1": 80.0, "top1_std": 3.0, "top1_n": 32}
    tight = bench.gate_fields({"top1": 80.5, "top1_std": 3.0,
                               "top1_n": 10_000}, o, 100.0)
    assert tight["gate_tol"] == round(max(
        4 * np.sqrt(9 / 32 + 9 / 10_000), 2.0), 4)
    assert tight["gate_ok"] is True and tight["gate"] == 0.5
    floor = bench.gate_fields({"top1": 81.9, "top1_std": 0.0,
                               "top1_n": 5}, dict(o, top1_std=0.0), 100.0)
    assert floor["gate_tol"] == 2.0 and floor["gate_ok"] is True


def test_oracle_follows_the_reference_protocol():
    """The bench's denominator equals the JAX package's oracle run the way
    ``bench.py:run_oracle`` runs it: the same seeds, events and
    time-in-top-1."""
    got = bench.run_oracle(2, 10, 20.0, 1.0, 1.0)
    events, tops = 0, []
    for c in range(2):
        others = [("poisson", dict(src_id=100 + i, seed=40_000 + 1000 * c + i,
                                   rate=1.0, sink_ids=[i]))
                  for i in range(10)]
        so = jref.SimOpts(src_id=0, sink_ids=list(range(10)),
                          other_sources=others, end_time=20.0, q=1.0)
        mgr = so.create_manager_with_opt(seed=c)
        mgr.run_till()
        df = mgr.state.get_dataframe()
        events += df["event_id"].nunique()
        tops.append(jmp.time_in_top_k(df, 1, 20.0, src_id=0,
                                      sink_ids=so.sink_ids))
    assert got["events"] == events and got["top1_n"] == 2
    assert got["top1"] == float(np.mean(tops))
    assert got["top1_std"] == float(np.std(tops))
    assert np.isfinite(got["secs"]) and got["secs"] > 0


def test_shapes_are_the_headline_and_quick():
    assert bench.shapes(False) == (10_000, 100.0, 32)
    assert bench.shapes(True) == (64, 20.0, 2)


def test_gate_adds_standard_errors_in_quadrature():
    d, tol = bench.gate((10.0, 2.0, 4), (11.0, 3.0, 9), floor=0.1)
    assert d == 1.0 and tol == 4.0 * np.sqrt(4.0 / 4 + 9.0 / 9)
    assert bench.gate((1.0, 0.0, 0), (1.5, 0.0, 3), floor=0.7) == (0.5, 0.7)


def test_oracle_components_takes_any_manager():
    """One oracle pass with the ``Opt`` manager gives ``run_oracle``'s
    values; the posts are the broadcaster's own."""
    got = bench.oracle_components(
        2, 10, 20.0, 1.0,
        manager=lambda so, c: so.create_manager_with_opt(seed=c))
    ref = bench.run_oracle(2, 10, 20.0, 1.0, 1.0)
    assert got["events"] == ref["events"]
    assert float(got["top1"].mean()) == ref["top1"]
    assert got["posts"].shape == (2,) and (got["posts"] > 0).all()
