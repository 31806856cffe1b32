"""The Hawkes thinning kernel's CPU side (``csrc/hawkes_thin.cu`` runs
only on the card; ``tests/test_torch_cuda.py`` holds it against the plain
loop there, bit for bit).

Here: the wrapper ``kernels.launch_hawkes_thin`` refuses what the kernel
does not take before it loads any library; ``streams.hawkes_stream`` on a
CPU key never touches ``ops.kernels``; a plain-PyTorch model of the
kernel thread's in-place finish (an event at exactly ``t0`` dropped and
the row closed up, ``truncated`` from the probe slot) equals ``_finish``
of hand-built slot rows; the smoke run's phase 14 computes its bound and
its error as it says; and ``chip_smoke.kernel_rows`` builds the three rows
of the kernel table with the same fields.  Exact."""

import pytest
import torch

from redqueen_tpu_torch.ops import kernels, prng, streams
from redqueen_tpu_torch.smoke import hawkes_thin
from redqueen_tpu_torch.utils import roofline

INF = float("inf")


@pytest.fixture
def no_library(monkeypatch):
    """Loading or building a kernel library fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(kernels, "_library", refuse)
    monkeypatch.setattr(kernels, "build", refuse)


def _inputs(N=6, dev="cpu"):
    return (torch.zeros((N, 2), dtype=torch.int32, device=dev),
            torch.full((N,), 0.5), torch.full((N,), 0.8),
            torch.full((N,), 2.0))


def _bad(case):
    key, l0, alpha, beta = _inputs()
    if case == "float64":
        l0 = l0.double()
    elif case == "int64 key":
        key = key.long()
    elif case == "non-contiguous":
        alpha = torch.full((12,), 0.8)[::2]
    elif case == "short":
        beta = beta[:5]
    elif case == "key shape":
        key = key[:, :1].contiguous()
    return key, l0, alpha, beta


@pytest.mark.parametrize("case, says", [
    ("cpu", "CUDA"), ("float64", "dtype"), ("int64 key", "dtype"),
    ("non-contiguous", "contiguous"), ("short", "shape"),
    ("key shape", "shape")])
def test_the_wrapper_refuses_before_loading_a_library(no_library, case,
                                                      says):
    before = kernels.LAUNCHES["hawkes_thin"]
    with pytest.raises(ValueError, match=says):
        kernels.launch_hawkes_thin(*_bad(case), 0.0, 10.0, 16)
    assert kernels.LAUNCHES["hawkes_thin"] == before


def test_a_cpu_key_never_touches_the_kernels(no_library, monkeypatch):
    def launch(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(kernels, "launch_hawkes_thin", launch)
    key = prng.split(prng.PRNGKey(7), 12)
    l0, alpha, beta = (torch.full((12,), x) for x in (0.5, 0.8, 2.0))
    s = streams.hawkes_stream(key, l0, alpha, beta, 0.0, 15.0, 64)
    p = streams._hawkes_stream_plain(key, l0, alpha, beta, 0.0, 15.0, 64)
    assert int(s.n.sum()) > 0
    for a, b in zip(s, p):
        assert torch.equal(a, b)


# ---- the kernel thread's finish, modelled in plain PyTorch -----------------

def _finish_in_place(slots, t0, cap):
    """What the kernel writes for one source whose fired slots are
    ``slots`` (ascending): each event of a slot below ``cap`` that lies
    after ``t0`` at the next free place of a +inf row; the probe slot
    ``cap`` sets ``truncated``."""
    row = torch.full((cap,), INF)
    kept, probe = 0, False
    for slot, tp in enumerate(slots):
        if slot < cap:
            if tp > t0:
                row[kept] = tp
                kept += 1
        else:
            probe = True
    return row, kept, probe


ROWS = {
    # Fired slots (ascending, within T); the rest of the cap + 1 are +inf.
    "empty": [],
    "one": [0.25],
    "event at t0 first": [1.0, 1.5, 2.0],
    "two events at t0": [1.0, 1.0, 1.75],
    "ties after t0": [1.5, 1.5, 3.0],
    "fills the buffer": [1.25, 1.5, 2.0, 2.5],
    "fires the probe": [1.25, 1.5, 2.0, 2.5, 3.0],
    "t0 then the probe": [1.0, 1.25, 1.5, 2.0, 2.5],
}


@pytest.mark.parametrize("t0", [0.0, 1.0])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_the_in_place_finish_equals_finish_of_the_slots(name, t0):
    cap, T_end = 4, 10.0
    fired = [t for t in ROWS[name] if t >= t0][:cap + 1]
    slots = torch.full((cap + 1,), INF)
    slots[:len(fired)] = torch.tensor(fired)
    times, n = streams._finish(slots[None, :cap], t0, T_end)
    row, kept, probe = _finish_in_place(fired, torch.tensor(t0), cap)
    assert torch.equal(row.view(torch.int32), times[0].view(torch.int32))
    assert kept == int(n[0])
    assert probe == bool(torch.isfinite(slots[cap]))


# ---- the smoke run's phase 14, its arithmetic ------------------------------

def test_the_bound_at_the_cells_shape():
    """21.26 M events over 256,000 sources: 21.52 M proposals of five
    blocks and as many chain keys, 74 integer instructions a block, at
    the INT32 rate; the 1.05 GB of rows at the HBM rate is less."""
    b = hawkes_thin.bound(256_000, 21_261_024, 1024)
    assert b["bound_by"] == "operations"
    assert b["ops_ms"] == pytest.approx(
        74 * 6 * (21_261_024 + 256_000) / roofline.INT32_PER_S * 1e3)
    assert b["bytes_ms"] == pytest.approx(
        256_000 * (1024 * 4 + 25) / roofline.HBM_BYTES_PER_S * 1e3)
    assert 0.5 < b["bound_ms"] < 0.65 and b["bytes_ms"] < b["ops_ms"]


@pytest.mark.parametrize("case, err", [
    ("equal", 0.0), ("one event moved", 0.25), ("one event more", INF),
    ("no events", 0.0)])
def test_the_max_abs_err_of_two_streams(case, err):
    times = torch.tensor([[1.0, 2.0, INF], [0.5, INF, INF]])
    if case == "no events":
        times = torch.full((2, 3), INF)
    want = streams.Stream(times, torch.isfinite(times).sum(1),
                          torch.zeros(2, dtype=torch.bool))
    got = times.clone()
    if case == "one event moved":
        got[0, 1] = 2.25
    elif case == "one event more":
        got[1, 1] = 0.75
    got = streams.Stream(got, torch.isfinite(got).sum(1), want.truncated)
    assert hawkes_thin.max_abs_err(got, want) == err


# ---- the kernel table's rows (``chip_smoke.kernel_rows``) -----------------

BOUND = {"bound_ms": 0.571, "bound_by": "operations", "ops_ms": 0.571}


def _phases():
    """The phases' results, as far as ``chip_smoke.kernel_rows`` reads
    them (made-up figures)."""
    return {
        "headline": {
            "B": 4, "launches": {"event_kernel": 3},
            "kernel_ms_per_launch": [0.5, 0.3, 0.4],
            "kernel_with_host_ms_per_launch": [0.6, 0.9, 0.7],
            "plain_ms_per_launch": [2000.0, 1800.0, 2100.0],
            "source_events": [23, 40, 41], "kind_is_opt": [True, False, False],
            "adj": [[True, True], [True, False], [False, True]],
            "parity": {"max_abs_err": 0.0}},
        "runtime": {"launches": {"event_kernel": 38, "hawkes_pass": 419}},
        "mesh": {"launches": {"event_kernel": 0, "hawkes_pass": 0}},
        "learn": {
            "launches": 440,
            "parity": {"d5_stats": {"max_abs_err": 1e-7, "plain_ms": 102.5,
                                    "shape": "D = 5, 3000 events"},
                       "d64_grad": {"max_abs_err": 3e-6}},
            "corpus": {"kernel_ms": [4.0, 3.9, 4.2, 4.1],
                       "kernel_with_host_ms": [4.3, 4.2, 4.6, 4.5],
                       "phases": {"share": {"A": 0.2, "B": 0.1, "C": 0.7}},
                       "cross": {"max_abs_err": 2e-6}, "bound": BOUND}},
        "serving": {"launches": 1}, "cluster": {"launches": 6},
        "presets": {"config2": {"thin_launches": 1}},
        "hawkes_thin": {"ms_device": [1.36, 1.35, 1.34], "plain_ms": [1300.0],
                        "ms_with_host": [1.65, 1.7, 1.6], "launches": 23,
                        "max_abs_err": 0.0, "bound": BOUND},
    }


# Each row's figures: (ms, ms_with_host, plain_ms, launches by phase,
# max_abs_err, plain_shape, phase_share), from the made-up phases.
ROWS_WANT = {
    "event_kernel": (0.4, 0.7, 2000.0, {"5": 3, "12": 38, "13": 0}, 0.0,
                     None, None),
    "hawkes_pass": (4.05, 4.4, 102.5,
                    {"9": 440, "10": 1, "11": 6, "12": 419, "13": 0}, 3e-6,
                    "D = 5, 3000 events", {"A": 0.2, "B": 0.1, "C": 0.7}),
    "hawkes_thin": (1.35, 1.65, 1300.0, {"7": 1, "14": 23}, 0.0, None,
                    None),
}


@pytest.mark.parametrize("name", sorted(ROWS_WANT))
def test_the_kernel_row_counts_both_phases(name):
    import chip_smoke

    rows = chip_smoke.kernel_rows(_phases())
    assert [r["name"] for r in rows] == ["event_kernel", "hawkes_pass",
                                         "hawkes_thin"]
    assert all(r.keys() == rows[0].keys() for r in rows)
    row = next(r for r in rows if r["name"] == name)
    ms, host, plain, by_phase, err, shape, share = ROWS_WANT[name]
    assert (row["ms"], row["ms_with_host"], row["plain_ms"]) == (
        pytest.approx(ms), pytest.approx(host), plain)
    assert row["launches_by_phase"] == by_phase
    assert row["launches"] == sum(by_phase.values())
    assert row["max_abs_err"] == err and row["route"] == "cuda"
    assert row["plain_shape"] == shape and row["phase_share"] == share
    assert row["source"] == f"redqueen_tpu_torch/csrc/{name}.cu"
    assert row["library_ms"] is None
    if name == "hawkes_thin":
        assert row["replaces"].startswith("redqueen_tpu/ops/streams.py:74 ")
    if name == "event_kernel":
        assert row["bound_ms"] == chip_smoke.event_kernel_bound(
            _phases()["headline"])["bound_ms"]
    else:
        assert (row["bound_ms"], row["bound_by"]) == (0.571, "operations")
