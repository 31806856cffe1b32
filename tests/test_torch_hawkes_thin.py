"""The Hawkes thinning kernel's CPU side (``csrc/hawkes_thin.cu`` runs
only on the card; ``tests/test_torch_cuda.py`` holds it against the plain
loop there, bit for bit).

Here: the wrapper ``kernels.launch_hawkes_thin`` refuses what the kernel
does not take before it loads any library; ``streams.hawkes_stream`` on a
CPU key never touches ``ops.kernels``; a plain-PyTorch model of the
kernel thread's in-place finish (an event at exactly ``t0`` dropped and
the row closed up, ``truncated`` from the probe slot) equals ``_finish``
of hand-built slot rows; and the smoke run's phase 14 computes its bound,
its error and its row of the kernel table as it says.  Exact."""

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

    monkeypatch.setattr(kernels, "_load", refuse)
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


def test_the_kernel_row_counts_both_phases():
    ph14 = {"launches": 24, "max_abs_err": 0.0, "ms_device_median": 1.35,
            "ms_with_wrapper_median": 1.65, "plain_ms": 1300.0,
            "bound_ms": 0.571, "bound_by": "operations"}
    row = hawkes_thin.thin_row(ph14, 1)
    assert row["name"] == "hawkes_thin" and row["library_ms"] is None
    assert row["launches"] == 25
    assert row["launches_by_phase"] == {"7": 1, "14": 24}
    assert (row["ms"], row["ms_with_host"], row["plain_ms"]) == (
        1.35, 1.65, 1300.0)
    assert row["replaces"].startswith("redqueen_tpu/ops/streams.py:74 ")
    assert row["source"] == "redqueen_tpu_torch/csrc/hawkes_thin.cu"
