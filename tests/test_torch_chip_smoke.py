"""``chip_smoke.py`` rehearsed on the CPU: each phase-4 comparison runs
with the kernel's wrapper replaced by its plain PyTorch version (the
kernel itself runs only on the card), so the mixes build, the faults
poison the lane they name, the started clocks drive the all-Opt mix, and
the comparison and its checks run as they do there.

Tolerance: none; every lane is held bit-identical, as on the card."""

import pytest
import torch

import chip_smoke
from redqueen_tpu_torch.ops import event_step, kernels
from redqueen_tpu_torch.ops.threefry import from_bits32

KEYS = list(chip_smoke.PARITY_MIXES) + [
    f"s32_poisoned_{m}" for m in chip_smoke.POISON_MODES]


@pytest.fixture
def plain_wrapper(monkeypatch):
    monkeypatch.setattr(kernels, "launch_event_kernel", event_step.run_launch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("key", KEYS)
def test_phase4_comparison_runs_on_the_plain_version(plain_wrapper, key):
    if key.startswith("s32_poisoned_"):
        out = chip_smoke.poisoned(key.rsplit("_", 1)[1], "cpu")
    else:
        label, prep, mc = chip_smoke.parity_prep(key, "cpu")
        out, (carry, _, srcs, _) = chip_smoke.compare_runs(label, prep, mc)
        if key == "s32_all_opt":
            # Every source is an Opt row: events come only from the started
            # clocks, and every event after the first reacts on some row.
            draws = int((from_bits32(carry["ctr"])
                         - from_bits32(prep.carry["ctr"])).sum())
            assert out["events"] > prep.B and draws > 2 * out["events"]
            assert int((srcs >= 0).sum()) == out["events"]
    assert out["bit_identical"] and out["lanes_differing"] == 0
    assert out["events"] > 0
