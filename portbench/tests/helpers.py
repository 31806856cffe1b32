"""Running a cell of a small copy of the benchmark on the CPU."""

import time
from types import SimpleNamespace

import torch

from portbench import manifest, run

CPU = torch.device("cpu")


def cell_files(root: str, cell: str):
    man = manifest.load(root)
    c = manifest.cell(man, cell)
    return manifest.config(man, c, root), manifest.traffic(c, root)


def run_cell(root: str, cell: str, seed: int = 2 ** 31 + 7,
             seconds: float = 0.5, system=None, trace: int = 0):
    """``(result line, exit code)`` of one run on the CPU."""
    args = SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                           trace=trace)
    return run.execute(args, CPU, system=system, root=root,
                       t_process=time.perf_counter())


class StepClock:
    """A stand-in for a driver's ``time`` module: ``perf_counter`` starts
    at the real clock and then moves a tenth of a second a reading, so
    that a window of a given length holds the same number of batches
    however fast the CPU runs them."""

    def __init__(self):
        self.t = None

    def perf_counter(self):
        self.t = time.perf_counter() if self.t is None else self.t + 0.1
        return self.t


def with_traffic(sizes: dict, mix: str, **edits) -> dict:
    """``sizes`` (``conftest.SMALL``'s shape) with ``edits`` made to the
    mix ``mix``."""
    traffic = dict(sizes["traffic"])
    traffic[mix] = {**traffic.get(mix, {}), **edits}
    return {**sizes, "traffic": traffic}


def recording(monkeypatch, driver) -> list:
    """The records that ``driver.run`` hands back from now on, in order."""
    out = []
    real = driver.run

    def run(ctx):
        out.append(real(ctx))
        return out[-1]

    monkeypatch.setattr(driver, "run", run)
    return out


def later_judged(rec) -> list:
    """The later batches' lanes a run judged, as (batch, lane), in order."""
    return [(b, int(lane)) for b, lanes in rec.values["judged"] if b
            for lane in lanes]
