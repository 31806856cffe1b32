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
