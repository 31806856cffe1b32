"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in the precision below
the one the configuration states (bfloat16 for float32), run through the
same driver, window and checks as a run of the cell.  Its readings are
the upper ends the limits are set under; a sound control reads as not
correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
                                 [--seconds S]

Prints one JSON line a seed: the seed, ``correct`` and every number
compared.  It needs no card: the reference runs on the host.  Each
driver (``drivers/<driver>.py``) makes its own control, ``control(config,
traffic, precision)``."""

import argparse
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace

_HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == _HERE:
        sys.path[0] = os.path.dirname(_HERE)

from portbench import manifest, run  # noqa: E402
from portbench.reference.precision import below  # noqa: E402


def system_for(workload: str, root: str = manifest.ROOT):
    """The control standing in for the program of ``workload``'s
    driver, in the precision below its configuration's."""
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell, root)
    tr = manifest.traffic(cell, root)
    driver = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    return driver.control(cfg, tr, below(cfg["precision"]))


def readings(workload, seeds, seconds, device, root: str = manifest.ROOT):
    """One ``{seed, correct, checks}`` a seed."""
    import torch

    out = []
    for seed in seeds:
        args = SimpleNamespace(workload=workload, seed=seed,
                               seconds=seconds, trace=0)
        line, rc = run.execute(args, torch.device(device),
                               system=system_for(workload, root),
                               root=root, t_process=time.perf_counter())
        out.append({"seed": seed, "rc": rc,
                    "correct": None if line is None else line["correct"],
                    "checks": None if line is None else line["checks"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    run.prepare_environment()
    for r in readings(args.workload,
                      [int(s) for s in args.seeds.split(",")],
                      args.seconds, "cpu"):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
