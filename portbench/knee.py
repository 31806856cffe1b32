"""The sweep that finds a serving cell's knee: the highest offered rate
at which nothing is shed and the backlog does not grow.  It runs the
cell's driver at each rate in turn in one process, on the card, and
prints one JSON line a rate: the failed batches, the median and 99th
percentile latency, and the 99th percentile of the window's first and
last thirds (a backlog that grows shows as a last third far above the
first).  The cell's file then takes 0.8 of the knee as its rate.

    python3 portbench/knee.py --workload opt-serve.f1m \\
        --rates 500,700,900 --seconds 10 --seed 1"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == _HERE:
        sys.path[0] = os.path.dirname(_HERE)

from portbench import manifest, run  # noqa: E402
from portbench.common import nearest_rank  # noqa: E402
from portbench.drivers import serve  # noqa: E402


def sweep(workload, rates, seconds, seed, device):
    from types import SimpleNamespace as NS

    man = manifest.load()
    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell)
    for rate in rates:
        tr = {**manifest.traffic(cell), "rate_batches_per_s": float(rate)}
        ctx = NS(seed=seed, seconds=seconds, trace=False, device=device,
                 cell=cell, config=cfg, traffic=tr,
                 t_process=time.perf_counter(), system=None)
        rec = serve.run(ctx)
        lat = rec.values["latencies_s"]
        third = max(len(lat) // 3, 1)
        yield {"rate": rate, "due": int(rec.attempted),
               "failed": int(rec.failed),
               "p50_ms": nearest_rank(lat, 50) * 1e3,
               "p99_ms": nearest_rank(lat, 99) * 1e3,
               "p99_first_third_ms": nearest_rank(lat[:third], 99) * 1e3,
               "p99_last_third_ms": nearest_rank(lat[-third:], 99) * 1e3,
               "generator_late_ms": rec.values["generator_late_s"] * 1e3,
               "correct": rec.correct}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/knee.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    run.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    for row in sweep(args.workload,
                     [float(r) for r in args.rates.split(",")],
                     args.seconds, args.seed, torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
