"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and
a traffic mix; the mix names the driver (``drivers/<driver>.py``) that
runs it.  The run makes its inputs from ``--seed``, warms up, measures
for ``--seconds``, and then judges what the timed path produced against
the plain reference.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, with the device's busy and
window seconds and a breakdown of the traced window.

The last line of standard output is the result, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and,
traced, ``breakdown``), then ``checks``: every number compared with its
limit, which are also the last lines of standard error.

Exit codes: 0 with a result; 2 when torch sees no CUDA device or fewer
than the cell asks for; 3 when JAX or the JAX package was loaded; 4 when
an end-to-end metric of the cell could not be read."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    # Run as a script: import the benchmark and the program from the
    # checkout's root, not from this directory.
    if sys.path and os.path.abspath(sys.path[0]) == _HERE:
        sys.path[0] = os.path.dirname(_HERE)

from portbench import manifest  # noqa: E402

#: Top-level modules that must not be loaded in a run: JAX, and the JAX
#: package and its benchmark harness.
FORBIDDEN = ("jax", "jaxlib", "flax", "redqueen_tpu", "benchmarks")

#: Variables of the program that would change what a run does.
_PROGRAM_ENV = ("RQ_FAULT", "RQ_TRACE", "RQ_TRACE_SAMPLE", "RQ_TRACE_FLIGHT")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_loaded():
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare_environment(root: str = manifest.ROOT):
    """Build and kernel caches at fixed paths inside the checkout, one
    host thread for the math libraries (the timed paths issue work from
    one thread; idle pools only contend for the host's cores), and none
    of the program's fault or tracing switches."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for k in _PROGRAM_ENV:
        os.environ.pop(k, None)


def execute(args, device, system=None, root: str = manifest.ROOT,
            t_process: float = T_PROCESS):
    """Drive one run of ``args.workload`` on ``device`` and build its
    result line.  Returns ``(line, exit code)``; ``line`` is None when
    there is no result.  ``system`` stands in for the program (the
    control and the tests of the comparison use it)."""
    import importlib
    from types import SimpleNamespace

    man = manifest.load(root)
    cell = manifest.cell(man, args.workload)
    traffic = manifest.traffic(cell, root)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = SimpleNamespace(
        seed=int(args.seed), seconds=float(args.seconds),
        trace=bool(int(args.trace)), device=device, cell=cell,
        config=manifest.config(man, cell, root), traffic=traffic,
        t_process=t_process, system=system)
    rec = driver.run(ctx)
    log("portbench: notes " + json.dumps(
        {"attempted": rec.attempted, "failed": rec.failed, **rec.notes}))

    found = forbidden_loaded()
    if found:
        log(f"portbench: forbidden modules loaded in this process: "
            f"{', '.join(found)}")
        return None, 3

    metrics = {}
    for m in manifest.metrics_for(man, cell["name"], ctx.trace):
        value = manifest.reader(m["name"], root)(rec)
        if value is None:
            if not ctx.trace:
                log(f"portbench: end-to-end metric {m['name']} of "
                    f"{cell['name']} could not be read")
                return None, 4
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": int(cell["chips"]),
           "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line = {"correct": rec.correct, "attempted": int(rec.attempted),
            "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if ctx.trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": rec.trace.device_ops(),
                             "idle_gaps": rec.trace.idle_gaps(rec.phases)}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in rec.checks}
    for c in rec.checks:
        log(c.line())
    return line, 0


def _device_kind(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 portbench/run.py",
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True,
                    help="a cell named in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    prepare_environment()
    cell = manifest.cell(manifest.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"portbench: the cell {cell['name']} needs {cell['chips']} "
            f"CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" — no result")
        return 2
    line, rc = execute(args, torch.device("cuda", 0))
    if line is not None:
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
