"""Builds of ``csrc/hawkes_pass.cu`` timed against each other, on one card
in one process: the tool for trying a change to the kernel.

    python -m redqueen_tpu_torch.smoke.hawkes_variants A.cu B.cu ... \\
        [--old OLD.cu]

Each source has the workspace entry of the current kernel
(``rq_hawkes_pass_launch(..., grad, workspace, stream)``); all are built
at once with the package's nvcc flags into a temporary directory, and
run in turns (A, B, ..., then the reverse), ten passes each, on three
random streams (``smoke.learn.pass_stream``): one of the corpus's shape
(8,581,381 events in chunks [2304, 4096], D = 64), one of the world's
(one chunk of 4,096 with 1,093 events, D = 3) and one at D = 128
(300,000 events in chunks of 4,096), in both modes.  Prints the
registers and stack frame of each build's phase-(C) kernels, and per
stream and mode each build's mean and least milliseconds on the device
alone (``common.time_launches``) and its largest relative gap to the
first build, or to ``OLD.cu`` (the one-launch entry without a workspace,
as ``smoke.hawkes_compare`` builds it) where given."""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from redqueen_tpu_torch.ops import kernels
from .common import check, time_launches
from .hawkes_compare import NAMES, build_old, old_pass
from .learn import pass_inputs, pass_stream

STREAMS = ((64, 8_581_381, 4096), (3, 1093, 4096), (128, 300_000, 4096))
REPS = 10


def build_all(srcs, out_dir):
    """Every source compiled at once; ``{source: (library, ptxas lines)}``."""
    jobs = []
    for i, src in enumerate(srcs):
        so = os.path.join(out_dir, f"libvariant{i}.so")
        jobs.append((src, so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, so, proc in jobs:
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc on {src}:\n{out}")
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rq_hawkes_pass_launch.argtypes = [vp] * 13 + [ci] * 4 + [vp, vp]
        lib.rq_hawkes_segments.argtypes = [ci]
        lib.rq_hawkes_workspace_floats.argtypes = [ci, ci, ci]
        lib.rq_hawkes_workspace_floats.restype = ctypes.c_longlong
        libs[src] = (lib, pass_kernel_report(out))
    return libs


def pass_kernel_report(ptxas):
    """``pass_kernel<NJ, grad>: <stack frame>, <registers>`` for each
    phase-(C) kernel in ptxas's report."""
    out, name = [], None
    for ln in ptxas.splitlines():
        m = re.search(r"Function properties for .*pass_kernelILi(\d)ELb(\d)E",
                      ln)
        if m:
            name = f"pass_kernel<{m.group(1)}, {bool(int(m.group(2)))}>"
            out.append(name + ":")
        elif "Function properties" in ln:
            name = None
        elif name and ("stack frame" in ln or "registers" in ln):
            out[-1] += " " + ln.split(":", 1)[-1].strip()
    return out


def variant_pass(lib):
    """A build's pass, allocating what ``kernels.launch_hawkes_pass``
    does."""
    def run(dt, dims, mask, tail, mu, alpha, beta, grad=False):
        C, K = dt.shape
        D = mu.shape[0]
        dev, f32 = dt.device, torch.float32
        W = lib.rq_hawkes_segments(D)
        work = torch.empty(lib.rq_hawkes_workspace_floats(C, W, D),
                           dtype=f32, device=dev)
        outs = [torch.empty(C, dtype=f32, device=dev)] + [
            torch.empty(s, dtype=f32, device=dev)
            for s in ((C, D), (C, D, D), (C, D), (C, D))]
        health = torch.zeros(D, dtype=torch.int32, device=dev)
        rc = lib.rq_hawkes_pass_launch(
            *(t.data_ptr() for t in (dt, dims, mask, tail, mu, alpha, beta,
                                     *outs, health)),
            C, K, D, 1 if grad else 0, work.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        check(rc == 0, f"a variant's launch returned {rc}")
        return (*outs, health)
    return run


def gap(x, y):
    return max(float((u.double() - v.double()).abs().max())
               / max(float(v.double().abs().max()), 1e-30)
               for _, u, v in zip(NAMES, x[:5], y[:5]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--old", help="an earlier one-launch hawkes_pass.cu, "
                                  "the reference for the gaps")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hawkes_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(opts.sources, tmp)
        old = old_pass(build_old(opts.old, tmp)) if opts.old else None
        for src, (_, ptxas) in libs.items():
            print(src, "ptxas:", "; ".join(ptxas))
        for D, n, K in STREAMS:
            ch, mu, alpha, beta = pass_stream(D, n, K, seed=1,
                                              degenerate=False)
            args = pass_inputs(ch, mu, alpha, beta, dev)
            for grad in (False, True):
                ref = old(*args, grad=grad) if old else None
                ms, gaps = {}, {}
                for src in opts.sources + opts.sources[::-1]:
                    t, _, out = time_launches(variant_pass(libs[src][0]),
                                              *args, grad=grad, reps=REPS)
                    ms.setdefault(src, []).extend(t)
                    if ref is None:
                        ref = out
                    gaps[src] = gap(out, ref)
                print(f"D={D} C={ch.dt.shape[0]} "
                      f"{'grad' if grad else 'stats'}: " + "; ".join(
                          f"{s} mean {np.mean(ms[s]):.4f} min "
                          f"{np.min(ms[s]):.4f} gap {gaps[s]:.2e}"
                          for s in opts.sources), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
