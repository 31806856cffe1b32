"""The ``hawkes_pass`` kernel against an earlier build of its source, on
one card in one process, at the learn path's two shapes: the config-4
corpus (8,581,381 events in chunks [2304, 4096], D = 64, stats mode as
EM runs it) and the closed-loop world's shape (one chunk of 4,096 with
1,093 events, D = 3, the world's parameters; stats and grad mode).

    python -m redqueen_tpu_torch.smoke.hawkes_compare --old OLD.cu \\
        [--out hawkes_compare.json]

``OLD.cu`` is an earlier ``csrc/hawkes_pass.cu`` whose entry is the
one-launch ``rq_hawkes_pass_launch(13 pointers, C, K, D, grad, stream)``
(no workspace); it is built with the package's nvcc flags into a
temporary directory.  The two run in turns (old, new, new, old), each
pass timed by ``common.time_launches`` on the device alone and with the
wrapper's host work; their outputs are compared with each other and with
a float64 pass (every chunk at once, one event position a step, from
float64 carries); the new kernel's phases are split by the profiler; the
plain version is timed at the world's shape (at the corpus's it would
take hours); and the bound (``smoke.learn.corpus_bound``) is computed
from each stream.  Prints one JSON line, also written to ``--out``.
Exits 2 without a card."""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from redqueen_tpu_torch.learn import loglik
from redqueen_tpu_torch.ops import kernels
from .common import check, time_launches
from .learn import (
    WORLD_ALPHA,
    WORLD_BETA,
    WORLD_MU,
    corpus_bound,
    corpus_chunks,
    pass_inputs,
    pass_phase_ms,
    pass_stream,
)

NAMES = ("ll", "a", "b", "w", "e")


def build_old(src, out_dir):
    """``src`` compiled with the package's flags into ``out_dir``, loaded,
    its one-launch entry declared."""
    lib_path = os.path.join(out_dir, "libhawkes_old.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                           lib_path, src], capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc on {src}: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rq_hawkes_pass_launch.argtypes = [vp] * 13 + [ci] * 4 + [vp]
    lib.rq_hawkes_pass_launch.restype = ci
    return lib


def old_pass(lib):
    """The earlier kernel's pass, allocating what its wrapper did."""
    def run(dt, dims, mask, tail, mu, alpha, beta, grad=False):
        C, K = dt.shape
        D = mu.shape[0]
        dev, f32 = dt.device, torch.float32
        outs = [torch.empty(C, dtype=f32, device=dev)] + [
            torch.empty(s, dtype=f32, device=dev)
            for s in ((C, D), (C, D, D), (C, D), (C, D))]
        health = torch.empty(D, dtype=torch.int32, device=dev)
        rc = lib.rq_hawkes_pass_launch(
            *(t.data_ptr() for t in (dt, dims, mask, tail, mu, alpha, beta,
                                     *outs, health)),
            C, K, D, 1 if grad else 0,
            torch.cuda.current_stream(dev).cuda_stream)
        check(rc == 0, f"the earlier kernel's launch returned {rc}")
        return (*outs, health)
    return run


def float64_pass(dt, dims, mask, tail, mu, alpha, beta, grad=False):
    """The pass in float64 on the card, a reference for both float32
    kernels: every chunk's summary from zero (all chunks at once, one
    event position a step), the chunks' incoming R and Q folded in order,
    then every chunk again from them with the per-event terms.  Returns
    the per-chunk partials and health as the kernel does (float64)."""
    f64 = torch.float64
    C, K = dt.shape
    D = mu.shape[0]
    x_all, t_all = dt.double(), tail.double()
    i_all, m_all = dims.long(), mask
    mu, alpha, negb = mu.double(), alpha.double(), -beta.double()
    rows = torch.arange(C, device=dt.device)

    def walk(R, Q, terms):
        out = {k: torch.zeros(s, dtype=f64, device=dt.device)
               for k, s in (("ll", (C,)), ("a", (C, D)), ("b", (C, D, D)),
                            ("w", (C, D)), ("e", (C, D)))} if terms else None
        bad = torch.zeros(D, dtype=torch.bool, device=dt.device)
        P = torch.ones((C, D), dtype=f64, device=dt.device)
        for k in range(K):
            x, i, m = x_all[:, k], i_all[:, k], m_all[:, k]
            d = torch.exp(negb[None, :] * x[:, None])
            Q = d * (Q + x[:, None] * R)
            R = d * R
            P = P * d
            if terms:
                arow = alpha[i]
                lam = mu[i] + (arow * R).sum(1)
                ok = torch.isfinite(lam) & (lam > 0)
                if grad:
                    tiny = torch.finfo(torch.float32).tiny
                    gate = m & (lam > tiny)
                    out["ll"] += m * torch.log(lam.clamp(min=tiny))
                    inv = torch.where(gate, 1.0 / lam, torch.zeros_like(lam))
                    out["a"][rows, i] += inv
                    out["b"][rows, i] += inv[:, None] * R
                else:
                    use = (m & ok)[:, None]
                    z = torch.zeros_like(lam)
                    out["ll"] += torch.where(m & ok, torch.log(lam.abs()), z)
                    out["a"][rows, i] += torch.where(m & ok, mu[i] / lam, z)
                    out["b"][rows, i] += torch.where(use, arow * R
                                                     / lam[:, None], 0.0)
                    out["w"] += torch.where(use, arow * Q / lam[:, None], 0.0)
                out["e"][rows, i] += torch.where(
                    m, torch.exp(negb[i] * t_all[:, k]), torch.zeros_like(x))
                bad[i[m & ~ok]] = True
            R[rows, i] += m.double()
        return R, Q, P, out, bad

    zero = torch.zeros((C, D), dtype=f64, device=dt.device)
    dR, dQ, P, _, _ = walk(zero, zero, False)
    span = x_all.sum(1)
    R_in, Q_in = torch.empty_like(zero), torch.empty_like(zero)
    R = torch.zeros(D, dtype=f64, device=dt.device)
    Q = torch.zeros(D, dtype=f64, device=dt.device)
    for c in range(C):
        R_in[c], Q_in[c] = R, Q
        Q = P[c] * (Q + span[c] * R) + dQ[c]
        R = P[c] * R + dR[c]
    _, _, _, out, bad = walk(R_in, Q_in, True)
    health = torch.where(bad, 2, 0).to(torch.int32)
    return (out["ll"], out["a"], out["b"], out["w"], out["e"], health)


def rel_gap(x, y):
    """Largest |x - y| over the largest |y|, for each output."""
    gaps = {}
    for nm, u, v in zip(NAMES, x[:5], y[:5]):
        u, v = u.double().cpu(), v.double().cpu()
        gaps[nm] = float((u - v).abs().max()) / max(float(v.abs().max()),
                                                     1e-30)
    gaps["health_equal"] = bool(torch.equal(x[5].cpu(), y[5].cpu()))
    return gaps


def shapes(dev):
    """(name, chunked stream, (mu, alpha, beta), modes, old reps, new
    reps) for the corpus and the world's shape."""
    ch, _ = corpus_chunks()
    rng = np.random.RandomState(64)
    D = ch.n_dims
    corpus_params = (rng.uniform(0.01, 0.1, D),
                     rng.uniform(0.0, 0.5, (D, D)) / 8,
                     rng.uniform(0.5, 3.0, D))
    world, *_ = pass_stream(3, 1093, 4096, seed=7, degenerate=False)
    world_params = (WORLD_MU, np.diag(WORLD_ALPHA), WORLD_BETA)
    return [("corpus", ch, corpus_params, (False,), 2, 20),
            ("world", world, world_params, (False, True), 20, 50)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="an earlier csrc/hawkes_pass.cu")
    ap.add_argument("--out", help="also write the JSON line here")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hawkes_compare: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    kernels.build()
    result = {"card": smi, "segments": {}, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"old": old_pass(build_old(opts.old, tmp)),
               "new": loglik.hawkes_pass}
        for name, ch, params, modes, old_reps, new_reps in shapes(dev):
            args = pass_inputs(ch, *params, dev)
            D = ch.n_dims
            result["segments"][name] = kernels.hawkes_segments(D)
            for grad in modes:
                key = f"{name}_{'grad' if grad else 'stats'}"
                runs = {"old": [], "new": []}
                outs = {}
                for who in ("old", "new", "new", "old"):
                    reps = old_reps if who == "old" else new_reps
                    d, h, outs[who] = time_launches(fns[who], *args,
                                                    grad=grad, reps=reps)
                    runs[who].append({"device_ms": d, "with_host_ms": h})
                ref = float64_pass(*args, grad=grad)
                row = {"events": ch.n_events, "chunks": list(ch.dt.shape),
                       "D": D, "new_vs_old": rel_gap(outs["new"],
                                                     outs["old"]),
                       "new_vs_float64": rel_gap(outs["new"], ref),
                       "old_vs_float64": rel_gap(outs["old"], ref),
                       "bound": corpus_bound(ch, grad),
                       "phases": pass_phase_ms(args, grad)}
                for who in ("old", "new"):
                    d = [m for r in runs[who] for m in r["device_ms"]]
                    h = [m for r in runs[who] for m in r["with_host_ms"]]
                    row[who] = {"device_ms_mean": float(np.mean(d)),
                                "device_ms_min": float(np.min(d)),
                                "with_host_ms_mean": float(np.mean(h)),
                                "turns": runs[who]}
                if name == "world":
                    row["plain_ms"] = time_launches(
                        loglik.hawkes_pass_plain, *args, grad=grad,
                        device_alone=False)[1][0]
                else:
                    row["plain_ms"] = None
                row["speedup"] = (row["old"]["device_ms_mean"]
                                  / row["new"]["device_ms_mean"])
                row["x_bound"] = (row["new"]["device_ms_mean"]
                                  / row["bound"]["bound_ms"])
                result["shapes"][key] = row
                print(f"{key}: new {row['new']['device_ms_mean']:.4f} ms "
                      f"(min {row['new']['device_ms_min']:.4f}, with host "
                      f"{row['new']['with_host_ms_mean']:.4f}), old "
                      f"{row['old']['device_ms_mean']:.4f} ms: "
                      f"{row['speedup']:.1f}x; bound "
                      f"{row['bound']['bound_ms']:.4f} ms "
                      f"({row['x_bound']:.1f}x); new against old "
                      f"{row['new_vs_old']}; against float64: new "
                      f"{row['new_vs_float64']}, old "
                      f"{row['old_vs_float64']}; phases {row['phases']}; "
                      f"plain "
                      f"{row['plain_ms']}", flush=True)
    line = json.dumps(result)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
