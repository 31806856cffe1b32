"""Fit while serving on the port: a regime shift, a guarded hot swap and
the recovery (the counterpart of ``experiments/live_swap.py``).

1. **Regime A**: a known cross-exciting Hawkes world streams through a
   :class:`~redqueen_tpu_torch.serving.ServingRuntime` (binary journal)
   on ``--device``.
2. **Learner killed mid-fit**: a learner in a fresh interpreter (started
   with ``--device``) tails the journal under
   ``RQ_FAULT=learn:kill@step1`` and dies by SIGKILL with statistics
   computed and no checkpoint landed.  The journal must replay
   bit-identically afterwards, and no candidate may exist.
3. **Resume and install**: a fault-free learner resumes, fits A, and its
   candidate passes the gate: epoch 1.
4. **Regime shift** to B (higher base rates, cross-excitation): the
   epoch-1 model is stale.
5. **Hot-swap recovery**: the streaming learner (exponential forgetting,
   every pass the ``hawkes_pass`` kernel on the card) refits and the gate
   installs epoch 2.  The closed-loop latency (the last regime-B batch
   acknowledged to the swapped parameters live) is measured, and the
   recovery scored against :data:`BOUNDS`.
6. **Recovery audit**: the runtime is closed and recovered from disk;
   epoch, fingerprint and parameters must come back bit-identically,
   and the journal and params log must reconcile.

Writes the enveloped ``rq.learn.live_swap/1`` artifact (default
``LIVE_SWAP_torch.json``), with the platform and the card's name.

    python -m redqueen_tpu_torch.experiments.live_swap [--quick]
        [--out F.json] [--skip-kill] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

import numpy as np

from . import add_device_argument, device_fields

# The JAX package's acceptance bounds (experiments/live_swap.py).
BOUNDS = {
    # Fraction of the stale→oracle canary-NLL gap the hot-swap must
    # close (1.0 = swapped fit as good as a fresh B-only refit).
    "recovery_frac": 0.5,
    # The swapped s_sink must be at least this much closer (relative
    # error vs regime B's true stationary weights) than the stale one.
    "s_sink_improvement": 0.0,
    # Warm-path closed-loop latency, journal-write-ack → params live.
    "latency_s": 5.0,
}

_KILL_CHILD = """\
import sys
from redqueen_tpu_torch.learn.streaming import StreamingEM
em = StreamingEM(sys.argv[1], n_feeds=int(sys.argv[3]),
                 ckpt_path=sys.argv[2], gamma=float(sys.argv[4]),
                 device=sys.argv[5])
upd = em.run_once()
print("STEP", upd.step, upd.n_events)
"""


def _regimes(D: int):
    """Two comfortably subcritical worlds; B shifts every base rate up
    and turns on cross-excitation A never had."""
    mu_a = np.array([0.5, 0.8, 0.6, 0.7])[:D]
    alpha_a = np.diag(np.array([0.6, 0.4, 0.5, 0.45])[:D])
    beta_a = np.array([2.0, 2.0, 2.0, 2.0])[:D]
    mu_b = 2.5 * mu_a
    alpha_b = alpha_a.copy()
    for i in range(D):
        alpha_b[i, (i + 1) % D] = 0.5
    beta_b = beta_a
    return (mu_a, alpha_a, beta_a), (mu_b, alpha_b, beta_b)


def _submit_events(rt, times, dims, seq0: int, batch_events: int = 8):
    """Chop a simulated stream into serving micro-batches."""
    from ..serving.events import EventBatch

    seq = seq0
    for i in range(0, len(times), batch_events):
        ts = np.asarray(times[i:i + batch_events], np.float64)
        fs = np.asarray(dims[i:i + batch_events], np.int32)
        adm = rt.submit(EventBatch(seq, ts, fs))
        if adm.status != "accepted":
            raise RuntimeError(f"batch {seq} not accepted: {adm.status}")
        seq += 1
        if (seq - seq0) % 32 == 0:  # stay under queue_capacity
            rt.poll()
    rt.poll()
    return seq


def run(out: str, quick: bool = False, skip_kill: bool = False,
        dir: str | None = None, device="cuda") -> dict:
    """The payload of ``rq.learn.live_swap/1``, also written to ``out``
    (its ``pass`` says whether every bound and audit held)."""
    import functools
    import shutil
    import tempfile

    from ..device import resolve_device
    from ..learn.control import fit_s_sink, simulate_cross_exciting
    from ..learn.ingest import make_stream
    from ..learn.streaming import StreamingEM
    from ..learn.streaming import holdout_nll as _holdout_nll
    from ..runtime import integrity as _integrity
    from ..serving.journal import JOURNAL_FILENAME, replay
    from ..serving.paramswap import ParamGate, ParamSwapper, read_candidate
    from ..serving.service import ServingRuntime, recover

    dev = resolve_device(device)
    holdout_nll = functools.partial(_holdout_nll, device=dev)

    D = 3
    T_a = 60.0 if quick else 240.0
    T_b = 60.0 if quick else 240.0
    gamma = 0.6
    (mu_a, alpha_a, beta_a), (mu_b, alpha_b, beta_b) = _regimes(D)

    tmp = dir or tempfile.mkdtemp(prefix="rq-liveswap-")
    rt_dir = os.path.join(tmp, "rt")
    ck = os.path.join(tmp, "learn.ckpt.npz")
    t0_wall = time.monotonic()
    report: dict = {"dims": D, "quick": bool(quick), "bounds": BOUNDS,
                    "regimes": {
                        "a": {"mu": mu_a.tolist(),
                              "alpha": alpha_a.tolist(),
                              "beta": beta_a.tolist(), "T": T_a},
                        "b": {"mu": mu_b.tolist(),
                              "alpha": alpha_b.tolist(),
                              "beta": beta_b.tolist(), "T": T_b}}}
    try:
        # -- 1. regime A streams through a real runtime ------------------
        ta, da = simulate_cross_exciting(mu_a, alpha_a, beta_a,
                                         t_end=T_a, seed=11)
        rt = ServingRuntime(n_feeds=D, q=1.0, s_sink=[1.0] * D, seed=5,
                            dir=rt_dir, start_seq=0,
                            snapshot_every=10_000,
                            journal_format="binary", coalesce=4,
                            device=dev)
        seq = _submit_events(rt, ta, da, 0)
        report["events"] = {"regime_a": int(len(ta))}

        # -- 2. learner SIGKILLed mid-fit (real process) -----------------
        before, _ = replay(os.path.join(rt_dir, JOURNAL_FILENAME))
        if not skip_kill:
            env = dict(os.environ)
            env.pop("RQ_SERVING_WORKER", None)
            env["RQ_FAULT"] = "learn:kill@step1"
            # The child imports the package from this checkout.
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
            proc = subprocess.run(
                [sys.executable, "-c", _KILL_CHILD, rt_dir, ck,
                 str(D), str(gamma), str(dev)],
                env=env, capture_output=True, text=True, timeout=600)
            if proc.returncode != -signal.SIGKILL:
                raise RuntimeError(
                    f"learner did not die by SIGKILL (rc="
                    f"{proc.returncode}, stderr tail "
                    f"{proc.stderr[-300:]!r})")
            after, _ = replay(os.path.join(rt_dir, JOURNAL_FILENAME))
            if after != before:
                raise RuntimeError(
                    "learner SIGKILL changed the serving journal")
            if os.path.exists(os.path.join(rt_dir,
                                           "candidate_fit.json")):
                raise RuntimeError("killed learner landed a candidate")
            report["learner_kill"] = {
                "rc": int(proc.returncode), "journal_untouched": True,
                "candidate_absent": True}

        # -- 3. fault-free resume fits regime A, gate installs epoch 1 ---
        em = StreamingEM(rt_dir, n_feeds=D, gamma=gamma, ckpt_path=ck,
                         chunk_size=512, device=dev)
        upd = em.run_once()
        if upd.step != 1 or not upd.candidate:
            raise RuntimeError(f"resumed learner did not emit: {upd}")
        model_a = read_candidate(em.candidate_path)
        sw = ParamSwapper(rt, gate=ParamGate())
        base_a = (holdout_nll(em.holdout, em.mu, em.alpha, em.beta)
                  if em.holdout is not None else None)
        res = sw.poll_artifact(
            em.candidate_path,
            canary=lambda mu, al, be: holdout_nll(em.holdout, mu, al, be),
            baseline_nll=base_a)
        if not (res and res["installed"]):
            raise RuntimeError(f"epoch-1 install failed: {res}")
        stale_sink = rt.live_params()["s_sink"]
        report["epoch_a"] = {"epoch": rt.live_params()["epoch"],
                             "fingerprint": upd.fingerprint,
                             "steps": em.step}

        # -- 4. the regime shifts ---------------------------------------
        tb, db = simulate_cross_exciting(mu_b, alpha_b, beta_b,
                                         t_end=T_a + T_b, seed=12,
                                         t_start=T_a)
        # Learner sees most of B in per-chunk steps (regime adaptation
        # under forgetting), with the final slice timed for latency.
        n_pre = int(0.8 * len(tb))
        cut = max(1, n_pre)
        seq = _submit_events(rt, tb[:cut], db[:cut], seq)
        steps_b = 0
        while True:
            upd = em.run_once()
            if upd.n_events == 0:
                break
            steps_b += 1
            if upd.candidate:
                sw.poll_artifact(
                    em.candidate_path,
                    canary=(lambda mu, al, be: holdout_nll(
                        em.holdout, mu, al, be))
                    if em.holdout is not None else None,
                    baseline_nll=(holdout_nll(em.holdout, em.mu,
                                              em.alpha, em.beta)
                                  if em.holdout is not None else None))
        report["events"]["regime_b"] = int(len(tb))

        # -- 5. the measured closed-loop hot-swap ------------------------
        # Submit the final B slice; the ack (poll returning with the
        # journal durable — sync flush mode) starts the latency clock.
        seq = _submit_events(rt, tb[cut:], db[cut:], seq)
        t_ack = time.monotonic()
        upd = em.run_once()
        t_fit = time.monotonic()
        res = sw.poll_artifact(
            em.candidate_path,
            canary=(lambda mu, al, be: holdout_nll(em.holdout, mu, al,
                                                   be))
            if em.holdout is not None else None,
            baseline_nll=(holdout_nll(em.holdout, em.mu, em.alpha,
                                      em.beta)
                          if em.holdout is not None else None))
        t_live = time.monotonic()
        if not (res and res["installed"]):
            raise RuntimeError(f"post-shift install failed: {res}")
        model_b = read_candidate(em.candidate_path)
        swapped_sink = rt.live_params()["s_sink"]
        final_epoch = rt.live_params()["epoch"]
        final_fp = rt.live_params()["fingerprint"]
        latency_s = t_live - t_ack
        report["latency"] = {
            "journal_write_to_params_live_s": latency_s,
            "fit_s": t_fit - t_ack,
            "gate_install_s": t_live - t_fit,
            "bound_s": BOUNDS["latency_s"],
            "pass": latency_s <= BOUNDS["latency_s"]}

        # -- recovery scoring on a fresh regime-B window -----------------
        win = make_stream(tb[cut:], db[cut:], D,
                          t_end=float(tb[-1]), t_start=float(tb[cut - 1]))
        nll_stale = holdout_nll(win, model_a["mu"], model_a["alpha"],
                                model_a["beta"])
        nll_swap = holdout_nll(win, model_b["mu"], model_b["alpha"],
                               model_b["beta"])
        # Oracle: a fresh fit on regime-B traffic only.
        em_oracle = StreamingEM(
            rt_dir, n_feeds=D, gamma=1.0, chunk_size=512,
            holdout_frac=0.0,
            candidate_path=os.path.join(tmp, "oracle_fit.json"),
            device=dev)
        em_oracle.last_t = float(tb[0]) - 1e-9  # tail B only
        em_oracle.run_once()
        nll_oracle = holdout_nll(win, em_oracle.mu, em_oracle.alpha,
                                 em_oracle.beta)
        gap = nll_stale - nll_oracle
        frac = float((nll_stale - nll_swap) / gap) if gap > 0 else 1.0
        true_sink_b = fit_s_sink((mu_b, alpha_b, beta_b))
        err_stale = float(np.linalg.norm(stale_sink - true_sink_b)
                          / np.linalg.norm(true_sink_b))
        err_swap = float(np.linalg.norm(swapped_sink - true_sink_b)
                         / np.linalg.norm(true_sink_b))
        report["recovery"] = {
            "canary_nll": {"stale": nll_stale, "swapped": nll_swap,
                           "oracle_refit": nll_oracle,
                           "recovery_frac": frac,
                           "bound": BOUNDS["recovery_frac"],
                           "pass": frac >= BOUNDS["recovery_frac"]},
            "s_sink": {"true_b": true_sink_b.tolist(),
                       "stale": np.asarray(stale_sink).tolist(),
                       "swapped": np.asarray(swapped_sink).tolist(),
                       "err_stale": err_stale, "err_swapped": err_swap,
                       "pass": (err_stale - err_swap
                                > BOUNDS["s_sink_improvement"])},
            "learner_steps_b": steps_b}

        # -- 6. close + recover: the audit -------------------------------
        installs = sw.installs
        rejections = sw.rejections
        rt.close()
        rt2, info = recover(rt_dir, device=dev)
        live2 = rt2.live_params()
        plog = _integrity.read_json(
            os.path.join(rt_dir, "params_log.json"),
            schema="rq.serving.params_log/1")
        audit = {
            "recovered_epoch": int(live2["epoch"]),
            "recovered_fingerprint": live2["fingerprint"],
            "epoch_match": int(live2["epoch"]) == int(final_epoch),
            "fingerprint_match": live2["fingerprint"] == final_fp,
            "params_bit_identical": bool(
                np.array_equal(np.asarray(live2["s_sink"], np.float64),
                               np.asarray(swapped_sink, np.float64))),
            "installs_performed": int(installs),
            "rejections": int(rejections),
            "params_log_entries": len(plog["installs"]),
            "accounting_reconciles": (
                len(plog["installs"]) == int(live2["epoch"])
                and int(live2["epoch"]) == int(installs)),
            "lost_acked_seqs": list(info.lost_acked_seqs),
        }
        rt2.close()
        report["audit"] = audit
        report["wall_s"] = round(time.monotonic() - t0_wall, 3)
        report["pass"] = bool(
            report["latency"]["pass"]
            and report["recovery"]["canary_nll"]["pass"]
            and report["recovery"]["s_sink"]["pass"]
            and audit["epoch_match"] and audit["fingerprint_match"]
            and audit["params_bit_identical"]
            and audit["accounting_reconciles"]
            and not audit["lost_acked_seqs"]
            and (skip_kill or report["learner_kill"]["journal_untouched"]))
        report.update(device_fields(dev))
        _integrity.write_json(out, report, schema="rq.learn.live_swap/1")
        return report
    finally:
        if dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="LIVE_SWAP_torch.json")
    ap.add_argument("--quick", action="store_true",
                    help="short horizons (CI)")
    ap.add_argument("--skip-kill", action="store_true",
                    help="skip the subprocess SIGKILL leg (fast local "
                         "iteration; the soak covers it)")
    ap.add_argument("--dir", default=None,
                    help="run in this directory (kept; default: tmp)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    report = run(args.out, quick=args.quick, skip_kill=args.skip_kill,
                 dir=args.dir, device=args.device)
    ok = report["pass"]
    lat = report["latency"]["journal_write_to_params_live_s"]
    rec = report["recovery"]["canary_nll"]["recovery_frac"]
    print(f"live swap {'OK' if ok else 'FAILED'}: closed-loop latency "
          f"{lat * 1e3:.1f} ms, canary recovery {rec:.2f} "
          f"(bound {BOUNDS['recovery_frac']}), epochs "
          f"{report['audit']['recovered_epoch']}, wall "
          f"{report['wall_s']}s -> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
