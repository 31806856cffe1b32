"""Event traces for real-data replay, the part of the JAX package's
``data/traces.py`` that BASELINE configs 4 and 5 need, in numpy: the
heavy-tailed synthetic corpus, padding, the star component built from a
corpus and the gap sequences RMTPP trains on.  The CSV and npz loaders,
normalisation and bucketing wait for ROADMAP.md Queue 1 item 10."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike

__all__ = ["Traces", "pad_traces", "gaps_from_traces", "synthetic_twitter",
           "star_from_traces"]

Traces = List[np.ndarray]  # one ascending float64 time array per user


def pad_traces(traces: Traces, length: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad to a ``[U, L]`` float array (+inf tail) plus lengths ``[U]``."""
    lens = np.array([len(t) for t in traces], np.int64)
    L = int(lens.max()) if length is None else int(length)
    if length is not None and lens.max() > length:
        raise ValueError(
            f"trace of length {int(lens.max())} exceeds requested pad length "
            f"{length} — refusing to truncate silently")
    out = np.full((len(traces), max(L, 1)), np.inf, np.float64)
    for i, t in enumerate(traces):
        out[i, :len(t)] = t
    return out, lens


def gaps_from_traces(traces: Traces, length: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user inter-event gaps for likelihood training
    (``models.rmtpp.fit``): ``(taus [U, L], mask [U, L])``, float64 zero
    padding with a boolean validity mask.  The first gap is measured
    from t = 0, where the policy's recurrent state starts; empty traces
    become all-masked rows.  A trace longer than ``length`` raises."""
    gaps = [np.diff(t, prepend=0.0) if len(t) else np.empty(0)
            for t in traces]
    lens = np.array([len(g) for g in gaps], np.int64)
    L = (int(max(lens.max() if len(lens) else 0, 1)) if length is None
         else int(length))
    if lens.max(initial=0) > L:
        raise ValueError(
            f"trace with {int(lens.max())} events exceeds requested length "
            f"{L} — refusing to truncate silently")
    taus = np.zeros((len(traces), L), np.float64)
    mask = np.zeros((len(traces), L), bool)
    for i, g in enumerate(gaps):
        taus[i, : len(g)] = g
        mask[i, : len(g)] = True
    return taus, mask


def synthetic_twitter(seed: int, n_users: int, end_time: float,
                      mean_rate: float = 1.0, sigma: float = 1.0,
                      diurnal: float = 0.5, max_len: Optional[int] = None
                      ) -> Traces:
    """Heavy-tailed synthetic posting corpus: log-normal per-user base
    rates modulated by a sinusoidal diurnal profile, sampled exactly by
    thinning against each user's peak rate (the same numpy draws, in the
    same order, as the JAX package's, so a seed gives the same corpus)."""
    rng = np.random.RandomState(seed)
    base = rng.lognormal(mean=np.log(mean_rate) - sigma ** 2 / 2,
                         sigma=sigma, size=n_users)
    out = []
    for u in range(n_users):
        peak = base[u] * (1 + diurnal)
        n = rng.poisson(peak * end_time)
        t = np.sort(rng.uniform(0, end_time, n))
        lam = base[u] * (1 + diurnal * np.sin(
            2 * np.pi * t / max(end_time / 4, 1e-9)))
        keep = rng.uniform(0, peak, n) < lam
        t = t[keep]
        if max_len is not None and len(t) > max_len:
            t = t[np.sort(rng.choice(len(t), max_len, replace=False))]
        out.append(t)
    return out


def star_from_traces(traces: Traces, end_time: float, ctrl: str = "opt",
                     q: float = 1.0, ctrl_times: Optional[np.ndarray] = None,
                     s_sink: Optional[Sequence[float]] = None,
                     post_cap: int = 2048, device: DeviceLike = "cuda"):
    """The BASELINE config-4 star component: one controlled broadcaster
    (``"opt"``, or ``"replay"`` of ``ctrl_times``) against one replay wall
    per trace.  Returns ``(cfg, wall, ctrl_params)`` on ``device``."""
    from ..parallel.star_builder import StarBuilder

    padded, lens = pad_traces(traces)
    F = padded.shape[0]
    sb = StarBuilder(n_feeds=F, end_time=end_time, s_sink=s_sink)
    for f in range(F):
        sb.wall_replay(f, padded[f, :lens[f]])
    if ctrl == "opt":
        sb.ctrl_opt(q=q)
    elif ctrl == "replay":
        if ctrl_times is None:
            raise ValueError('ctrl="replay" requires ctrl_times')
        sb.ctrl_replay(ctrl_times)
    else:
        raise ValueError(f"unknown ctrl {ctrl!r}")
    return sb.build(wall_cap=max(int(lens.max()), 1), post_cap=post_cap,
                    device=device)
