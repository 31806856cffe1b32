"""``StarBuilder`` (the star engine's front end) and the small-F DataFrame
export — the counterpart of ``redqueen_tpu.parallel.star_builder``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ConfigValidationError, _require_finite, check_piecewise
from ..device import DeviceLike, resolve_device
from ..models.base import (
    KIND_HAWKES,
    KIND_OPT,
    KIND_PIECEWISE,
    KIND_POISSON,
    KIND_REALDATA,
    KIND_RMTPP,
)
from .star_types import _EMPTY, CtrlParams, StarConfig, StarResult, WallParams

__all__ = ["StarBuilder", "star_to_dataframe"]


class StarBuilder:
    """Assemble a star component: one wall-slot list per feed and exactly
    one controlled broadcaster.  Validates like ``config.GraphBuilder``,
    naming the feed."""

    def __init__(self, n_feeds: int, end_time: float, start_time: float = 0.0,
                 s_sink: Optional[Sequence[float]] = None):
        self.n_feeds = int(n_feeds)
        self.end_time = _require_finite("end_time", end_time)
        self.start_time = _require_finite("start_time", start_time)
        if not self.end_time > self.start_time:
            raise ConfigValidationError(
                f"end_time must be > start_time, got "
                f"[{self.start_time!r}, {self.end_time!r}]")
        self.s_sink = (np.ones(n_feeds) if s_sink is None
                       else np.asarray(s_sink, np.float64))
        if self.s_sink.shape != (self.n_feeds,):
            raise ValueError(
                f"s_sink must have shape ({self.n_feeds},), got "
                f"{self.s_sink.shape}")
        bad = ~(np.isfinite(self.s_sink) & (self.s_sink >= 0))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ConfigValidationError(
                f"s_sink must be finite and >= 0, got {self.s_sink[i]!r} at "
                f"feed {i}")
        self._walls = [[] for _ in range(self.n_feeds)]
        self._ctrl = None

    # ---- wall sources (one feed each) ----

    def wall_poisson(self, feed: int, rate: float):
        rate = _require_finite("Poisson rate", rate, feed, minimum=0.0)
        self._walls[feed].append(dict(kind=KIND_POISSON, rate=rate))
        return self

    def wall_hawkes(self, feed: int, l0: float, alpha: float, beta: float):
        l0 = _require_finite("Hawkes l0 (base rate)", l0, feed, minimum=0.0)
        alpha = _require_finite("Hawkes alpha (jump size)", alpha, feed,
                                minimum=0.0)
        beta = _require_finite("Hawkes beta (decay)", beta, feed,
                               minimum=0.0, strict=True)
        self._walls[feed].append(
            dict(kind=KIND_HAWKES, l0=l0, alpha=alpha, beta=beta))
        return self

    def wall_piecewise(self, feed: int, change_times, rates):
        self._walls[feed].append(
            dict(kind=KIND_PIECEWISE,
                 pw=check_piecewise(change_times, rates, component=feed)))
        return self

    def wall_replay(self, feed: int, times):
        t = np.asarray(times, np.float64)
        if t.size and not np.isfinite(t).all():
            i = int(np.flatnonzero(~np.isfinite(t))[0])
            raise ConfigValidationError(
                f"replay times must be finite, got {t[i]!r} at index {i}",
                feed)
        self._walls[feed].append(dict(kind=KIND_REALDATA, rd=np.sort(t)))
        return self

    # ---- the controlled broadcaster ----

    def ctrl_opt(self, q: float = 1.0):
        if not (np.isfinite(q) and q > 0):
            raise ConfigValidationError(
                f"Opt requires finite q > 0, got q={q!r}")
        self._ctrl = dict(kind=KIND_OPT, q=float(q))
        return self

    def ctrl_poisson(self, rate: float):
        rate = _require_finite("Poisson rate", rate, minimum=0.0)
        self._ctrl = dict(kind=KIND_POISSON, rate=rate)
        return self

    def ctrl_hawkes(self, l0: float, alpha: float, beta: float):
        """Hawkes posting as the controlled broadcaster (it depends only on
        its own history); stationary iff alpha < beta."""
        l0 = _require_finite("Hawkes l0 (base rate)", l0, minimum=0.0)
        alpha = _require_finite("Hawkes alpha (jump size)", alpha,
                                minimum=0.0)
        beta = _require_finite("Hawkes beta (decay)", beta, minimum=0.0,
                               strict=True)
        self._ctrl = dict(kind=KIND_HAWKES, l0=l0, alpha=alpha, beta=beta)
        return self

    def ctrl_piecewise(self, change_times, rates):
        self._ctrl = dict(kind=KIND_PIECEWISE,
                          pw=check_piecewise(change_times, rates))
        return self

    def ctrl_replay(self, times):
        t = np.asarray(times, np.float64)
        if t.size and not np.isfinite(t).all():
            i = int(np.flatnonzero(~np.isfinite(t))[0])
            raise ConfigValidationError(
                f"replay times must be finite, got {t[i]!r} at index {i}")
        self._ctrl = dict(kind=KIND_REALDATA, rd=np.sort(t))
        return self

    def ctrl_rmtpp(self, weights, hidden: int = 16):
        self._ctrl = dict(kind=KIND_RMTPP, rmtpp=weights, hidden=int(hidden))
        return self

    # ---- assembly ----

    def build(self, wall_cap: int = 256, post_cap: int = 1024,
              dtype=torch.float32, device: DeviceLike = "cuda"):
        """``(StarConfig, WallParams, CtrlParams)``, the tensors on
        ``device``."""
        if self._ctrl is None:
            raise ValueError("no controlled broadcaster set (ctrl_* methods)")
        dev = resolve_device(device)
        F = self.n_feeds
        M = max(max((len(w) for w in self._walls), default=0), 1)
        Kp = max(
            [len(w["pw"][0]) for row in self._walls for w in row
             if "pw" in w]
            + ([len(self._ctrl["pw"][0])] if "pw" in self._ctrl else []),
            default=1)
        Kr = max([len(w["rd"]) for row in self._walls for w in row
                  if "rd" in w], default=1)
        kind = np.full((F, M), _EMPTY, np.int32)
        rate = np.ones((F, M))
        l0 = np.ones((F, M))
        alpha = np.zeros((F, M))
        beta = np.ones((F, M))
        pw_t = np.full((F, M, Kp), np.inf)
        pw_t[:, :, 0] = 0.0
        pw_r = np.zeros((F, M, Kp))
        rd_t = np.full((F, M, Kr), np.inf)
        kinds_present = {_EMPTY}
        for f, row in enumerate(self._walls):
            for m, w in enumerate(row):
                kind[f, m] = w["kind"]
                kinds_present.add(int(w["kind"]))
                if w["kind"] == KIND_POISSON:
                    rate[f, m] = w["rate"]
                elif w["kind"] == KIND_HAWKES:
                    l0[f, m] = w["l0"]
                    alpha[f, m] = w["alpha"]
                    beta[f, m] = w["beta"]
                elif w["kind"] == KIND_PIECEWISE:
                    ct, r = w["pw"]
                    pw_t[f, m] = np.inf
                    pw_t[f, m, :len(ct)] = ct
                    pw_r[f, m, :len(r)] = r
                elif w["kind"] == KIND_REALDATA:
                    rd_t[f, m, :len(w["rd"])] = w["rd"]

        c = self._ctrl
        c_pw_t = np.full(Kp, np.inf)
        c_pw_t[0] = 0.0
        c_pw_r = np.zeros(Kp)
        if "pw" in c:
            ct, r = c["pw"]
            c_pw_t[:] = np.inf
            c_pw_t[:len(ct)] = ct
            c_pw_r[:len(r)] = r
        c_rd = (np.asarray(c["rd"], np.float64) if "rd" in c
                else np.full(1, np.inf))
        cfg = StarConfig(
            n_feeds=F, walls_per_feed=M, end_time=self.end_time,
            start_time=self.start_time, wall_cap=int(wall_cap),
            post_cap=int(post_cap), ctrl_kind=int(c["kind"]),
            rmtpp_hidden=int(c.get("hidden", 1)),
            wall_kinds=tuple(sorted(kinds_present)))

        def t(x, dt=dtype):
            return torch.from_numpy(np.asarray(x)).to(dev, dt)

        wall = WallParams(
            kind=t(kind, torch.int32), rate=t(rate), l0=t(l0),
            alpha=t(alpha), beta=t(beta), pw_times=t(pw_t),
            pw_rates=t(pw_r), rd_times=t(rd_t), s_sink=t(self.s_sink))
        ctrl = CtrlParams(
            q=t(c.get("q", 1.0)), rate=t(c.get("rate", 1.0)),
            pw_times=t(c_pw_t), pw_rates=t(c_pw_r), rd_times=t(c_rd),
            l0=t(c.get("l0", 0.0)), alpha=t(c.get("alpha", 0.0)),
            beta=t(c.get("beta", 1.0)), rmtpp=c.get("rmtpp"))
        return cfg, wall, ctrl


def star_to_dataframe(res: StarResult, src_id=0, wall_src_offset: int = 100):
    """A star run as the reference-schema event DataFrame (one row per
    (event, sink); columns event_id/t/time_delta/src_id/sink_id), for
    small-F validation (``utils.dataframe.star_events_to_dataframe``;
    pandas is imported there only)."""
    from ..utils.dataframe import star_events_to_dataframe

    return star_events_to_dataframe(res, src_id, wall_src_offset)
