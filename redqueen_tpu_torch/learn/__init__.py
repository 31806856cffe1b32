"""redqueen_tpu_torch.learn — multivariate Hawkes estimation on the card
(the counterpart of the JAX package's ``redqueen_tpu.learn``).

The learning subsystem closes the simulate→fit→control loop: fit
``(mu, alpha, beta)`` of an exponential-kernel multivariate Hawkes model
from an event log, then feed the learned parameters back into a
RedQueen-controlled simulation.

- ``learn.ingest``     — adapters (simulator ``EventLog``, per-user
  trace corpora) → one chunked fit format.
- ``learn.loglik``     — the exact O(n) recursive log-likelihood: one
  pass through the hand-written ``hawkes_pass`` kernel on the card (its
  plain PyTorch version on the CPU), per-dimension health bits.
- ``learn.hawkes_mle`` — the two solvers (MM/EM, Frank-Wolfe) behind
  :func:`fit_hawkes`; enveloped ``rq.learn.fit/1`` resume checkpoints.
- ``learn.control``    — fitted :class:`HawkesFit` → ``add_hawkes``
  sources for re-simulation under control; stationary rates and the
  seeded cross-exciting ground-truth simulator.
- ``learn.streaming``  — :func:`holdout_nll`; the journal-tailing
  ``StreamingEM`` comes with the serving layer (ROADMAP.md Queue 1
  item 9).
- ``learn.ckpt``       — the shared fit-checkpoint envelope (also used by
  ``models.rmtpp.fit``).
"""

from __future__ import annotations

from .ckpt import FIT_SCHEMA
from .control import (
    add_fit_walls,
    builder_params,
    control_component,
    control_cost,
    cross_excitation_mass,
    fit_s_sink,
    simulate_cross_exciting,
    stationary_rates,
)
from .hawkes_mle import SOLVERS, FitError, HawkesFit, fit_hawkes
from .ingest import (
    ChunkedEvents,
    EventStream,
    StreamValidationError,
    chunk_events,
    from_event_log,
    from_journal,
    from_traces,
)
from .loglik import LoglikResult, hawkes_loglik
from .streaming import holdout_nll

__all__ = [
    "EventStream",
    "ChunkedEvents",
    "StreamValidationError",
    "chunk_events",
    "from_event_log",
    "from_traces",
    "from_journal",
    "hawkes_loglik",
    "LoglikResult",
    "fit_hawkes",
    "HawkesFit",
    "FitError",
    "SOLVERS",
    "FIT_SCHEMA",
    "builder_params",
    "cross_excitation_mass",
    "add_fit_walls",
    "control_component",
    "control_cost",
    "stationary_rates",
    "fit_s_sink",
    "simulate_cross_exciting",
    "holdout_nll",
]
