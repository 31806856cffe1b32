"""The part of the JAX package's ``learn.streaming`` that needs no
serving journal: :func:`holdout_nll`, the exact held-out score.

``StreamingEM``, ``StreamingUpdate`` and ``run_sidecar`` tail the
serving journal and write ``paramswap`` candidates; they come with the
serving layer (ROADMAP.md Queue 1 item 9)."""

from __future__ import annotations

from ..device import DeviceLike, resolve_device
from .ingest import chunk_events
from .loglik import _f32, _params, _score, to_device

__all__ = ["holdout_nll"]


def holdout_nll(stream, mu, alpha, beta, chunk_size: int = 1024,
                device: DeviceLike = "cuda") -> float:
    """Exact negative log-likelihood of ``(mu, alpha, beta)`` on a
    held-back event stream — the canary an install gate compares
    candidate against live on.  One pass + compensator: the SAME
    objective the fit optimizes.  Runs on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    data = chunk_events(stream, chunk_size=chunk_size)
    D = data.n_dims
    mu32, a32, b32 = _params(mu, alpha, beta, D, dev)
    ll, comp, _health = _score(to_device(data, dev),
                               _f32(data.counts, dev),
                               float(data.span), mu32, a32, b32)
    return comp - ll

