"""Enveloped fit checkpoints — ``rq.learn.fit/1``, as the JAX package's
``learn.ckpt`` writes them (same schema, meta record and fingerprint
digest, so either package reads the other's artifact).

One artifact format for every resumable fit of the port (the Hawkes
solvers in ``learn.hawkes_mle``, ``models.rmtpp.fit``): a checksummed
NPZ envelope (``runtime.integrity.savez`` — atomic rename + sha256
verify-on-read + quarantine) holding the fit's array state plus a JSON
meta record, keyed by a FINGERPRINT of everything that determines the
trajectory (data bytes + solver configuration).  A resumed
fit only trusts a checkpoint whose fingerprint matches bit-for-bit;
stale (edited inputs) loads as None and the fit restarts — silently
mixing trajectories is the failure mode this prevents.  A corrupt file
is quarantined by ``load_npz`` (``*.corrupt-<ts>`` + report) and the fit
restarts too: corruption is never a crash and never trusted.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..runtime import integrity as _integrity

__all__ = ["FIT_SCHEMA", "save_fit", "load_fit", "fingerprint_arrays"]

FIT_SCHEMA = "rq.learn.fit/1"
_META_KEY = "fit_meta"


def fingerprint_arrays(config: Dict[str, Any], *arrays) -> str:
    """Content hash of a fit's inputs: the solver config (repr of a
    key-sorted dict — keep values primitive) plus every data array's
    dtype + shape + raw bytes."""
    h = hashlib.sha256()
    h.update(repr(sorted(config.items())).encode())
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def save_fit(path: str, fingerprint: str, step: int,
             arrays: Dict[str, np.ndarray],
             meta: Optional[Dict[str, Any]] = None) -> None:
    """Atomically land a fit checkpoint (called at durable boundaries —
    the fitter heartbeats + honors preemption right after)."""
    if _META_KEY in arrays:
        raise ValueError(f"array name {_META_KEY!r} is reserved")
    record = {"fingerprint": str(fingerprint), "step": int(step),
              "meta": dict(meta or {})}
    _integrity.savez(
        path, schema=FIT_SCHEMA,
        **{k: np.asarray(v) for k, v in arrays.items()},
        **{_META_KEY: np.asarray(json.dumps(record))})


def load_fit(path: str, fingerprint: str
             ) -> Optional[Tuple[int, Dict[str, np.ndarray],
                                 Dict[str, Any]]]:
    """Load a checkpoint for THIS fit; returns ``(step, arrays, meta)``
    or None when there is nothing trustworthy to resume from (missing
    file; corrupt → quarantined by ``load_npz``; schema or fingerprint
    mismatch → stale, left on disk untouched)."""
    try:
        z = _integrity.load_npz(path, schema=FIT_SCHEMA,
                                quarantine_schema_mismatch=False)
    except FileNotFoundError:
        return None
    except _integrity.CorruptArtifactError:
        # Quarantined (or schema-stale, left in place): recompute.
        return None
    try:
        record = json.loads(str(z.pop(_META_KEY)))
        step = int(record["step"])
        fp = str(record["fingerprint"])
        meta = dict(record.get("meta", {}))
    except (KeyError, ValueError, TypeError):
        return None  # layout drift without a schema bump: stale
    if fp != str(fingerprint):
        return None  # different data/config: never mix trajectories
    return step, z, meta
