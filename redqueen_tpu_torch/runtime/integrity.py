"""Artifact integrity: checksummed envelopes, verify-on-read, quarantine.

A copy of the JAX package's ``runtime.integrity`` for the port, with the
same envelope keys, schema strings and digests, so that each package
reads and verifies an artifact the other wrote.

``runtime.artifacts`` guarantees a reader never sees a TORN file (atomic
rename); this module closes the other half of the loop — never TRUST a
bad one.  Every artifact written through :func:`write_json` /
:func:`savez` carries a self-describing envelope (sha256 of the payload,
schema tag, envelope version, writer metadata), and every read verifies
it.  A file that fails verification — truncated by a non-atomic writer,
bit-flipped by a bad disk/copy, or carrying a stale/forged checksum — is
QUARANTINED: renamed to ``<path>.corrupt-<ts>`` next to a structured
report artifact, and a typed :class:`CorruptArtifactError` is raised so
the caller can fall back to last-good state.  Corruption is never a
silent crash and never a silently-trusted value.

Envelope formats
----------------
JSON (one object, the payload nested)::

    {"__rq_envelope__": 1, "schema": "<tag>",
     "sha256": "<hex over canonical {schema, writer, payload} JSON>",
     "writer": {"pid": ..., "host": ..., "time_utc": ..., "argv0": ...},
     "payload": <the artifact>}

NPZ (payload arrays untouched, one extra entry)::

    __rq_envelope__ = 0-d str array holding the same envelope object
    (minus "payload"), its "sha256" computed over the canonical
    {schema, writer} JSON plus every payload array's name + dtype +
    shape + raw bytes, sorted by name.

The digest deliberately covers schema and writer metadata too: a bit
flip ANYWHERE semantic in the file either mismatches the digest or
breaks the parse — nothing in an artifact is silently mutable.

The canonical-bytes rules mean verification is deterministic across
processes and platforms.  Writer metadata is informational for READERS
(nothing branches on it) but it IS digested — editing it in place
invalidates the artifact like any other mutation.

Stdlib + numpy only (numpy imported lazily).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

from .artifacts import atomic_write_json

__all__ = [
    "CorruptArtifactError",
    "ENVELOPE_KEY",
    "ENVELOPE_VERSION",
    "write_json",
    "read_json",
    "savez",
    "load_npz",
    "quarantine",
    "make_envelope",
    "verify_envelope",
]

ENVELOPE_KEY = "__rq_envelope__"
ENVELOPE_VERSION = 1


class CorruptArtifactError(RuntimeError):
    """An artifact failed verification on read.  Carries where the bad
    file went (``quarantined_to``/``report_path`` are None when the
    caller opted out of quarantine) so recovery code can log precisely
    and fall back to last-good state."""

    def __init__(self, path: str, reason: str,
                 quarantined_to: Optional[str] = None,
                 report_path: Optional[str] = None):
        self.path = path
        self.reason = reason
        self.quarantined_to = quarantined_to
        self.report_path = report_path
        where = (f" (quarantined to {quarantined_to})"
                 if quarantined_to else "")
        super().__init__(f"corrupt artifact {path}: {reason}{where}")


def _utc_iso(clock=time.time) -> str:
    return _dt.datetime.fromtimestamp(
        clock(), _dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _writer_meta() -> Dict[str, Any]:
    import platform

    return {
        "pid": os.getpid(),
        "host": platform.node(),
        "time_utc": _utc_iso(),
        "argv0": os.path.basename(sys.argv[0]) if sys.argv else "",
    }


def _canonical_json_bytes(payload: Any) -> bytes:
    """The digest input for a JSON payload: key-sorted, minimal
    separators — independent of the indent/ordering the file was
    prettified with."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


def _json_digest(schema: Any, writer: Any, payload: Any) -> str:
    """Digest over schema + writer + payload (everything semantic in the
    envelope except the digest itself): a bit flip anywhere meaningful —
    including the writer-metadata block — mismatches, and a flip in
    structural whitespace/keys breaks the parse instead."""
    return hashlib.sha256(_canonical_json_bytes(
        {"schema": schema, "writer": writer, "payload": payload}
    )).hexdigest()


def _npz_digest(arrays: Dict[str, Any], schema: Any, writer: Any) -> str:
    """Digest over schema + writer + every payload array's name + dtype +
    shape + raw bytes, sorted by name — the same canonical-bytes idiom as
    the sweep chunk fingerprint, so a single flipped bit anywhere
    semantic changes it."""
    import numpy as np

    h = hashlib.sha256()
    h.update(_canonical_json_bytes({"schema": schema, "writer": writer}))
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# Quarantine
# --------------------------------------------------------------------------

def quarantine(path: str, reason: str, detail: str = "",
               clock=time.time) -> Tuple[str, str]:
    """Move a corrupt artifact out of the read path — NEVER delete it
    (the bytes are evidence) and never leave it where the next reader
    trusts it.  Renames ``path`` to ``<path>.corrupt-<utc-ts>`` (a
    numeric suffix disambiguates collisions) and writes an enveloped
    ``...report.json`` next to it recording what was detected.  Works on
    files and on directories.  Returns
    ``(quarantined_path, report_path)``."""
    ts = _dt.datetime.fromtimestamp(
        clock(), _dt.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    qpath = f"{path}.corrupt-{ts}"
    n = 0
    while os.path.exists(qpath):
        n += 1
        qpath = f"{path}.corrupt-{ts}-{n}"
    os.replace(path, qpath)
    report_path = f"{qpath}.report.json"
    write_json(report_path, {
        "original": os.path.abspath(path),
        "quarantined_to": os.path.abspath(qpath),
        "reason": reason,
        "detail": detail,
        "time_utc": _utc_iso(clock),
    }, schema="rq.quarantine-report/1")
    return qpath, report_path


def _reject(path: str, reason: str, detail: str = "",
            do_quarantine: bool = True) -> CorruptArtifactError:
    qpath = report = None
    if do_quarantine and os.path.exists(path):
        qpath, report = quarantine(path, reason, detail)
    return CorruptArtifactError(path, reason, qpath, report)


# --------------------------------------------------------------------------
# JSON envelopes
# --------------------------------------------------------------------------

def make_envelope(payload: Any, schema: str = "rq.json/1") -> Dict[str, Any]:
    """The checksummed envelope OBJECT for ``payload`` — exactly what
    :func:`write_json` lands on disk, as a dict.  Public so in-memory /
    line-oriented consumers (the serving journal appends one envelope per
    JSONL record) reuse the one digest definition instead of inventing a
    second checksum format."""
    writer = _writer_meta()
    return {
        ENVELOPE_KEY: ENVELOPE_VERSION,
        "schema": schema,
        "sha256": _json_digest(schema, writer, payload),
        "writer": writer,
        "payload": payload,
    }


def verify_envelope(obj: Any, schema: Optional[str] = None,
                    where: str = "<envelope>") -> Any:
    """Verify an in-memory envelope object; returns the payload.

    The non-file twin of :func:`read_json`'s checks (no quarantine — the
    caller owns the bytes): a non-envelope object, malformed keys, a
    digest mismatch, or a ``schema`` mismatch raise
    :class:`CorruptArtifactError` with ``quarantined_to=None`` and
    ``where`` standing in for the path."""
    if not (isinstance(obj, dict) and ENVELOPE_KEY in obj):
        raise CorruptArtifactError(where, "no integrity envelope")
    if not isinstance(obj.get("sha256"), str) or "payload" not in obj:
        raise CorruptArtifactError(
            where, f"malformed envelope (keys: {sorted(obj)})")
    got = _json_digest(obj.get("schema"), obj.get("writer"), obj["payload"])
    if got != obj["sha256"]:
        raise CorruptArtifactError(
            where, f"checksum mismatch (stored {obj['sha256'][:12]}.. != "
                   f"computed {got[:12]}..)")
    if schema is not None and obj.get("schema") != schema:
        raise CorruptArtifactError(
            where, f"schema mismatch (want {schema!r}, "
                   f"found {obj.get('schema')!r})")
    return obj["payload"]


def write_json(path: str, payload: Any, schema: str = "rq.json/1",
               indent=1) -> None:
    """Atomically write ``payload`` wrapped in a checksummed envelope.
    ``schema`` tags what the payload IS (bump the suffix on layout
    changes so readers can migrate deliberately)."""
    atomic_write_json(path, make_envelope(payload, schema), indent=indent)


def read_json(path: str, schema: Optional[str] = None,
              do_quarantine: bool = True,
              allow_unverified: bool = False) -> Any:
    """Read + verify an enveloped JSON artifact; returns the payload.

    A missing file raises ``FileNotFoundError`` (absence is not
    corruption).  Anything unreadable, unparseable, or failing the
    checksum/schema check is quarantined (unless ``do_quarantine`` is
    False) and raises :class:`CorruptArtifactError`.  A parseable file
    WITHOUT an envelope is corruption by default; pass
    ``allow_unverified=True`` to accept such a legacy/foreign file as-is
    (the caller owns the risk — use for pre-envelope artifacts only)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no artifact at {path}")
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise _reject(path, "unreadable/unparseable JSON", str(e),
                      do_quarantine) from e
    if not (isinstance(obj, dict) and ENVELOPE_KEY in obj):
        if allow_unverified:
            return obj
        raise _reject(path, "no integrity envelope",
                      "file parses but carries no checksum", do_quarantine)
    if not isinstance(obj.get("sha256"), str) or "payload" not in obj:
        raise _reject(path, "malformed envelope",
                      f"keys: {sorted(obj)}", do_quarantine)
    got = _json_digest(obj.get("schema"), obj.get("writer"),
                       obj["payload"])
    if got != obj["sha256"]:
        raise _reject(
            path, "checksum mismatch",
            f"stored {obj['sha256'][:12]}.. != computed {got[:12]}..",
            do_quarantine)
    if schema is not None and obj.get("schema") != schema:
        raise _reject(path, "schema mismatch",
                      f"want {schema!r}, found {obj.get('schema')!r}",
                      do_quarantine)
    return obj["payload"]


# --------------------------------------------------------------------------
# NPZ envelopes
# --------------------------------------------------------------------------

def savez(path: str, schema: str = "rq.npz/1", **arrays) -> None:
    """Atomic ``np.savez`` with a checksummed envelope entry riding in
    the archive (self-contained: no sidecar file to lose)."""
    import numpy as np

    from .artifacts import atomic_savez

    if ENVELOPE_KEY in arrays:
        raise ValueError(f"array name {ENVELOPE_KEY!r} is reserved")
    writer = _writer_meta()
    env = {
        ENVELOPE_KEY: ENVELOPE_VERSION,
        "schema": schema,
        "sha256": _npz_digest(arrays, schema, writer),
        "writer": writer,
    }
    atomic_savez(path, **arrays,
                 **{ENVELOPE_KEY: np.asarray(json.dumps(env))})


def load_npz(path: str, schema: Optional[str] = None,
             do_quarantine: bool = True,
             quarantine_schema_mismatch: bool = True) -> Dict[str, Any]:
    """Read + verify an enveloped NPZ; returns ``{name: array}`` for the
    payload arrays only.  Same contract as :func:`read_json`: missing →
    ``FileNotFoundError``; torn zip, missing envelope, flipped payload
    bit, or bad stored checksum → quarantine + CorruptArtifactError.
    (NPZ has no legacy mode: a pre-envelope archive cannot be verified,
    and every producer in-repo writes envelopes — recompute instead.)

    ``quarantine_schema_mismatch=False`` narrows the quarantine to REAL
    corruption: a checksum-valid archive whose ``schema`` tag merely
    differs (a layout written by an older/newer version) still raises
    ``CorruptArtifactError`` (``reason == "schema mismatch"``,
    ``quarantined_to is None``) but stays on disk untouched — stale is
    not corrupt, and a resume that recomputes-and-overwrites must not
    litter the directory with false corruption reports."""
    import numpy as np

    if not os.path.exists(path):
        raise FileNotFoundError(f"no artifact at {path}")
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:  # BadZipFile / OSError / ValueError / zlib
        raise _reject(path, "unreadable NPZ archive", str(e),
                      do_quarantine) from e
    if ENVELOPE_KEY not in arrays:
        raise _reject(path, "no integrity envelope",
                      f"entries: {sorted(arrays)}", do_quarantine)
    try:
        env = json.loads(str(arrays.pop(ENVELOPE_KEY)))
        stored = env["sha256"]
    except (ValueError, KeyError, TypeError) as e:
        raise _reject(path, "malformed envelope", str(e),
                      do_quarantine) from e
    got = _npz_digest(arrays, env.get("schema"), env.get("writer"))
    if got != stored:
        raise _reject(path, "checksum mismatch",
                      f"stored {str(stored)[:12]}.. != computed "
                      f"{got[:12]}..", do_quarantine)
    if schema is not None and env.get("schema") != schema:
        raise _reject(path, "schema mismatch",
                      f"want {schema!r}, found {env.get('schema')!r}",
                      do_quarantine and quarantine_schema_mismatch)
    return arrays
