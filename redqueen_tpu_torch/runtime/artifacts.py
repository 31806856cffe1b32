"""Crash-consistent artifacts, the counterpart of the JAX package's
``runtime.artifacts``: write to a temp file in the same directory,
fsync, then ``os.replace``, so that a reader sees either the previous
whole file or the new one, never a torn one."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

__all__ = ["atomic_write_json", "atomic_write_text", "atomic_write_lines",
           "atomic_savez"]


def _atomic_commit(path: str, write_body) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_body(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def atomic_write_text(path: str, text: str) -> None:
    _atomic_commit(path, lambda f: f.write(text.encode()))


def atomic_write_lines(path: str, lines) -> None:
    """Stream an iterable of text lines into the atomic commit, for
    corpora too large to hold as one string."""
    def body(f):
        for line in lines:
            f.write(line.encode())

    _atomic_commit(path, body)


def atomic_write_json(path: str, obj: Any, indent=None,
                      trailing_newline: bool = True) -> None:
    """Serialize ``obj`` and atomically replace ``path`` with it."""
    text = json.dumps(obj, indent=indent)
    if trailing_newline:
        text += "\n"
    atomic_write_text(path, text)


def atomic_savez(path: str, **arrays) -> None:
    """Atomic ``np.savez``: the temp file is passed as an open handle so
    numpy cannot append ``.npz`` to the name and dodge the rename."""
    import numpy as np

    _atomic_commit(path, lambda f: np.savez(f, **arrays))
