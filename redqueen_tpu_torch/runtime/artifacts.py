"""Crash-consistent JSON artifacts (the part of the JAX package's
``runtime.artifacts`` the lane autotuner uses): write to a temp file in
the same directory, fsync, then ``os.replace``, so that a reader sees
either the previous whole file or the new one, never a torn one."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

__all__ = ["atomic_write_json", "atomic_write_text"]


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


def atomic_write_json(path: str, obj: Any, indent=None,
                      trailing_newline: bool = True) -> None:
    """Serialize ``obj`` and atomically replace ``path`` with it."""
    text = json.dumps(obj, indent=indent)
    if trailing_newline:
        text += "\n"
    atomic_write_text(path, text)
