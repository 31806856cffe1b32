"""ctypes binding and on-demand build of the native trace loader, the
counterpart of ``redqueen_tpu.native.loader``.

``trace_loader.cpp`` (the port's own copy) is compiled with ``g++ -O3
-shared -fPIC -std=c++17`` once per source revision into
``redqueen_tpu_torch/_build/_trace_loader-<sha>.so``, at first use, and
bound with ctypes; :func:`load_csv_native` has the semantics of
``data.traces.load_csv``.  No compiler, a failed build or an unloadable
object raises :class:`NativeBuildError` (cached); :func:`available` is
then False and ``load_csv(engine="auto")`` takes the Python parser,
while ``engine="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

__all__ = ["available", "build", "load_csv_native", "NativeBuildError"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "trace_loader.cpp")
# Where builds land: the package's git-ignored build directory.
_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class NativeBuildError(RuntimeError):
    """The native component could not be built/loaded (see message)."""


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_DIR, f"_trace_loader-{sha}.so")


def _compile(so: str) -> None:
    # Compile to a per-pid temp name and rename into place: concurrent
    # processes must never CDLL-load a half-written object. rename is
    # atomic within the directory; the loser's rename simply replaces the
    # identical winner.
    os.makedirs(_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    try:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=120)
        except subprocess.SubprocessError as e:  # TimeoutExpired etc.
            raise NativeBuildError(f"native build did not finish: {e}") from e
        if r.returncode != 0:
            raise NativeBuildError(
                f"native build failed (rc={r.returncode}):\n{r.stderr[-2000:]}"
            )
        os.rename(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    # A source edit changes the sha in the artifact name; sweep the
    # orphaned siblings so binaries don't accumulate in the build dir.
    for old in os.listdir(_DIR):
        if (old.startswith("_trace_loader-") and old.endswith(".so")
                and os.path.join(_DIR, old) != so):
            try:
                os.remove(os.path.join(_DIR, old))
            except OSError:
                pass


def build(force: bool = False) -> ctypes.CDLL:
    """Compile (if the source changed) and load the shared object.

    Raises :class:`NativeBuildError` on any failure; cache the failure so
    repeated callers don't re-run the compiler."""
    global _lib, _build_error
    with _lock:
        if _lib is not None and not force:
            return _lib
        if _build_error is not None and not force:
            raise NativeBuildError(_build_error)
        try:
            so = _so_path()
            if force or not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
        except NativeBuildError as e:
            _build_error = str(e)
            raise
        except OSError as e:  # missing g++, unloadable .so, unreadable src
            _build_error = f"native loader unavailable: {e}"
            raise NativeBuildError(_build_error) from e

        lib.rq_parse_csv.restype = ctypes.c_void_p
        lib.rq_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.rq_n_users.restype = ctypes.c_long
        lib.rq_n_users.argtypes = [ctypes.c_void_p]
        lib.rq_total_events.restype = ctypes.c_long
        lib.rq_total_events.argtypes = [ctypes.c_void_p]
        lib.rq_n_nonmonotonic.restype = ctypes.c_long
        lib.rq_n_nonmonotonic.argtypes = [ctypes.c_void_p]
        lib.rq_n_duplicates.restype = ctypes.c_long
        lib.rq_n_duplicates.argtypes = [ctypes.c_void_p]
        lib.rq_fill.restype = None
        lib.rq_fill.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.rq_free.restype = None
        lib.rq_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """True iff the native loader builds/loads on this machine."""
    try:
        build()
        return True
    except NativeBuildError:
        return False


def load_csv_native(path: str, user_col: int = 0, time_col: int = 1,
                    delimiter: str = ",", skip_header: int = 1,
                    return_stats: bool = False):
    """Native twin of ``data.traces.load_csv`` — same rows in, same
    per-user ascending arrays out (equality pinned by
    tests/test_torch_native_loader.py).

    ``return_stats=True`` returns ``(traces, LoadStats)`` — row/user
    counts plus the duplicate-timestamp and non-monotonic-row counts the
    parse observed (the serving reorder window's measured input
    contract; see ``data.traces.LoadStats``).  A row whose timestamp
    cannot be ordered (NaN) raises the typed
    ``data.traces.TraceOrderError`` in BOTH engines instead of being
    silently sorted somewhere."""
    if len(delimiter.encode()) != 1:  # one BYTE: the C ABI takes c_char
        raise ValueError("native loader needs a single-byte delimiter")
    if user_col < 0 or time_col < 0:
        raise ValueError(
            "native loader needs non-negative column indices (the C side "
            "would index out of bounds); use engine='python' for negative "
            "indexing"
        )
    lib = build()
    errbuf = ctypes.create_string_buffer(512)
    h = lib.rq_parse_csv(
        os.fsencode(path), user_col, time_col, delimiter.encode(),
        skip_header, errbuf, len(errbuf),
    )
    if not h:
        import re

        msg = errbuf.value.decode(errors="replace") or "parse failed"
        # Anchored on the C error's own prefix, not a bare substring —
        # a field VALUE containing the word (e.g. a bad float
        # 'unorderable') must stay a generic parse error.
        if re.match(r"line \d+: unorderable timestamp", msg):
            from ..data.traces import TraceOrderError

            raise TraceOrderError(f"{path}: {msg}")
        raise ValueError(f"{path}: {msg}")
    try:
        n_users = lib.rq_n_users(h)
        total = lib.rq_total_events(h)
        times = np.empty(total, np.float64)
        offsets = np.empty(n_users + 1, np.int64)
        lib.rq_fill(h, times, offsets)
        n_nonmono = lib.rq_n_nonmonotonic(h)
        n_dups = lib.rq_n_duplicates(h)
    finally:
        lib.rq_free(h)
    if n_users == 0:
        out: List[np.ndarray] = []  # np.split would invent one user
    else:
        # OWNING copies, deliberately: np.split views over one backing
        # buffer would pin the whole corpus in memory for as long as any
        # single user's trace is retained, and would differ observably
        # (.base) from the Python engine's owning arrays. The copies cost
        # ~10% of the parse.
        out = [a.copy() for a in np.split(times, offsets[1:-1])]
    if not return_stats:
        return out
    from ..data.traces import LoadStats

    return out, LoadStats(
        n_rows=int(total), n_users=int(n_users),
        duplicate_timestamps=int(n_dups),
        non_monotonic_rows=int(n_nonmono))
