"""Liveness probing of the card, the counterpart of
``redqueen_tpu.utils.backend``.

A card whose context has wedged can hang the first CUDA call
of a process instead of raising, and an in-process ``try`` cannot catch
a hang.  So the probe runs in a SUBPROCESS with a deadline: it creates a
CUDA context (``torch.zeros(1, device="cuda")``, then
``torch.cuda.synchronize()``) and prints ``PROBE_OK <count> cuda``.

Stated difference from the JAX package: its ``ensure_live_backend``
flips the whole process to the CPU (``jax_platforms``).  torch has no
process-wide platform switch and the port's device is always explicit,
so :func:`ensure_live_backend` here changes no global state: it returns
the device the caller should pass as ``device=`` (``"cpu"`` after a
failed probe, logged).  No entry point of the port calls it to carry on
without the card: they run on the card unless the caller asks for the
CPU, and raise without one (``device.resolve_device``)."""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Optional, Sequence, Tuple

__all__ = ["probe_default_backend", "parse_last_json_line",
           "default_backend_alive", "ensure_live_backend"]

_PROBE = ("import torch; torch.zeros(1, device='cuda'); "
          "torch.cuda.synchronize(); "
          "print('PROBE_OK', torch.cuda.device_count(), 'cuda')")


def _stderr_log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_last_json_line(text: Optional[str], require_ok: bool = False):
    """The last stdout line that is a JSON dict (the child-process result
    protocol), or ``None``.  With ``require_ok`` only a dict carrying a
    truthy ``"ok"`` counts."""
    import json

    for line in reversed((text or "").strip().splitlines()):
        try:
            obj = json.loads(line)
        except (json.JSONDecodeError, ValueError):
            continue
        if isinstance(obj, dict) and (not require_ok or obj.get("ok")):
            return obj
    return None


def default_backend_alive(
    log: Optional[Callable] = None,
    deadlines: Sequence[float] = (90.0, 40.0),
    backoff_s: float = 15.0,
) -> Tuple[bool, int, str]:
    """The liveness policy: one probe per deadline, ``backoff_s`` apart,
    until one succeeds.  Returns the last probe's ``(alive, n_devices,
    platform)``."""
    for attempt, deadline_s in enumerate(deadlines):
        alive, n, plat = probe_default_backend(deadline_s, log=log)
        if alive:
            if log:
                log(f"default backend alive: {n} x {plat}")
            return True, n, plat
        if attempt + 1 < len(deadlines):
            if log:
                log(f"probe attempt {attempt + 1}/{len(deadlines)} failed; "
                    f"retrying in {backoff_s:.0f}s")
            time.sleep(backoff_s)
    return False, 0, ""


def ensure_live_backend(log: Callable = _stderr_log,
                        deadlines: Sequence[float] = (90.0, 40.0)) -> str:
    """Probe the card (:func:`default_backend_alive`) and return the
    device the caller should use: ``"cuda"`` when it answered, ``"cpu"``
    (logged) when it did not.  Changes no global state (see the module's
    docstring); record the returned device in any artifact written, so
    that a CPU run never passes as a card measurement."""
    alive, _n, plat = default_backend_alive(log=log, deadlines=deadlines)
    if alive:
        return plat
    if log:
        log("the card did not answer within the probe deadlines; the "
            "caller should run on the CPU (device='cpu')")
    return "cpu"


def probe_default_backend(
    deadline_s: float = 120.0, log: Optional[Callable] = None
) -> Tuple[bool, int, str]:
    """Probe the card in a subprocess with a deadline: ``(alive,
    n_devices, platform)``, ``alive`` True iff a CUDA context was created
    and synchronised in time.  Creates no context in the calling
    process."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           timeout=deadline_s, capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired:
        if log:
            log(f"card probe hung > {deadline_s}s; assuming the card is "
                f"wedged")
        return False, 0, ""
    for line in reversed(r.stdout.strip().splitlines() if r.stdout else []):
        parts = line.split()
        if len(parts) == 3 and parts[0] == "PROBE_OK" and r.returncode == 0:
            return True, int(parts[1]), parts[2]
    if log:
        tail = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ""
        log(f"card probe failed (rc={r.returncode}): {tail}")
    return False, 0, ""
