"""The card's peak rates and the bounds built on them: the counterpart of
``redqueen_tpu.utils.roofline``, with the NVIDIA H100's peaks in place of
the TPU generations'.

Every bound the port reports (the event kernel's, ``hawkes_pass``'s, the
serving apply's, the scan step's) divides by the rates here, so each
comes from one place.  The peaks are NVIDIA's H100 SXM5 data sheet and
the Hopper architecture white paper, at the card's full 700 W power
limit: HBM3 at 3.35 TB/s; 132 SMs at a 1.98 GHz boost clock.  Each SM
issues at most 128 thread-instructions a clock (four schedulers, one warp
instruction each), which is the float32 instruction rate: the data
sheet's 67 TFLOP/s counts a fused multiply-add as two.  Integer
instructions run on 64 INT32 lanes per SM.

Model of the scan engine (:func:`scan_step_traffic_bytes`), as in the JAX
package: a step advances every lane by at most one event; the carry
(``SimState``) is read and written once, the parameters and adjacency
read once, and one (f32 time, i32 source) log slot a lane written.
Counter-based draws touch no memory.  It is the least traffic the
algorithm needs if nothing stays resident, so ``hbm_frac`` is an upper
bound on how close the scan is to the bandwidth wall.  Unknown devices
(and the CPU) report ``hbm_peak_gbps: null`` rather than a made-up
denominator."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "hbm_peak_gbps",
    "pytree_nbytes",
    "scan_step_traffic_bytes",
    "roofline_fields",
    "bound",
    "HBM_BYTES_PER_S",
    "SMS",
    "CLOCK_HZ",
    "ISSUE_PER_S",
    "INT32_PER_S",
]

# NVIDIA H100 SXM5 data sheet (HBM3, 80 GB): 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# Hopper architecture white paper: 132 SMs at 1.98 GHz boost.
SMS, CLOCK_HZ = 132, 1.98e9
ISSUE_PER_S = SMS * 128 * CLOCK_HZ
INT32_PER_S = SMS * 64 * CLOCK_HZ

# Peak HBM bandwidth in GB/s, matched case-insensitively as a substring of
# ``torch.cuda.get_device_name()`` ("NVIDIA H100 80GB HBM3" for the SXM5
# card): the card's own peak only.
_HBM_PEAK_GBPS = {
    "h100 80gb hbm3": HBM_BYTES_PER_S / 1e9,
}

# SimState fields the port carries as uint32 words on an int64 carrier
# (``ops.threefry``): the algorithm moves 4 bytes an element of each.
_WORD_FIELDS = ("key", "keys", "ctr", "health")


def hbm_peak_gbps(device_kind: str) -> Optional[float]:
    """Peak HBM bandwidth of a device name, or None if unknown."""
    kind = (device_kind or "").lower()
    best = None
    for pat, gbps in _HBM_PEAK_GBPS.items():
        if pat in kind and (best is None or len(pat) > len(best[0])):
            best = (pat, gbps)
    return best[1] if best else None


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def pytree_nbytes(tree) -> int:
    """Total bytes of every tensor or array leaf of a tree of dicts,
    lists, tuples and dataclasses (shape and dtype only)."""
    total = 0
    for leaf in _leaves(tree):
        shape = getattr(leaf, "shape", None)
        if shape is None:
            continue
        if hasattr(leaf, "element_size"):
            item = leaf.element_size()
        elif hasattr(leaf, "dtype"):
            item = np.dtype(leaf.dtype).itemsize
        else:
            continue
        total += int(np.prod(tuple(shape), dtype=np.int64)) * item
    return total


def scan_step_traffic_bytes(cfg, params, adj) -> int:
    """Modeled HBM bytes one scan step moves for one dispatch of the given
    (possibly batched) component shape: read and write the carry, read
    the parameters and adjacency, write one log slot a lane.  The carry's
    footprint comes from the port's own ``init_state`` on these inputs,
    its key, counter and health words counted at 4 bytes (their uint32
    value), so the count equals the JAX package's for the same config."""
    import torch

    from ..ops import prng
    from ..ops.scan_core import init_state

    batched = params.kind.dim() == 2
    if not batched:
        from ..config import stack_components

        params, adj = stack_components([params], [torch.as_tensor(adj)])
    n_lanes = params.kind.shape[0]
    keys = prng.PRNGKey(torch.zeros(n_lanes, dtype=torch.int64)).to(
        params.rate.device)
    state = init_state(cfg, params, torch.as_tensor(adj), keys)
    state_b = 0
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        state_b += (v.numel() * 4 if f.name in _WORD_FIELDS
                    else pytree_nbytes(v))
    params_b = pytree_nbytes(params) + pytree_nbytes(adj)
    log_b = n_lanes * 8
    return 2 * state_b + params_b + log_b


def roofline_fields(n_steps: int, secs: float, bytes_per_step: int,
                    platform: str, device_kind: str) -> dict:
    """The utilization block of a result line: ``n_steps`` scan steps in
    ``secs`` at ``bytes_per_step`` (:func:`scan_step_traffic_bytes`).
    ``platform`` is ``"cuda"`` for a card run; any other reports no
    peak."""
    if n_steps <= 0 or not np.isfinite(secs) or secs <= 0:
        return {}
    step_ns = secs / n_steps * 1e9
    gbps = bytes_per_step * n_steps / secs / 1e9
    peak = hbm_peak_gbps(device_kind) if platform == "cuda" else None
    return {
        "steps": int(n_steps),
        "step_ns": round(step_ns, 1),
        "bytes_per_step": int(bytes_per_step),
        "hbm_gbps": round(gbps, 3),
        "hbm_peak_gbps": peak,
        "hbm_frac": round(gbps / peak, 4) if peak else None,
    }


def bound(nbytes: float, ops: float = 0.0, int_ops: float = 0.0) -> dict:
    """The least time of a piece of work on the card: ``nbytes`` (each
    input read once, each output written once) over the HBM rate, and
    ``ops`` scalar operations over the issue rate (``int_ops`` of them
    also over the INT32 rate), whichever is slower."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ISSUE_PER_S, int_ops / INT32_PER_S) * 1e3
    return {"bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
