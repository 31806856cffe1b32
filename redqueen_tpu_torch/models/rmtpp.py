"""RMTPP neural-intensity broadcaster (BASELINE config 5), the
counterpart of the JAX package's ``models/rmtpp.py``.

A GRU consumes the source's own inter-event times, and the intensity
until its next own event is lambda(tau) = exp(v.h + b + w tau) (Du et
al., KDD 2016).  That form inverts in closed form
(``ops.sampling.rmtpp_next_delta``), so the policy needs no thinning.
It registers as one more ``PolicyDef``; its recurrent state lives in the
``h`` slot of the engine state and its last own event time in the
``exc_t`` slot (kinds are exclusive per source, so the Hawkes fields are
free).

**Weights** are the flax tree of the JAX package's ``RMTPPCell`` as a
nested dict of tensors, with the flax names and the ``[in, out]`` kernel
layout: ``{"gru": {"ir"|"iz"|"in": {"kernel" [2, H], "bias" [H]},
"hr"|"hz": {"kernel" [H, H]}, "hn": {"kernel" [H, H], "bias" [H]}},
"v": {"kernel" [H, 1], "bias" [1]}, "w": []}``, so ``convert.py`` maps
one tree onto the other leaf by leaf.  Every leaf may carry leading lane
axes (``stack_components`` stacks them ``[B, ...]``).

**The GRU is written gate by gate**, as flax's ``GRUCell`` computes it:
r and z are ``sigmoid(x W_i + b_i + h W_h)`` (no hidden bias), n is
``tanh(x W_in + b_in + r * (h W_hn + b_hn))`` and the update is ``(1 -
z) * n + z * h``.  ``torch.nn.GRUCell`` is not that cell: it carries
hidden biases on r and z and fuses the three gates into one product.
Each product is a sum of at most ``H`` terms per output; torch's and
XLA's CPU ``tanh``, ``log1p`` and summation orders differ by an ulp or
so, so a step agrees with the flax cell within a few ulps, not bit for
bit.

**Training** (``nll_loss``/``fit``) maximises the sequence likelihood of
observed gaps with the closed-form compensator, by full-batch Adam on
``torch.autograd`` gradients with optax's ``adam`` arithmetic."""

from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..learn import ckpt as _ckpt
from ..runtime import preempt as _preempt
from ..runtime.supervisor import heartbeat as _heartbeat
from ..ops.sampling import (
    rmtpp_cum_hazard,
    rmtpp_log_intensity,
    rmtpp_next_delta,
)
from .base import (
    KIND_RMTPP,
    PolicyDef,
    SourceUpdate,
    at_source,
    map_weights,
    register_policy,
)

__all__ = [
    "RMTPPCell",
    "init_weights",
    "attach",
    "nll_loss",
    "fit",
    "fit_traces",
    "calibrate_budget",
    "sequence_nll",
]

#: The GRU's input projections (each with a bias) and hidden ones (only
#: ``hn`` has a bias), by their flax names.
GATES_IN = ("ir", "iz", "in")
GATES_H = ("hr", "hz", "hn")

# optax.adam's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _features(tau):
    """The GRU's input features of a gap: raw and log-compressed."""
    return torch.stack([tau, torch.log1p(tau)], -1)


def _dense(x, kernel):
    """``x [..., I]`` through ``kernel [..., I, O]`` -> ``[..., O]``: per
    output, the sum of the ``I`` products."""
    return (x[..., :, None] * kernel).sum(-2)


def _step_h(weights, h, tau):
    """One GRU step of the hidden state ``h [..., H]`` on the gap ``tau
    [...]``."""
    g = weights["gru"]
    x = _features(tau)

    def inp(name):
        return _dense(x, g[name]["kernel"]) + g[name]["bias"]

    r = torch.sigmoid(inp("ir") + _dense(h, g["hr"]["kernel"]))
    z = torch.sigmoid(inp("iz") + _dense(h, g["hz"]["kernel"]))
    n = torch.tanh(inp("in")
                   + r * (_dense(h, g["hn"]["kernel"]) + g["hn"]["bias"]))
    return (1.0 - z) * n + z * h


def _head(weights, h):
    """``(a, w)`` of log lambda(tau) = a + w tau, with a = v.h + b."""
    v = weights["v"]
    return (_dense(h, v["kernel"])[..., 0] + v["bias"][..., 0],
            weights["w"])


class _Dense(nn.Module):
    """One flax ``Dense`` leaf pair: ``kernel [in, out]`` and, optionally,
    ``bias [out]``."""

    def __init__(self, leaves):
        super().__init__()
        self.kernel = nn.Parameter(leaves["kernel"].detach().clone())
        self.bias = (nn.Parameter(leaves["bias"].detach().clone())
                     if "bias" in leaves else None)

    def tree(self):
        out = {"kernel": self.kernel}
        if self.bias is not None:
            out["bias"] = self.bias
        return out


class RMTPPCell(nn.Module):
    """The GRU over own-event gaps and the affine head ``(v, b, w)`` of
    the intensity, holding its weights as parameters under the flax
    names (``gru.ir.kernel``, ..., ``v.bias``, ``w``).  ``weights``
    (a tree as above) or, when None, :func:`init_weights` with
    ``generator`` gives the initial values."""

    def __init__(self, hidden: int, weights=None, generator=None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.hidden = int(hidden)
        if weights is None:
            weights = init_weights(generator, hidden, device=device)
        self.gru = nn.ModuleDict({k: _Dense(weights["gru"][k])
                                  for k in GATES_IN + GATES_H})
        self.v = _Dense(weights["v"])
        self.w = nn.Parameter(torch.as_tensor(weights["w"]).detach().clone())

    def weights(self):
        """The weight tree of this cell's parameters (autograd-connected)."""
        return {"gru": {k: m.tree() for k, m in self.gru.items()},
                "v": self.v.tree(), "w": self.w}

    def forward(self, h, tau):
        return _step_h(self.weights(), h, tau)

    def head(self, h):
        """``(a, w)`` of log lambda(tau) = a + w tau; a = v.h + b."""
        return _head(self.weights(), h)

    def step_and_head(self, h, tau):
        h = self(h, tau)
        return h, self.head(h)


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    g = torch.Generator()
    g.manual_seed(0 if key is None else int(key))
    return g


def _lecun_normal(shape, gen):
    """flax's default ``Dense`` kernel: a normal truncated at 2 standard
    deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / shape[0]) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


def init_weights(key=None, hidden: int = 16, device: DeviceLike = "cuda"):
    """Fresh RMTPP weights for ``SourceParams.rmtpp``, with flax's
    initialisers: lecun-normal input kernels and head, orthogonal hidden
    kernels, zero biases and ``w = -0.1``.  ``key`` is a seed or a
    ``torch.Generator`` (its draws are torch's, not the JAX package's)."""
    gen = _generator(key)
    dev = resolve_device(device)
    H = int(hidden)
    gru = {}
    for k in GATES_IN:
        gru[k] = {"kernel": _lecun_normal((2, H), gen),
                  "bias": torch.zeros(H)}
    for k in GATES_H:
        gru[k] = {"kernel": nn.init.orthogonal_(torch.empty(H, H),
                                                generator=gen)}
    gru["hn"]["bias"] = torch.zeros(H)
    w = {"gru": gru, "v": {"kernel": _lecun_normal((H, 1), gen),
                           "bias": torch.zeros(1)},
         "w": torch.tensor(-0.1)}
    return map_weights(lambda t: t.to(dev, torch.float32), w)


def attach(params, weights):
    """Attach weights to a built component's ``SourceParams`` (the
    builder cannot know them: ``gb.add_rmtpp(); ...; attach(params,
    w)``)."""
    import dataclasses

    return dataclasses.replace(params, rmtpp=weights)


def hidden_of(weights) -> int:
    """The hidden size of a weight tree (lane axes allowed)."""
    return int(weights["v"]["kernel"].shape[-2])


# ---- policy hooks (scan engine) ----


def _per_source(weights):
    """Lane-stacked weights ``[B, ...]`` given a source axis ``[B, 1,
    ...]``, so that they broadcast against ``[B, S]`` state; unstacked
    weights broadcast as they are."""
    lead = weights["v"]["kernel"].dim() - 2
    if lead == 0:
        return weights
    return map_weights(lambda t: t.unsqueeze(lead), weights)


def on_init(params, state, t0, keys, rows):
    B, S = params.kind.shape
    t0 = t0.expand(B, S)
    if params.rmtpp is None:
        # A weightless component that merely compiles alongside RMTPP
        # rows: never fires (the sim driver refuses actual RMTPP rows
        # without weights).
        return SourceUpdate(t_next=torch.full_like(t0, float("inf")),
                            exc_t=t0)
    w = _per_source(params.rmtpp)
    a, ww = _head(w, state.h)           # h is zeros at init
    return SourceUpdate(t_next=t0 + rmtpp_next_delta(keys, a, ww),
                        exc_t=t0, h=state.h)


def on_fire(params, state, fired, t, key, u, lanes):
    if params.rmtpp is None:
        return SourceUpdate(t_next=torch.full_like(t, float("inf")),
                            exc_t=t)
    tau = t - at_source(state.exc_t, fired)  # exc_t: last own event time
    h = _step_h(params.rmtpp, at_source(state.h, fired), tau)
    a, w = _head(params.rmtpp, h)
    return SourceUpdate(t_next=t + rmtpp_next_delta(key, a, w), exc_t=t,
                        h=h)


RMTPP = register_policy(
    PolicyDef(kind=KIND_RMTPP, name="rmtpp", on_init=on_init,
              on_fire=on_fire, fire_uses_key=True)
)


# ---- training (sequence likelihood on observed posting traces) ----


def sequence_nll(weights, taus, mask, hidden: int):
    """NLL of padded gap sequences ``taus [..., L]`` with validity ``mask``
    -> ``[...]``.  Event k contributes -log lambda(tau_k | h_{k-1}) +
    Lambda(tau_k | h_{k-1}); the GRU then absorbs tau_k.  Padding
    contributes exactly 0."""
    taus = torch.as_tensor(taus)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=taus.device)
    h = torch.zeros(taus.shape[:-1] + (int(hidden),), dtype=taus.dtype,
                    device=taus.device)
    lls = []
    for k in range(taus.shape[-1]):
        tau, m = taus[..., k], mask[..., k]
        a, w = _head(weights, h)
        ll = rmtpp_log_intensity(a, w, tau) - rmtpp_cum_hazard(a, w, tau)
        h = torch.where(m[..., None], _step_h(weights, h, tau), h)
        lls.append(torch.where(m, ll, torch.zeros_like(ll)))
    return -torch.stack(lls, -1).sum(-1)


def nll_loss(weights, taus, mask, hidden: int):
    """Mean NLL over a batch of padded sequences ``[B, L]``."""
    return sequence_nll(weights, taus, mask, hidden).mean()


def _adam_init(params):
    return {"count": 0,
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params]}


@torch.no_grad()
def _adam_step(params, grads, state, lr: float):
    """One step of optax's ``adam(lr)``, in its order of operations."""
    count = state["count"] + 1
    # optax's float32 bias corrections, as host scalars: no copies to the
    # device inside the parameter loop.
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
    mu, nu = [], []
    for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
        m = (1 - _B1) * g + _B1 * m
        v = (1 - _B2) * (g ** 2) + _B2 * v
        upd = (m / bc1) / (torch.sqrt(v / bc2) + _EPS)
        p.add_(upd * (-lr))
        mu.append(m)
        nu.append(v)
    return {"count": count, "mu": mu, "nu": nu}


def _flatten(obj, leaves: list):
    """A JSON skeleton of a nest of dicts, lists, tuples, tensors and
    plain values, with every tensor appended to ``leaves`` and replaced
    by its index (dict keys keep their type: an optimizer's state is
    keyed by int)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return {"t": len(leaves) - 1}
    if isinstance(obj, dict):
        return {"d": [[_flatten(k, leaves), _flatten(v, leaves)]
                      for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"l" if isinstance(obj, list) else "u":
                [_flatten(v, leaves) for v in obj]}
    return {"v": obj}


def _unflatten(skel, leaves):
    """Inverse of :func:`_flatten`: ``leaves`` are tensors."""
    (tag, val), = skel.items()
    if tag == "t":
        return leaves[val]
    if tag == "d":
        return {_unflatten(k, leaves): _unflatten(v, leaves)
                for k, v in val}
    if tag in ("l", "u"):
        out = [_unflatten(v, leaves) for v in val]
        return out if tag == "l" else tuple(out)
    return val


def fit(key, taus, mask, hidden: int = 16, steps: int = 300,
        lr: float = 1e-2, weights=None, opt_state=None,
        optimizer: Optional[Callable] = None,
        ckpt_path: Optional[str] = None, ckpt_every: int = 50,
        device: DeviceLike = "cuda"):
    """Fit RMTPP weights to observed gap sequences ``taus``/``mask [B, L]``
    by full-batch Adam (optax's ``adam(lr)`` arithmetic) on autograd
    gradients of :func:`nll_loss`.  Returns ``(weights, opt_state,
    losses)``, the losses a float64 numpy curve of ``steps`` values; pass
    ``weights``/``opt_state`` back to go on training.  ``key`` (a seed or
    a ``torch.Generator``) seeds :func:`init_weights` when ``weights`` is
    None.  ``optimizer``, if given, is a factory ``params ->
    torch.optim.Optimizer`` used in place of Adam, and ``opt_state`` is
    then its ``state_dict()``.

    ``ckpt_path``: every ``ckpt_every`` steps the full training state
    (weights, optimizer state, loss curve) lands as an enveloped
    ``rq.learn.fit/1`` artifact (``learn.ckpt``), keyed by a fingerprint
    of the data, the hyperparameters and the initial weights and
    optimizer state; after each save the fit heartbeats and honors a
    pending SIGTERM/SIGINT.  A killed fit rerun with the same arguments
    resumes from it bit-identically; a stored state whose fingerprint or
    structure does not match (another corpus, ``hidden``, ``lr``,
    optimizer, or initial weights) is ignored and the fit starts over.
    ``steps`` is a budget, not part of the fingerprint: a rerun with a
    larger ``steps`` trains onward, one with a smaller ``steps`` returns
    the further-trained stored state as it is."""
    dev = resolve_device(device)
    taus = torch.as_tensor(np.asarray(taus), dtype=torch.float32).to(dev)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool).to(dev)
    if weights is None:
        weights = init_weights(key, hidden, device=dev)
    weights = map_weights(lambda t: t.to(dev), weights)
    if optimizer is None:
        state = (_adam_init(list(RMTPPCell(hidden, weights=weights)
                                 .parameters()))
                 if opt_state is None else opt_state)
    else:
        state = opt_state

    start, host_losses, fp = 0, [], None
    if ckpt_path is not None:
        leaves = []
        skel = _flatten((weights, state), leaves)
        fp = _ckpt.fingerprint_arrays(
            dict(model="rmtpp", hidden=int(hidden), lr=float(lr),
                 optimizer="custom" if optimizer is not None else "adam",
                 init=json.dumps(skel)),
            taus.cpu().numpy(), mask.cpu().numpy(),
            *[t.detach().cpu().numpy() for t in leaves])
        loaded = _ckpt.load_fit(ckpt_path, fp)
        if loaded is not None:
            step0, arrays, meta = loaded
            try:
                stored = [torch.as_tensor(arrays[f"leaf_{i:05d}"]).to(dev)
                          for i in range(int(meta["n_leaves"]))]
                weights, state = _unflatten(json.loads(meta["skeleton"]),
                                            stored)
                host_losses = list(np.asarray(arrays["curve"], np.float64))
                start = min(int(step0), int(steps))
            except (KeyError, ValueError, TypeError, IndexError):
                pass  # a layout this fit cannot restore: start over

    cell = RMTPPCell(hidden, weights=weights)
    params = list(cell.parameters())
    if optimizer is None:
        state = {"count": int(state["count"]),
                 "mu": [m.to(dev).clone() for m in state["mu"]],
                 "nu": [v.to(dev).clone() for v in state["nu"]]}
    else:
        opt = optimizer(params)
        if state is not None:
            opt.load_state_dict(state)

    def save(step):
        leaves = []
        skel = _flatten((map_weights(lambda t: t.detach(), cell.weights()),
                         state if optimizer is None else opt.state_dict()),
                        leaves)
        arrays = {f"leaf_{i:05d}": t.detach().cpu().numpy()
                  for i, t in enumerate(leaves)}
        arrays["curve"] = np.asarray(host_losses, np.float64)
        _ckpt.save_fit(ckpt_path, fp, step, arrays,
                       meta=dict(model="rmtpp", hidden=int(hidden),
                                 n_leaves=len(leaves),
                                 skeleton=json.dumps(skel)))
        _heartbeat()
        _preempt.check_preempt(f"rmtpp.fit step {step}")

    losses = []
    last_saved = start
    for i in range(start, int(steps)):
        loss = nll_loss(cell.weights(), taus, mask, hidden)
        grads = torch.autograd.grad(loss, params)
        if optimizer is None:
            state = _adam_step(params, grads, state, lr)
        else:
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
        # The curve stays on the device until a checkpoint or the end.
        losses.append(loss.detach())
        if ckpt_path is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            host_losses.extend(torch.stack(losses).double().cpu().numpy())
            losses = []
            save(i + 1)
            last_saved = i + 1
    if losses:
        host_losses.extend(torch.stack(losses).double().cpu().numpy())
    if ckpt_path is not None and last_saved < int(steps):
        save(int(steps))
    out = map_weights(lambda t: t.detach().clone(), cell.weights())
    return (out, (state if optimizer is None else opt.state_dict()),
            np.asarray(host_losses, np.float64))


def _per_trace_nll(weights, taus, mask, hidden: int):
    """Per-trace total NLL and event counts over a batch, read to the host
    together."""
    with torch.no_grad():
        per = sequence_nll(weights, taus, mask, hidden)
        both = torch.stack([per.double(), mask.sum(-1).double()]).cpu()
    return both[0].numpy(), both[1].numpy().astype(np.int64)


def _per_event_nll(weights, taus, mask, hidden: int) -> float:
    """Total NLL over total events: the per-event score two weight sets
    are compared on."""
    per, ev = _per_trace_nll(weights, taus, mask, hidden)
    return float(per.sum()) / max(int(ev.sum()), 1)


def fit_traces(key, traces, hidden: int = 16, steps: int = 300,
               lr: float = 1e-2, holdout_frac: float = 0.25,
               ckpt_path: Optional[str] = None, ckpt_every: int = 50,
               device: DeviceLike = "cuda"):
    """Fit RMTPP to a posting corpus (a list of ascending time arrays, for
    example ``data.traces.synthetic_twitter``) with an interleaved
    held-out split: every ``round(1 / holdout_frac)``-th user is held
    out.  ``info`` scores the fitted and the initial weights on the
    held-out users (``heldout_nll`` and ``heldout_nll_init``, per event),
    with the per-trace values.  The initial weights are
    :func:`init_weights` from ``key``.  Returns ``(weights, losses,
    info)``."""
    from ..data.traces import gaps_from_traces

    dev = resolve_device(device)
    taus_np, mask_np = gaps_from_traces(traces)
    stride = max(int(round(1.0 / max(holdout_frac, 1e-9))), 2)
    hold = np.zeros(len(traces), bool)
    hold[::stride] = True
    if hold.all() or not hold.any():
        raise ValueError(f"degenerate holdout split for {len(traces)} users")
    w0 = init_weights(key, hidden, device=dev)
    w, _, losses = fit(key, taus_np[~hold], mask_np[~hold], hidden=hidden,
                       steps=steps, lr=lr, weights=w0, ckpt_path=ckpt_path,
                       ckpt_every=ckpt_every, device=dev)
    taus_h = torch.as_tensor(taus_np[hold], dtype=torch.float32).to(dev)
    mask_h = torch.as_tensor(mask_np[hold]).to(dev)
    per_nll, per_ev = _per_trace_nll(w, taus_h, mask_h, hidden)
    info = {
        "heldout_nll": float(per_nll.sum()) / max(int(per_ev.sum()), 1),
        "heldout_nll_init": _per_event_nll(w0, taus_h, mask_h, hidden),
        "train_users": int((~hold).sum()),
        "heldout_users": int(hold.sum()),
        "heldout_events": int(mask_np[hold].sum()),
        "heldout_per_trace_nll": per_nll.tolist(),
        "heldout_per_trace_events": per_ev.tolist(),
        "heldout_user_indices": np.flatnonzero(hold).tolist(),
    }
    return w, losses, info


def calibrate_budget(weights, target_posts: float, T: float,
                     n_seeds: int = 32, iters: int = 10,
                     seed0: int = 77_000, device: DeviceLike = "cuda"):
    """Shift the head bias ``b`` so that the policy's mean posts over [0,
    T] at the fixed seeds ``seed0 ..`` match ``target_posts``: geometric
    bracketing within +/-8, then ``iters`` bisection steps (the realized
    posts are monotone in the shift; a fixed-point iteration on the log
    ratio diverges, because the policy consumes its own gaps).  A bare
    one-sink component measures the budget, since the policy never
    reacts to walls.  Raises ``ValueError`` when no shift within +/-8
    brackets the target."""
    from ..config import GraphBuilder, stack_components
    from ..sim import simulate_batch
    from ..utils.metrics import num_posts

    dev = resolve_device(device)
    weights = map_weights(lambda t: torch.as_tensor(t).to(dev), weights)
    hidden = hidden_of(weights)
    cap = 1 << max(int(np.ceil(np.log2(max(8.0 * target_posts, 64.0)))), 6)
    # The reference's chunk of min(cap, 4,096) events, stepped here in
    # chunks of 64 under the same event allowance: the scan engine's
    # events do not depend on the chunk, and a run steps whole chunks, so
    # a smaller one stops sooner after the last event.
    chunk = min(cap, 64)
    max_chunks = -(-100 * min(cap, 4096) // chunk)
    gb = GraphBuilder(n_sinks=1, end_time=T)
    src = gb.add_rmtpp()
    cfg, params, adj = gb.build(capacity=chunk, rmtpp_hidden=hidden,
                                device=dev)
    seeds = np.arange(n_seeds) + seed0

    def shifted(s):
        return {**weights, "v": {**weights["v"],
                                 "bias": weights["v"]["bias"] + s}}

    def realized(s):
        p_b, a_b = stack_components([attach(params, shifted(s))] * n_seeds,
                                    [adj] * n_seeds)
        lg = simulate_batch(cfg, p_b, a_b, seeds, max_chunks=max_chunks,
                            device=dev)
        return float(num_posts(lg.srcs, src).double().mean())

    lo, hi = 0.0, 0.0
    r = realized(0.0)
    step = 0.5
    if r < target_posts:
        while r < target_posts and hi < 8.0:
            lo, hi = hi, hi + step
            step *= 2.0
            r = realized(hi)
        bracketed = r >= target_posts
    else:
        while r > target_posts and lo > -8.0:
            lo, hi = lo - step, lo
            step *= 2.0
            r = realized(lo)
        bracketed = r <= target_posts
    if not bracketed:
        raise ValueError(
            f"calibrate_budget could not bracket target_posts="
            f"{target_posts:g} within a +/-8 log-intensity shift "
            f"(realized {r:g} at the bound) — the fitted intensity is too "
            f"far from the target budget for a pure scale shift; retrain "
            f"on a corpus whose mean rate is nearer target_posts/T")
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if realized(mid) < target_posts:
            lo = mid
        else:
            hi = mid
    return shifted(0.5 * (lo + hi))
