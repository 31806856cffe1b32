"""The paper's experiments on the port, one module each, run as
``python -m redqueen_tpu_torch.experiments.<name> --device cuda``:

- ``tradeoff``: the budget against time-in-top-1 curve, RedQueen against
  budget-matched Poisson over a grid of q;
- ``compare_policies``: RedQueen against the baselines on diurnal walls;
- ``rank_timeline``: one feed's rank over time, RedQueen against Poisson;
- ``closed_loop``: simulate a Hawkes world, fit it, control against it;
- ``live_swap``: fit while serving, a regime shift and a hot swap.

Each keeps its JAX counterpart's ``run()`` signature (``experiments/``
at the repository's root) and adds ``device`` last.  The reference's
``--cpu`` is ``--device cpu`` here; the default is the card, and a run
without one raises (``device.resolve_device``) rather than falling back.
Each writes its result through the ``runtime.integrity`` envelope, with
the platform and the card's name in the payload."""

from __future__ import annotations

import argparse

__all__ = ["add_device_argument", "device_fields", "write_result"]


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run happens (default: the card; "
                         "without one the run raises)")


def device_fields(device) -> dict:
    """``{"platform", "device_name"}`` of the device a run used."""
    import torch

    dev = torch.device(device)
    return {"platform": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


def write_result(path: str, payload: dict, schema: str, device) -> dict:
    """Write ``payload`` with :func:`device_fields` through the integrity
    envelope; returns what was written."""
    from ..runtime import integrity

    doc = {**payload, **device_fields(device)}
    integrity.write_json(path, doc, schema=schema)
    return doc
