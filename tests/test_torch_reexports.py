"""R1: the port's package surface against the JAX package's.  Every name
a reference module exports (its ``__all__``, or its public names where it
has none) exists in the port's counterpart, the mesh layer's too: no
gap is left.  Under
``RQ_SERVING_WORKER=1`` the runtime package still imports without torch,
and the package itself loads no pandas."""

import importlib
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("", ".runtime", ".runtime.supervisor", ".runtime.watchdog",
           ".runtime.numerics", ".utils", ".utils.backend",
           ".utils.roofline", ".data", ".data.traces", ".sweep", ".sim",
           ".native", ".parallel", ".parallel.comm", ".parallel.multihost",
           ".parallel.shard")

# Names still to port, each with its roadmap item: none are left.
GAPS = {}


def _exported(mod):
    """The module's ``__all__``, or the public names its source binds
    (not ``dir()``: that also lists whatever submodules other tests
    happened to import)."""
    if getattr(mod, "__all__", None):
        return list(mod.__all__)
    import ast

    names = []
    for node in ast.parse(open(mod.__file__).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_") and n != "annotations"]


@pytest.mark.parametrize("name", MODULES, ids=lambda m: m or "top")
def test_every_reference_name_exists_in_the_port(name):
    ref = importlib.import_module("redqueen_tpu" + name)
    port = importlib.import_module("redqueen_tpu_torch" + name)
    missing = sorted(n for n in _exported(ref) if not hasattr(port, n))
    assert missing == sorted(GAPS.get(name, {})), missing


def test_every_listed_gap_is_item_6():
    """A listed gap names the roadmap item that ports it (item 6, the
    mesh layer, was the last; none is listed now)."""
    assert all(v == "item 6" for g in GAPS.values() for v in g.values())


def test_no_gap_is_left():
    assert GAPS == {}


def test_version_and_runtime_names():
    import redqueen_tpu as J
    import redqueen_tpu_torch as rt

    assert rt.__version__ == J.__version__
    from redqueen_tpu_torch.runtime import (  # noqa: F401
        CorruptArtifactError, FlightRecorder, NumericalHealthError,
        RetryPolicy, Telemetry, atomic_write_text, heartbeat,
        preempt_requested, register_flush, safe_div, safe_exp, safe_log,
        safe_log1p, unregister_flush)
    from redqueen_tpu_torch.utils import checkpoint, dataframe  # noqa: F401


def _child(code, **env):
    e = dict(os.environ, **env)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=e, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_serving_worker_runtime_import_stays_torch_free():
    got = _child(
        "import json, sys\n"
        "import redqueen_tpu_torch.runtime as r\n"
        "names = [r.Supervisor, r.Watchdog, r.RetryPolicy, r.heartbeat,\n"
        "         r.ensure_backend, r.atomic_write_json, r.Telemetry]\n"
        "before = 'torch' in sys.modules\n"
        "r.safe_exp\n"
        "print(json.dumps([before, 'torch' in sys.modules]))",
        RQ_SERVING_WORKER="1")
    # torch only once a numerics name is touched (lazily)
    assert got == [False, True]


def test_package_import_loads_no_pandas_and_utils_are_lazy():
    got = _child(
        "import json, sys\n"
        "import redqueen_tpu_torch as rt\n"
        "u = rt.utils\n"
        "before = 'pandas' in sys.modules\n"
        "u.metrics_pandas\n"
        "print(json.dumps([before, 'pandas' in sys.modules]))")
    assert got == [False, True]
