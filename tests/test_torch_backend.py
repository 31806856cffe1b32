"""The port's ``utils.backend``: the card's liveness probe (a subprocess
with a deadline that creates a CUDA context) and its policy, against
``tests/test_backend_helpers.py``'s cases of the JAX package.  Stated
difference: ``ensure_live_backend`` returns the device to use and
changes no global state.  Exact: no tolerance."""

import os
import subprocess
import types

import pytest
import torch

from redqueen_tpu.utils import backend as jbackend
from redqueen_tpu_torch.utils import backend


@pytest.mark.parametrize("text", [
    'noise\n{"a": 1}\nmore noise\n{"ok": true, "b": 2}\ntrailing',
    '{"ok": false}', "", None, '{"x": [1, 2]}\nnot json {'])
@pytest.mark.parametrize("require_ok", [False, True])
def test_parse_last_json_line_matches_the_reference(text, require_ok):
    assert (backend.parse_last_json_line(text, require_ok=require_ok)
            == jbackend.parse_last_json_line(text, require_ok=require_ok))


def test_parse_last_json_line_basics():
    text = 'noise\n{"a": 1}\nmore noise\n{"ok": true, "b": 2}\ntrailing'
    assert backend.parse_last_json_line(text) == {"ok": True, "b": 2}
    assert backend.parse_last_json_line(text, require_ok=True)["b"] == 2
    assert backend.parse_last_json_line('{"ok": false}',
                                        require_ok=True) is None
    assert backend.parse_last_json_line("") is None
    assert backend.parse_last_json_line(None) is None


def test_ensure_live_backend_alive_returns_cuda_and_sets_nothing(
        monkeypatch):
    monkeypatch.setattr(backend, "probe_default_backend",
                        lambda d, log=None: (True, 1, "cuda"))
    env = dict(os.environ)
    dtype = torch.get_default_dtype()
    assert backend.ensure_live_backend(log=None) == "cuda"
    assert dict(os.environ) == env and torch.get_default_dtype() == dtype


def test_ensure_live_backend_dead_returns_cpu(monkeypatch):
    probes = []
    monkeypatch.setattr(backend, "probe_default_backend",
                        lambda d, log=None: probes.append(d) or (False, 0, ""))
    monkeypatch.setattr(backend.time, "sleep", lambda s: None)
    env = dict(os.environ)
    logged = []
    assert backend.ensure_live_backend(log=logged.append) == "cpu"
    assert any("device='cpu'" in m for m in logged)
    # the shared liveness policy: one probe and one shorter retry
    assert probes == [90.0, 40.0]
    assert dict(os.environ) == env


def _fake_run(stdout="", stderr="", rc=0, hang=False):
    def run(cmd, timeout, capture_output, text):
        assert "torch.zeros(1, device='cuda')" in cmd[-1]
        assert "torch.cuda.synchronize()" in cmd[-1]
        if hang:
            raise subprocess.TimeoutExpired(cmd, timeout)
        return types.SimpleNamespace(stdout=stdout, stderr=stderr,
                                     returncode=rc)
    return run


@pytest.mark.parametrize("case,want", [
    (dict(stdout="banner\nPROBE_OK 4 cuda\n"), (True, 4, "cuda")),
    (dict(stdout="PROBE_OK 1 cuda\n", rc=1), (False, 0, "")),
    (dict(stderr="RuntimeError: no CUDA GPUs are available", rc=1),
     (False, 0, "")),
    (dict(hang=True), (False, 0, ""))])
def test_probe_parses_the_child_and_its_deadline(monkeypatch, case, want):
    monkeypatch.setattr(backend.subprocess, "run", _fake_run(**case))
    logged = []
    assert backend.probe_default_backend(5.0, log=logged.append) == want
    assert bool(logged) == (not want[0])


def test_real_probe_agrees_with_torch():
    """The probe in a real child: alive exactly when this machine has a
    card, and it creates no CUDA context here."""
    alive, n, plat = backend.probe_default_backend(120.0)
    assert alive == torch.cuda.is_available()
    if alive:
        assert (n, plat) == (torch.cuda.device_count(), "cuda")
    else:
        assert (n, plat) == (0, "")
