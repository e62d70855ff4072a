"""The port's package rules: it imports neither jax nor the JAX package,
its entry points default to the card, and without one they raise rather
than run on the host."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def _modules() -> list[str]:
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], prefix="repro_torch.")]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.cli" in mods and "repro_torch.kernels.ert.ops" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|,|$)",
                        re.MULTILINE)


def _sources() -> list[str]:
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(out)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_source_names_no_jax_or_repro_import(path):
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, f"{path} imports {hits}"


def test_forbidden_pattern_catches_the_reference():
    assert _FORBIDDEN.findall("import jax.numpy as jnp\n") == ["jax"]
    assert _FORBIDDEN.findall("from repro.core import machine\n") == ["repro"]
    assert _FORBIDDEN.findall("from repro_torch.core import machine\n") == []


def test_session_defaults_to_cuda_and_never_falls_back():
    from repro_torch import Session
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert Session().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="'cuda'"):
        Session()
    with pytest.raises(RuntimeError, match="'cuda:0'"):
        resolve_device("cuda:0")
    assert Session(device="cpu").device == torch.device("cpu")


def test_measurement_entry_points_raise_without_cuda():
    from repro_torch.kernels.ert import ops
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing falls back here")
    for fn in (ops.characterize, ops.measure_bandwidth, ops.measure_gemm):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


def test_unsupported_device_is_refused():
    from repro_torch.device import resolve_device
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_cli_help_exits_zero():
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "--help"],
                          cwd=REPO_ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "characterize" in proc.stdout and "profile" in proc.stdout


def test_cli_default_device_is_cuda():
    from repro_torch.cli import build_parser
    args = build_parser().parse_args(["profile", "--config", "glm4-9b"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "profile", "--config",
         "glm4-9b"], cwd=REPO_ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2
    assert "'cuda' was asked for" in proc.stderr


def test_cli_profiles_on_the_host_when_asked():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "profile", "--config",
         "glm4-9b", "--device", "cpu", "--measure", "--iters", "1",
         "--warmup", "1", "--charts", "1"],
        cwd=REPO_ROOT, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "-- fwd --" in proc.stdout and "markers:" in proc.stdout
