"""Smoke tests for the example CLIs (SURVEY.md §2 "Plot/demo scripts"), so
a CLI-flag regression cannot ship silently.

Each CLI runs in a subprocess at tiny k on CPU, asserting exit 0, the
expected stdout line, and that ``--plot`` writes its artifact.
"""
import os
import subprocess
import sys

import pytest

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _run(script, *args, timeout=300, devices=1):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    if devices > 1:                         # virtual CPU mesh (SURVEY §4.4)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices}")
    env["JAX_PLATFORMS"] = "cpu"
    env["MPLBACKEND"] = "Agg"
    p = subprocess.run(
        [sys.executable, os.path.join(_DIR, script), *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert p.returncode == 0, f"{script} failed:\n{p.stdout}\n{p.stderr}"
    return p.stdout


def test_poisson1d_vcycle(tmp_path):
    png = str(tmp_path / "r.png")
    out = _run("poisson1d_vcycle.py", "--k", "6", "--plot", png)
    assert "rho=" in out
    assert os.path.exists(png) and os.path.getsize(png) > 0


def test_poisson2d_rbgs(tmp_path):
    png = str(tmp_path / "r.png")
    out = _run("poisson2d_rbgs.py", "--k", "6", "--levels", "4",
               "--plot", png)
    assert "iters=" in out
    assert os.path.exists(png) and os.path.getsize(png) > 0


def test_poisson2d_pcg():
    out = _run("poisson2d_rbgs.py", "--k", "6", "--levels", "4",
               "--method", "pcg")
    assert "iters=" in out


def test_fmg_accuracy(tmp_path):
    png = str(tmp_path / "e.png")
    out = _run("fmg_accuracy.py", "--k", "6", "--plot", png)
    assert "ratio" in out.lower() or "error" in out.lower()
    assert os.path.exists(png) and os.path.getsize(png) > 0


def test_fmg_accuracy_cubic():
    out = _run("fmg_accuracy.py", "--k", "6", "--cubic")
    assert out.strip()


def test_eigensolve(tmp_path):
    png = str(tmp_path / "m.png")
    out = _run("eigensolve.py", "--k", "5", "--plot", png)
    assert "lambda_1" in out
    assert os.path.exists(png) and os.path.getsize(png) > 0


def test_eigensolve_lobpcg():
    out = _run("eigensolve.py", "--k", "5", "--method", "lobpcg")
    assert "lambda_1" in out


def test_poisson3d():
    out = _run("poisson3d.py", "--k", "4", "--method", "pcg")
    assert out.strip()


def test_poisson3d_chebyshev():
    out = _run("poisson3d.py", "--k", "4", "--smoother", "chebyshev")
    assert out.strip()


@pytest.mark.parametrize("extra", [[], ["--mesh", "2x2"],
                                   ["--eigen", "1",
                                    "--eigen-method", "lobpcg"]])
def test_distributed_vcycle(extra):
    out = _run("distributed_vcycle.py", "--k", "5", "--f64", *extra,
               timeout=420, devices=4)
    assert out.strip()
