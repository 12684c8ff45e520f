"""chip_smoke.py on the CPU: without a GPU it exits non-zero and prints no
result, and each of its phase functions runs and passes its own check at a
tiny size (the card runs them at full size)."""
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("args", [[], ["--devices", "4"]])
def test_no_gpu_exits_nonzero_without_result(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                        *args], capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and "phase" not in p.stdout
    assert "no GPU" in p.stderr


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    """A copy of the script with nothing else of the repo cannot run."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("name,call", [
    ("mg2d_f64", lambda: chip_smoke.phase_mg2d_f64(k=6)),
    ("mg2d_f32", lambda: chip_smoke.phase_mg2d_f32(k=6)),
    ("pcg_f64", lambda: chip_smoke.phase_pcg(k=6)),
    ("fmg_f64", lambda: chip_smoke.phase_fmg(k=7)),
    ("eigen_ii", lambda: chip_smoke.phase_eigen(k=5, method="ii")),
    ("eigen_lobpcg", lambda: chip_smoke.phase_eigen(k=5, method="lobpcg")),
    ("mg3d_f64", lambda: chip_smoke.phase_mg3d(k=4)),
    ("history_f64", lambda: chip_smoke.phase_history(k=6)),
    ("sharded_mesh1", lambda: chip_smoke.phase_sharded1(k=6)),
])
def test_single_card_phase_at_tiny_size(name, call):
    assert "n=" in call()


@pytest.mark.parametrize("name", ["rows_mg", "rows_pcg", "blocks_mg",
                                  "blocks_pcg", "slabs3d_mg"])
def test_four_card_phase_on_virtual_devices(name, monkeypatch):
    """The four-card phases on four virtual CPU devices (agglomeration
    lowered so the tiny grids keep sharded levels)."""
    import multigridcmt as mg

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    orig = mg.poisson

    def small_agglom(*a, **kw):
        return orig(*a, agglom_rows=4, **kw)

    monkeypatch.setattr(mg, "poisson", small_agglom)
    phases = dict(chip_smoke.four_card_phases(k2=6, k3=5))
    assert "== single card" in phases[name]()


def test_run_reports_a_failing_phase():
    def bad():
        raise AssertionError("wrong answer")

    assert chip_smoke.run([("good", lambda: "n=1"), ("bad", bad)]) is False
    assert chip_smoke.run([("good", lambda: "n=1")]) is True
