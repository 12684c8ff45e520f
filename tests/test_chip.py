"""Card-only tests: the chip_smoke.py phases at full size, compiled for the
GPU. They skip without one; run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.mark.parametrize("name", [name for name, _ in chip_smoke.PHASES])
def test_single_card_phase(gpu, name):
    assert "n=" in dict(chip_smoke.PHASES)[name]()


@pytest.mark.parametrize("name", [name for name, _ in
                                  chip_smoke.four_card_phases()])
def test_four_card_phase(gpu, name):
    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    assert "== single card" in dict(chip_smoke.four_card_phases())[name]()
