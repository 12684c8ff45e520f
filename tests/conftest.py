"""Test harness config: CPU backend with 8 virtual devices, float64 on.

Per SURVEY.md §4.4: JAX can fake an 8-device mesh on one CPU process via
XLA_FLAGS, which is how the sharded V-cycle (shard_map + ppermute halos) is
tested without a cluster. Must run before jax initializes, hence the
env-var dance at import time. float64 is enabled so the SciPy
mini-reference (`reference_impl.py`) can be matched step-for-step at fp64.

The tests run on the CPU unless JAX_PLATFORMS says otherwise: the
card-only tests (marker ``gpu``, tests/test_chip.py) run on the GPU with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multigridcmt.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
