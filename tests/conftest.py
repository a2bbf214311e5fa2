"""Test config: run on a simulated 8-device CPU mesh (SURVEY.md section 4).

Must set platform/flags before jax initializes.

Tests that need a GPU carry the ``gpu`` marker and skip without one (the
``_gpu_only`` fixture decides, at run time). ``NEOJAX_GPU_TESTS=1`` keeps
the real accelerator instead of the CPU mesh, for ``pytest -m gpu`` on the
card (``python chip_smoke.py`` runs exactly that); the CPU-mesh tests are
not expected to pass in that mode.
"""

import os

_ON_DEVICE = bool(os.environ.get("NEOJAX_GPU_TESTS"))

if not _ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    # The reference has a full float64 path with a 1e-9 parity bound; enable
    # x64 so tests can exercise it (f32 stays f32 where explicitly
    # requested). Device mode keeps x32, as the engines run in production.
    jax.config.update("jax_enable_x64", True)
else:
    from neojax.bench.env import setup_compile_cache

    setup_compile_cache()

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX backend: {jax.default_backend()})")


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def noise_signal(rng, *shape, dtype=np.float32):
    """Seeded uniform +-1 noise (reference ``generate_noise_signal``,
    ``src/neo/testing/testing.hpp:37-72``)."""
    return rng.uniform(-1.0, 1.0, size=shape).astype(dtype)


@pytest.fixture
def make_noise(rng):
    def _make(*shape, dtype=np.float32):
        return noise_signal(rng, *shape, dtype=dtype)

    return _make
