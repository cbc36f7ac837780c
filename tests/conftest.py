"""Test configuration: JAX on a virtual 8-device CPU mesh.

Unit tests validate kernels, parity and sharding logic on the host platform.
Tests of code that runs only on the GPU (the CUDA kernels) carry the
``gpu`` marker and skip here; ``python chip_smoke.py`` runs that code on the
card.  Environment must be set before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import aegis_tpu  # noqa: E402,F401  (places the compile cache, before jax)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def two_tone_22k():
    """1.45 s signal: 220 Hz, 330 Hz, then silence (sr=22050)."""
    sr = 22050
    t = np.arange(int(sr * 0.6)) / sr
    y = np.concatenate(
        [
            0.5 * np.sin(2 * np.pi * 220 * t),
            0.5 * np.sin(2 * np.pi * 330 * t),
            np.zeros(sr // 4),
        ]
    ).astype(np.float32)
    return y, sr


@pytest.fixture
def gpu():
    """Skip unless JAX has a GPU (decided when the test runs, never at
    import, so every worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: runs on the card through chip_smoke.py")
