"""Test configuration: pin JAX to a virtual 8-device CPU mesh.

The tests run on the CPU (GPU kernels in the Pallas interpreter); the GPU
path is driven by ``chip_smoke.py``.  The 8 virtual devices exercise the
sharded decoder.
"""

import os

# Must be set before jax initializes a backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm

#: Re-exported to the test modules (``from conftest import make_config``).
__all__ = ["expected_pcm_bytes", "make_config", "music_pcm"]


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(1234)
