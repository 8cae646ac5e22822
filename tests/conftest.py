"""Test harness: an 8-virtual-device CPU platform before any jax use.

Sharding tests run on a virtual CPU mesh (SURVEY.md §4e). JAX_PLATFORMS
defaults to cpu here; the tests marked `gpu` need the card and run with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py`
(README Quick start), skipping inside their fixture when JAX finds no GPU.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's backend is {jax.default_backend()}")
