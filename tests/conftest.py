import os

import pytest

# Tests run on a simulated 8-device CPU mesh so multi-chip sharding paths are
# exercised without accelerators (the analogue of the reference's
# single-process test suite; see SURVEY.md §4). Tests that need the card
# take the ``gpu`` fixture; run them there with
# ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at collection, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
