"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Accelerator execution is exercised by ``chip_smoke.py`` (and the ``chip``
marked tests, which run it on a machine with an NVIDIA card); the test suite
targets determinism and multi-device sharding semantics, which JAX provides
on CPU via ``--xla_force_host_platform_device_count`` (the standard
fake-backend trick, see SURVEY.md §4).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the suite never takes the card
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# jax may already be imported (and its config read) before this conftest
# runs, so setting env vars alone is not enough.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

# The quick lane (`pytest -m quick`): the bit-contract core — oracle, native
# C++ parity, spec golden vectors, the 12-name compat surface, and the
# portable XLA tier.  These run in well under a minute even on slow
# containers; the full suite adds the 8-device-mesh modules, which are 10x+
# slower there.
_QUICK_MODULES = {
    "test_oracle",
    "test_native",
    "test_compat",
    "test_xla",
    "test_utils",
    "test_distance",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__.rsplit(".", 1)[-1] in _QUICK_MODULES:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def chip():
    """Skip unless this machine has an NVIDIA card (decided at run time,
    never at import: every xdist worker must collect the same tests)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("needs an NVIDIA card (run `pytest -m chip` on one)")
