"""Test configuration.

By default every test runs on the XLA CPU backend with 8 virtual devices
(SURVEY.md §4): distribution tests build their meshes from them, and
Pallas kernels run in the interpreter (interpret=True).

Tests marked `gpu` need a card.  Run them on a machine with a GPU with

    LDPC_TEST_GPU=1 python -m pytest tests/ -m gpu -n0

LDPC_TEST_GPU=1 leaves JAX's platform alone, so JAX opens the GPU; the
`gpu` fixture skips a test when no GPU is found.  Whether a card is
present is decided inside fixtures only, never while modules are
imported (pytest-xdist workers must all collect the same tests).
"""

import os

GPU_RUN = os.environ.get("LDPC_TEST_GPU") == "1"

if not GPU_RUN:
    # XLA_FLAGS must be set before the CPU backend initializes
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    from tpu_ldpc import backend

    if not backend.on_gpu():
        pytest.skip(f"needs a GPU (backend is {backend.platform()!r}); "
                    "run with LDPC_TEST_GPU=1 on a machine with one")


@pytest.fixture(scope="session")
def cpu8():
    """The 8 virtual CPU devices the distribution tests shard over."""
    import jax

    devices = jax.devices("cpu")
    assert len(devices) == 8, devices
    return devices


@pytest.fixture(scope="session")
def judged_code():
    from tpu_ldpc.codes import LdpcCode

    return LdpcCode.judged()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
