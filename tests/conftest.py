import os

# Tests run on a virtual 8-device CPU mesh, whatever accelerator the host
# has, unless JAX_PLATFORMS names other platforms: tests that need a GPU are
# marked `gpu` and take the `gpu` fixture, which skips them on the CPU; run
# them on a card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped (by the gpu fixture) elsewhere")


@pytest.fixture
def gpu():
    """The GPU devices, or a skip when the backend has none.  Decided at
    test time, never at import, so every xdist worker collects the same
    tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu pytest -m gpu)")
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Free compiled executables between test modules.  XLA:CPU JIT-compiled
    programs each hold many small code mmaps; across the whole suite the
    process otherwise exhausts vm.max_map_count (65530) and LLVM aborts with
    'Cannot allocate memory'."""
    yield
    jax.clear_caches()
