"""Test harness: run everything on CPU with an 8-device virtual mesh.

Multi-card sharding is validated on a virtual CPU mesh; Pallas kernels
run in interpret mode on CPU (tpurast.kernels gates on backend). Tests
marked `gpu` need the card and skip here (see the `gpu` fixture). Must be
set before JAX initializes.
"""

import os

# CPU unless the caller chose platforms (on the card:
# JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu), applied even if a
# pytest plugin already imported jax before this conftest ran.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pathlib

import pytest

#: The reference renderer's data directory (meshes/, textures/), if any.
REFERENCE_DATA = os.environ.get("TPURAST_DATA_DIR")

#: Dragon texture side for CPU tests: the seeded scene's geometry is
#: full size, its 2048^2 texture is cut to keep host memory small.
TEST_TEXTURE_SIZE = 256


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    if not REFERENCE_DATA or not pathlib.Path(REFERENCE_DATA).is_dir():
        pytest.skip("reference data directory not given (TPURAST_DATA_DIR)")
    return pathlib.Path(REFERENCE_DATA)


@pytest.fixture(scope="session")
def demo_scene():
    """The seeded demo scene (arena + dragon-class mesh + crate)."""
    from tpurast.device.seeded import load_seeded_demo_scene

    return load_seeded_demo_scene(0, dragon_texture_size=TEST_TEXTURE_SIZE)


@pytest.fixture
def gpu():
    """The first GPU device; skips where JAX has none (CPU test runs)."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu)")
    return devices[0]
