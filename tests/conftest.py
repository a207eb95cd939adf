import os

# Tests run on a virtual 8-device CPU mesh in float64 (parity-grade
# precision); tests that need a GPU carry the "gpu" marker and skip here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

from mistra_tpu.paths import REPO_ROOT
from mistra_tpu.utils.compile_cache import configure_compile_cache

jax.config.update("jax_enable_x64", True)
configure_compile_cache()

# The reference model's source tree (its input tables, namelists and
# mechanisms): MISTRA_REFERENCE, else a "reference" directory beside the
# package.  Tests of science values against it skip when it is absent.
REFERENCE = os.environ.get("MISTRA_REFERENCE",
                           os.path.join(REPO_ROOT, "reference"))


def _reference_path(*parts):
    path = os.path.join(REFERENCE, *parts)
    if not os.path.exists(path):
        pytest.skip(f"reference data not available: {path}")
    return path


@pytest.fixture(scope="session")
def reference_inpdir():
    """The reference's input tables (skips where absent)."""
    return _reference_path("input") + "/"


@pytest.fixture(scope="session")
def reference_root():
    """The reference's source tree (skips where absent)."""
    return _reference_path()


@pytest.fixture(scope="session")
def mechdir():
    """The reference's chemical mechanisms (skips where absent)."""
    return _reference_path("src", "mech") + "/"


@pytest.fixture(scope="session")
def synthetic_inpdir():
    """Generated physics input tables (io/synthetic_inputs.py)."""
    from mistra_tpu.io.synthetic_inputs import ensure_synthetic_inputs
    return ensure_synthetic_inputs()


@pytest.fixture
def gpu_device():
    """The first GPU; tests marked ``gpu`` skip where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU available")
