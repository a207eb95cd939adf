"""The GPU kernels of the Bott advection (physics/bott_triton.py) in
Pallas interpret mode against the banded XLA form, plus the wrapper's
layout limits and the per-platform choice of kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.physics import growth
from mistra_tpu.physics.bott_triton import bott_advect_gpu


def _fields(dtype, shape=(3, 7, 70)):
    rng = np.random.default_rng(0)
    z = rng.uniform(0.0, 1.0, shape).astype(dtype)
    u = rng.uniform(-3.0, 3.0, shape).astype(dtype)
    u[rng.uniform(size=shape) < 0.15] = 0.0
    zr, ur = z.reshape(-1, shape[-1]), u.reshape(-1, shape[-1])
    zr[0, :5] = 0.0                        # empty bins (below YMIN)
    ur[1] = 5.0                            # long walks up
    ur[2] = -5.0                           # long walks down
    ur[3] = 50.0                           # beyond the band: edge clamp
    ur[4] = -50.0
    ur[-1] = 1e-8                          # slow
    return jnp.asarray(u), jnp.asarray(z)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-4)])
@pytest.mark.parametrize("dt", [1.0, 10.0])
def test_kernels_match_banded_xla(dtype, tol, dt):
    u, z = _fields(dtype)
    want = np.asarray(growth._bott_xla(dt, u, z, 32, "banded"))
    got = np.asarray(bott_advect_gpu(u, z, dt=dt, band=32, interpret=True))
    assert got.dtype == dtype and got.shape == z.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # mass is conserved row by row, and nothing goes negative
    np.testing.assert_allclose(got.sum(-1), np.asarray(z).sum(-1),
                               rtol=10 * tol)
    assert np.all(got >= 0.0)


def test_kernels_narrow_band_and_padding():
    """A band shorter than the walks (clamped, routed to the edges) and a
    row count that is not a multiple of the program's rows."""
    u, z = _fields(np.float64, shape=(5, 70))
    want = np.asarray(growth._bott_xla(10.0, u, z, 8, "banded"))
    got = np.asarray(bott_advect_gpu(u, z, dt=10.0, band=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_layout_limits():
    u, z = _fields(np.float64, shape=(6, 200))
    with pytest.raises(ValueError, match="kernel layout"):
        bott_advect_gpu(u, z, dt=10.0, band=32, interpret=True)


def test_auto_walk_lowers_to_xla_on_cpu():
    u, z = _fields(np.float32, shape=(6, 70))
    f = jax.jit(lambda u, z: growth.bott_bin_advection(10.0, u, z))
    text = f.lower(u, z).as_text()
    assert "triton" not in text
    np.testing.assert_allclose(
        np.asarray(f(u, z)),
        np.asarray(growth._bott_xla(10.0, u, z, 32, "banded")), rtol=1e-6)
