"""Checks that need an NVIDIA GPU (marker ``gpu``); they skip elsewhere.

Run on a GPU machine with ``python -m pytest tests/ -q -m gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.config import BTZ96, GridParams, MistraConfig


@pytest.mark.gpu
def test_batched_inv_on_gpu(gpu_device):
    from mistra_tpu.chemistry.block_solver import batched_inv
    rng = np.random.default_rng(0)
    m = 80
    a = rng.uniform(-1.0, 1.0, (64, m, m)) + 0.5 * m * np.eye(m)
    x = np.asarray(jax.jit(batched_inv)(jax.device_put(a, gpu_device)))
    assert np.abs(np.einsum("bij,bjk->bik", a, x) - np.eye(m)).max() < 1e-11


@pytest.mark.gpu
def test_tiny_column_gpu_matches_cpu(gpu_device, synthetic_inpdir):
    from mistra_tpu.model import Model
    cfg = MistraConfig(inpdir=synthetic_inpdir, **{
        **BTZ96, "zinv": 100.0,
        "grid": GridParams(nf=12, n_extra=6, nka=8, nkt=8, nb=8)})
    model = Model(cfg)
    s0 = model.init_state()
    step = jax.jit(model.minute_step)
    out = {}
    for dev in (gpu_device, jax.devices("cpu")[0]):
        s = jax.device_put(s0, dev)
        for _ in range(2):
            s = step(s)
        out[dev.platform] = np.asarray(s.met.t)
    np.testing.assert_allclose(out["gpu"], out["cpu"], rtol=1e-9)
    assert bool(jnp.all(jnp.isfinite(out["gpu"])))
