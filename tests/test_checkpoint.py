"""Checkpoint / restart equivalence (C5 / section 5.4 of SURVEY.md).

The reference restart property: integrating N minutes must equal
integrating N/2, writing rstm/rstc, restoring, and integrating N/2 more
(outm/outc, outp.f90:55-313; startm/startc, str.f90:1914-2163).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.io.checkpoint import restore_checkpoint, save_checkpoint
from mistra_tpu.model import Model


@pytest.fixture(scope="module")
def model(synthetic_inpdir):
    cfg = MistraConfig(chem=False, mic=False, dtype="float64",
                       inpdir=synthetic_inpdir,
                       grid=GridParams(nf=16, n_extra=8, nka=8, nkt=8,
                                       nb=8),
                       zinv=100.0, tw=288.15, dtinv=7.0, ug=8.5, vg=0.0,
                       nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
    return Model(cfg)


def test_restart_equivalence(model, tmp_path):
    step = jax.jit(model.minute_step)
    s0 = model.init_state()

    s_direct = s0
    for _ in range(3):
        s_direct = step(s_direct)

    s_half = s0
    for _ in range(2):
        s_half = step(s_half)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), s_half)
    s_rest = restore_checkpoint(ckpt, jax.tree.map(jnp.zeros_like, s_half))
    # restored state is bitwise the saved state
    for a, b in zip(jax.tree.leaves(s_half), jax.tree.leaves(s_rest)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    s_cont = step(s_rest)
    np.testing.assert_allclose(np.asarray(s_cont.met.t),
                               np.asarray(s_direct.met.t), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(s_cont.met.tke),
                               np.asarray(s_direct.met.tke))
    assert float(s_cont.tim.time) == float(s_direct.tim.time)
