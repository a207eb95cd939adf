"""Multiphase chemistry sharded over the virtual 8-device mesh.

The sharded path must exercise nkc_l >= 2: the full liq_parm aqueous
stack + block-arrow stiff solver compiled and run under dp sharding,
not just the gas path.  Slow-marked: the CPU compile alone takes many
minutes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.mark.slow
def test_multiphase_sharded_step(reference_inpdir, mechdir):
    from mistra_tpu.config import GridParams, MistraConfig
    from mistra_tpu.model import Model
    from mistra_tpu.parallel import mesh as pmesh

    grid = GridParams(nf=10, n_extra=6, nka=8, nkt=8, nb=8)
    cfg = MistraConfig(chem=True, mic=True, dtype="float32", tw=288.15,
                       inpdir=reference_inpdir, mechdir=mechdir,
                       zinv=60.0, dtinv=7.0, ug=8.5, vg=0.0,
                       nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0,
                       nkc_l=2, grid=grid)
    model = Model(cfg)
    state = model.init_state()
    mesh = pmesh.make_mesh(n_devices=8)
    ens = pmesh.shard_state(pmesh.replicate_state(state, 8), mesh)
    step = pmesh.make_ensemble_step(model, mesh, donate=False)
    out = step(ens)
    jax.block_until_ready(out)
    assert bool(jnp.all(jnp.isfinite(out.met.t)))
    assert bool(jnp.all(jnp.isfinite(out.chem.conc)))
    assert out.met.t.shape[0] == 8
