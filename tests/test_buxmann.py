"""Buxmann15_alpha variant mechanism (mech_Buxmann15alpha).

The Stage-5 north-star case: a chamber run with its own mechanism
directory and species list (namelist.Buxmann15_alpha:8-11; the variant
differs from the default only in master_gas.eqn — alkyl nitrates RAN1,
ALKE, and the ClONO/Br2O dummy closures — plus the species CSV).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mistra_tpu.chemistry.gas_kernel import GasKernel
from mistra_tpu.chemistry.mech import (load_gas_mechanism,
                                       load_multiphase_mechanism)

@pytest.fixture(scope="module")
def buxdir(mechdir):
    return mechdir.rstrip("/") + "_Buxmann15alpha"


def test_buxmann_gas_mechanism_loads(buxdir):
    m = load_gas_mechanism(buxdir)
    # KPP regenerates NVAR=108 / NREACT=347 for this variant (the six
    # new gas reactions C50-C53 + the two dummy closures)
    assert m.nvar == 108
    assert m.nrxn == 347
    for sp in ("RAN1", "ALKE", "ClONO", "Br2O"):
        assert sp in m.species, sp


def test_buxmann_tot_block_solver(buxdir):
    """The 427-var Buxmann tot mechanism keeps the block-arrow shape
    and the stage solver stays exact."""
    mech = load_multiphase_mechanism(buxdir, name="tot")
    assert mech.nvar == 427
    assert mech.nrxn == 1645
    kern = GasKernel(mech, dtype=jnp.float64, solver="block")
    rng = np.random.default_rng(0)
    B = 2
    y = jnp.asarray(rng.random((B, mech.nvar)) * 1e-8)
    k = jnp.asarray(rng.random((B, mech.nrxn)) * 1e-3)
    fix = jnp.asarray(rng.random((B, len(mech.fixed))) * 10)
    ghinv = jnp.asarray(np.full(B, 4.2))
    rhs = jnp.asarray(rng.random((B, mech.nvar)))

    @jax.jit
    def resid(y, rhs):
        ctx = kern.block.assemble(kern.kw_weights(y, k, fix))
        fact = kern.block.prepare(ctx, ghinv)
        x = kern.block.solve(fact, rhs)
        jx = jax.jvp(lambda yy: kern.fun(yy, k, fix), (y,), (x,))[1]
        return ghinv[:, None] * x - jx - rhs

    assert float(jnp.abs(resid(y, rhs)).max()) < 1e-10


@pytest.mark.slow
def test_buxmann_chamber_minute(buxdir, reference_inpdir):
    """One chamber minute with the variant mechanism + species CSV
    (gas chemistry; the 3-h acceptance run lives in the harness)."""
    from mistra_tpu.boxmodel import BoxModel
    from mistra_tpu.config import MistraConfig, GridParams

    cfg = MistraConfig(
        chamber=True, box=False, chem=True, mic=False, halo=True,
        iod=False, nkc_l=0, mechdir=buxdir, inpdir=reference_inpdir,
        cgaslistfile="gas_species_Buxmann15.csv",
        grid=GridParams(nf=20, n_extra=10, nka=8, nkt=8, nb=8),
        zinv=100.0, tw=288.40, rhsurf=0.6, ug=7.0, vg=0.0,
        alat=-75.6, z0=1.0e-5, lp_buxmann15alph=True)
    bm = BoxModel(cfg)
    state = bm.init_state()
    step = bm.jit_minute_step()
    state = step(state)
    conc = np.asarray(state.chem.sgas)
    assert np.all(np.isfinite(conc))
    assert float(state.tim.time) == 60.0
