"""Mass-conservation tests for the microphysics<->chemistry couplers.

VERDICT r4 weak #7: ``konc`` (kpp.f90:3370-3590), the aerosol mass
feedback (str.f90:5975-6134) and ``sedl`` (str.f90:2627-2792) claim mass
conservation by construction; these tests sum ions + particles before
and after each coupler at f64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.model import Model


@pytest.fixture(scope="module")
def aq_model(reference_inpdir, mechdir):
    grid = GridParams(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
    cfg = MistraConfig(chem=True, mic=True, dtype="float64", tw=288.15,
                       inpdir=reference_inpdir, mechdir=mechdir,
                       zinv=100.0, dtinv=7.0, ug=8.5, vg=0.0,
                       nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0,
                       nkc_l=4, grid=grid)
    model = Model(cfg)
    state = model.init_state()
    return model, state


def _aq_idx(drv, kc):
    return np.nonzero(np.asarray(drv.tot.species_bin) == kc)[0]


def test_konc_conserves_species(aq_model):
    """konc moves dissolved species between the 4 bins with the
    particles that crossed the ka/kw thresholds; the 4-bin total of
    every species must be unchanged."""
    model, state = aq_model
    drv = model._chemistry
    chem = state.chem
    # seed all aqueous species and perturb the spectrum so particles
    # cross bin boundaries in both directions
    conc = chem.conc
    rng = np.random.default_rng(0)
    for kc in range(1, 5):
        idx = _aq_idx(drv, kc)
        conc = conc.at[jnp.asarray(idx)].set(
            jnp.asarray(rng.random((idx.size, conc.shape[1])) * 1e-9))
    chem = chem.replace(conc=conc)
    ff_before = state.micro.ff
    ff_after = ff_before * jnp.asarray(
        rng.uniform(0.2, 2.0, ff_before.shape))
    out = drv.konc(chem, ff_before, ff_after)

    sb = np.asarray(drv.tot.species_bin)
    import re
    def basename(i):
        return re.sub(r"l[1-4]$", "", drv.tot.species[i])
    names = {}
    for kc in range(1, 5):
        for i in _aq_idx(drv, kc):
            names.setdefault(basename(i), []).append(i)
    for base, idxs in names.items():
        tot_before = np.asarray(
            sum(conc[i] for i in idxs))
        tot_after = np.asarray(sum(out.conc[i] for i in idxs))
        np.testing.assert_allclose(tot_after, tot_before, rtol=1e-12,
                                   atol=1e-22, err_msg=base)


def test_mass_feedback_conserves(aq_model):
    """aerosol_mass_feedback shifts particles along the dry-mass grid
    and carries dissolved species with the displaced volume: total
    particle number per level and the 4-bin species totals are
    invariant."""
    model, state = aq_model
    drv = model._chemistry
    rng = np.random.default_rng(1)
    conc = state.chem.conc
    for kc in range(1, 5):
        idx = _aq_idx(drv, kc)
        conc = conc.at[jnp.asarray(idx)].set(
            jnp.asarray(rng.random((idx.size, conc.shape[1])) * 1e-9))
    state = state.replace(chem=state.chem.replace(conc=conc))
    # chemistry "before" snapshot with different ion loading => mass
    # change drives the redistribution
    conc_before = conc * jnp.asarray(
        rng.uniform(0.5, 1.5, conc.shape))
    out_state = drv.aerosol_mass_feedback(state, conc_before)

    n_before = np.asarray(jnp.sum(state.micro.ff, axis=(0, 1)))
    n_after = np.asarray(jnp.sum(out_state.micro.ff, axis=(0, 1)))
    np.testing.assert_allclose(n_after, n_before, rtol=1e-10)

    import re
    names = {}
    for kc in range(1, 5):
        for i in _aq_idx(drv, kc):
            names.setdefault(
                re.sub(r"l[1-4]$", "", drv.tot.species[i]), []).append(i)
    for base, idxs in names.items():
        before = np.asarray(sum(conc[i] for i in idxs))
        after = np.asarray(sum(out_state.chem.conc[i] for i in idxs))
        np.testing.assert_allclose(after, before, rtol=1e-10,
                                   atol=1e-22, err_msg=base)


def test_sedl_closes_column_budget(aq_model):
    """sedl only moves dissolved mass downward; whatever leaves the
    column shows up in the ground reservoir (level 0), closing the
    column budget at f64."""
    model, state = aq_model
    drv = model._chemistry
    gp = model.cfg.grid
    detw = np.asarray(model.atm.detw)
    deta = np.asarray(model.atm.deta)
    rng = np.random.default_rng(2)
    conc = state.chem.conc
    nf = gp.nf
    for kc in range(1, 5):
        idx = _aq_idx(drv, kc)
        vals = rng.random((idx.size, conc.shape[1])) * 1e-9
        # the reference holds the top level as an open feeding boundary
        # (ff(nf)=ff(nf-1), str.f90:2389); zero the top so the closure
        # below is exact
        vals[:, nf - 2:] = 0.0
        conc = conc.at[jnp.asarray(idx)].set(jnp.asarray(vals))
    state = state.replace(chem=state.chem.replace(conc=conc))
    out = drv.sedl(state, 10.0)

    for kc in range(1, 5):
        idx = _aq_idx(drv, kc)
        col_b = np.asarray(conc)[idx][:, 1:nf - 1] @ detw[1:nf - 1]
        col_a = np.asarray(out.conc)[idx][:, 1:nf - 1] @ detw[1:nf - 1]
        gnd_b = np.asarray(conc)[idx, 0]
        gnd_a = np.asarray(out.conc)[idx, 0]
        # surface reservoir (level 0) is mol/m2: column loss lands there
        resid = (col_b - col_a) - (gnd_a - gnd_b)
        scale = np.abs(col_b).max() + 1e-30
        assert np.abs(resid).max() / scale < 1e-8, (kc, resid.max())
