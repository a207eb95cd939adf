"""End-to-end dry-column smoke/physics tests (stage 1: chem=F, mic=F)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.config import MistraConfig
from mistra_tpu.model import Model


@pytest.fixture(scope="module")
def model(synthetic_inpdir):
    cfg = MistraConfig(chem=False, mic=False, lstmax=1, tw=288.15,
                       inpdir=synthetic_inpdir,
                       ug=8.5, vg=0.0, zinv=800.0, dtinv=7.0,
                       xm1w=0.009, xm1i=0.004, nw_prof_opt=1,
                       wmax=-0.005, z0=0.0001, alat=55.0,
                       nday=21, nmonth=7, nyear=1982)
    return Model(cfg)


@pytest.fixture(scope="module")
def state0(model):
    return model.init_state()


def test_initial_profiles(model, state0):
    n = model.cfg.grid.n
    t = np.asarray(state0.met.t)
    p = np.asarray(state0.met.p)
    # surface at SST, dry adiabatic below the inversion
    assert np.isclose(t[0], 288.15)
    eta = model.grids.atm.eta
    kinv = int(state0.tim.kinv)
    assert np.isclose(eta[kinv], 795.0, atol=10.0)
    lapse = (t[1:kinv + 1] - t[0]) / eta[1:kinv + 1]
    np.testing.assert_allclose(lapse, -0.0098, rtol=1e-6)
    # inversion jump
    assert t[kinv + 1] > t[kinv] + 5.0
    # hydrostatic pressure decreasing, reasonable scale height
    assert p[0] > p[-1]
    assert 75000.0 < p[-1] < 101325.0
    # humidity: below-inversion value capped by saturation
    xm1 = np.asarray(state0.met.xm1)
    assert np.all(xm1[1:kinv] <= 0.009 + 1e-12)
    feu = np.asarray(state0.met.feu)
    assert np.all(feu[1:] < 1.0)
    assert np.all(feu[1:] > 0.0)


def test_initial_turbulence(model, state0):
    atkm = np.asarray(state0.turb.atkm)
    assert np.all(atkm[:-1] >= 1e-3)
    assert atkm[-1] == 0.0
    assert float(state0.surf.ustern) > 0.01


def test_minute_step_stability(model, state0):
    """March 30 minutes: fields stay finite and physically sane."""
    step = model.jit_minute_step()
    state = state0
    for _ in range(30):
        state = step(state)
    t = np.asarray(state.met.t)
    tke = np.asarray(state.met.tke)
    xm1 = np.asarray(state.met.xm1)
    assert np.all(np.isfinite(t)) and np.all((t > 200) & (t < 330))
    assert np.all(np.isfinite(tke)) and np.all(tke >= 1e-6)
    assert np.all(xm1 >= 0) and np.all(xm1 < 0.05)
    u = np.asarray(state.met.u)
    v = np.asarray(state.met.v)
    assert np.all(np.abs(u) < 30) and np.all(np.abs(v) < 30)
    # clock advanced
    assert int(state.tim.lmin) == 30
    assert float(state.tim.time) == 30 * 60.0


def test_surface_layer_develops(model, state0):
    """The sheared boundary layer must generate TKE near the surface."""
    step = model.jit_minute_step()
    state = state0
    for _ in range(60):
        state = step(state)
    tke = np.asarray(state.met.tke)
    # TKE above the initial floor in the BL shear zone
    assert tke[1:20].max() > 0.05
    # exchange coefficients grew beyond the neutral initialisation
    atkm = np.asarray(state.turb.atkm)
    assert atkm[1:30].max() > 0.1


def test_theta_profile_preserved_above_bl(model, state0):
    step = model.jit_minute_step()
    state = state0
    for _ in range(10):
        state = step(state)
    th0 = np.asarray(state0.met.theta)
    th1 = np.asarray(state.met.theta)
    # free troposphere barely changes in 10 minutes without radiation
    np.testing.assert_allclose(th1[120:-1], th0[120:-1], atol=0.2)
