import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.physics.growth import bott_bin_advection
from mistra_tpu.physics.sedimentation import advsed0, advsed1, vterm


class TestVterm:
    def test_magnitudes(self):
        t, p = 288.15, 101325.0
        # 1 um aerosol: ~1e-4 m/s; 10 um: ~1.2e-2; 100 um: ~0.7-0.9 m/s
        v1 = float(vterm(1e-6, t, p))
        v10 = float(vterm(1e-5, t, p))
        v100 = float(vterm(1e-4, t, p))
        assert 5e-5 < v1 < 5e-4
        assert 5e-3 < v10 < 5e-2
        assert 0.3 < v100 < 1.5

    def test_monotone_in_radius(self):
        r = jnp.logspace(-7, -4, 50)
        v = np.asarray(vterm(r, 280.0, 90000.0))
        assert np.all(np.diff(v) > 0)

    def test_regime_continuity(self):
        # Stokes and Beard branches should roughly agree at the 10 um switch
        lo = float(vterm(0.999e-5, 288.0, 101325.0))
        hi = float(vterm(1.001e-5, 288.0, 101325.0))
        assert abs(lo - hi) / lo < 0.2


class TestBottBinAdvection:
    def test_zero_velocity_identity(self):
        z = jnp.asarray(np.random.default_rng(0).uniform(0, 1, 70))
        u = jnp.zeros(70)
        out = bott_bin_advection(10.0, u, z)
        np.testing.assert_allclose(np.asarray(out), np.asarray(z), atol=1e-14)

    def test_mass_conservation_interior(self):
        rng = np.random.default_rng(1)
        z = np.zeros(70)
        z[20:30] = rng.uniform(0.5, 2.0, 10)
        u = jnp.full(70, 0.23)  # slow uniform growth, CFL < 1
        out = np.asarray(bott_bin_advection(1.0, jnp.asarray(u),
                                            jnp.asarray(z)))
        np.testing.assert_allclose(out.sum(), z.sum(), rtol=1e-12)
        assert np.all(out >= 0)

    def test_uniform_shift(self):
        # velocity 1 bin per unit time, dt=3 => peak moves 3 bins
        z = np.zeros(70)
        z[10] = 1.0
        u = jnp.ones(70)
        out = np.asarray(bott_bin_advection(3.0, u, jnp.asarray(z)))
        assert np.argmax(out) == 13
        np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-12)

    def test_fractional_shift_splits_two_bins(self):
        z = np.zeros(70)
        z[10] = 1.0
        u = jnp.full(70, 0.5)
        out = np.asarray(bott_bin_advection(1.0, u, jnp.asarray(z)))
        # mass only in bins 10 and 11
        assert out[10] > 0 and out[11] > 0
        np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-12)
        assert np.all(out[np.r_[0:10, 12:70]] == 0)

    def test_negative_velocity_evaporation(self):
        z = np.zeros(70)
        z[30] = 1.0
        u = jnp.full(70, -1.0)
        out = np.asarray(bott_bin_advection(2.0, u, jnp.asarray(z)))
        assert np.argmax(out) == 28
        np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-12)

    def test_batched(self):
        rng = np.random.default_rng(2)
        z = rng.uniform(0, 1, (5, 70))
        u = rng.uniform(-0.5, 0.5, (5, 70))
        outb = np.asarray(bott_bin_advection(1.0, jnp.asarray(u),
                                             jnp.asarray(z)))
        for b in range(5):
            single = np.asarray(bott_bin_advection(
                1.0, jnp.asarray(u[b]), jnp.asarray(z[b])))
            np.testing.assert_allclose(outb[b], single, atol=1e-14)

    def test_banded_walk_matches_vector_walk(self):
        from mistra_tpu.physics.growth import _walk_banded, _walk_vector
        rng = np.random.default_rng(7)
        nkt = 70
        # mixed-sign velocity fields incl. zeros, large and tiny magnitudes
        u = rng.uniform(-3.0, 3.0, (64, nkt))
        u[rng.uniform(size=u.shape) < 0.15] = 0.0
        u[0, :] = 5.0          # fast everywhere: long walks
        u[1, :] = -5.0
        u[2, :] = 1e-8         # slow
        u = jnp.asarray(u)
        for dt in (1.0, 10.0):
            xv = np.asarray(_walk_vector(dt, u))
            xb = np.asarray(_walk_banded(dt, u, nkt))   # J = nkt: exact
            np.testing.assert_allclose(xb, xv, rtol=1e-6, atol=1e-5)

    def test_banded_band_sufficient_for_moderate_walks(self):
        from mistra_tpu.physics.growth import _walk_banded, _walk_vector
        rng = np.random.default_rng(8)
        u = jnp.asarray(rng.uniform(-2.0, 2.0, (32, 70)))
        # dt=10 with |u|<2: walks can reach 20 bins; J=32 must be exact
        xv = np.asarray(_walk_vector(10.0, u))
        xb = np.asarray(_walk_banded(10.0, u, 32))
        np.testing.assert_allclose(xb, xv, rtol=1e-6, atol=1e-5)

    def test_banded_deposit_clamps_offgrid_to_edges(self):
        # u>0 everywhere and huge: everything must pile up in the top bin
        z = jnp.asarray(np.linspace(1.0, 2.0, 70))
        out = np.asarray(bott_bin_advection(10.0, jnp.full(70, 50.0), z,
                                            band=70))
        np.testing.assert_allclose(out[-1], float(jnp.sum(z)), rtol=1e-6)
        assert np.all(out[:-1] == 0.0)
        out2 = np.asarray(bott_bin_advection(10.0, jnp.full(70, -50.0), z,
                                             band=70))
        np.testing.assert_allclose(out2[0], float(jnp.sum(z)), rtol=1e-6)
        assert np.all(out2[1:] == 0.0)

    def test_banded_clamp_conserves_mass(self):
        # walks longer than the band are clamped to the band edge but must
        # conserve mass and stay positive
        rng = np.random.default_rng(9)
        z = jnp.asarray(rng.uniform(0.1, 1.0, (4, 70)))
        u = jnp.asarray(rng.uniform(-60.0, 60.0, (4, 70)))
        out = np.asarray(bott_bin_advection(10.0, u, z, band=16))
        assert np.all(out >= 0)
        np.testing.assert_allclose(out.sum(-1), np.asarray(z).sum(-1),
                                   rtol=1e-5)


class TestAdvsed:
    def test_advsed0_mass_conserving(self):
        rng = np.random.default_rng(3)
        nf = 100
        y = jnp.asarray(rng.uniform(0, 1, nf))
        c = jnp.full(nf, -0.3)  # downward
        c = c.at[0].set(c[1]).at[nf - 1].set(0.0)
        out = np.asarray(advsed0(c, y))
        # interior update conserves: sum change = boundary fluxes
        # here: top flux = 0 (c[nf-1]=0); mass leaves only into level 0
        assert np.all(out[1:-1] >= -1e-14)
        total_in = float(np.asarray(y)[1:-1].sum())
        total_out = out[1:-1].sum()
        assert total_out <= total_in + 1e-12

    def test_advsed1_positive_and_bounded(self):
        rng = np.random.default_rng(4)
        nf = 100
        y = np.zeros(nf)
        y[40:60] = rng.uniform(0.5, 2.0, 20)
        y[0] = y[1]
        c = jnp.full(nf, -0.4)
        c = c.at[nf - 1].set(0.0)
        out = np.asarray(advsed1(c, jnp.asarray(y)))
        assert np.all(out >= -1e-12)
        # total mass including the ground box is conserved (no top inflow)
        np.testing.assert_allclose(out.sum(), y.sum(), rtol=1e-12)

    def test_advsed1_moves_mass_down(self):
        nf = 100
        y = np.zeros(nf)
        y[50] = 1.0
        c = jnp.full(nf, -0.5)
        c = c.at[nf - 1].set(0.0)
        out = np.asarray(advsed1(c, jnp.asarray(y)))
        com_before = np.sum(np.arange(nf) * y) / y.sum()
        com_after = np.sum(np.arange(nf) * out) / out.sum()
        assert com_after < com_before


class TestFogFormation:
    """Integration: BTZ96-like run with microphysics develops fog LWC."""

    @pytest.fixture(scope="class")
    def model(self, synthetic_inpdir):
        from mistra_tpu.config import GridParams, MistraConfig
        from mistra_tpu.model import Model
        # reduced grid: full physics structure at ~1/10 the size so the
        # integration fits the CPU test budget (full size is covered by
        # chip_smoke.py on the GPU)
        grid = GridParams(nf=40, n_extra=14, nka=24, nkt=24, nb=12)
        cfg = MistraConfig(chem=False, mic=True, tw=288.15, ug=8.5, vg=0.0,
                           zinv=300.0, dtinv=7.0, xm1w=0.009, xm1i=0.004,
                           nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0,
                           rnw0=0.01, rnw1=2.0, rw0=0.01, rw1=80.0,
                           nday=21, nmonth=7, nyear=1982, grid=grid,
                           inpdir=synthetic_inpdir)
        return Model(cfg)

    def test_microphysics_run_stable(self, model):
        state = model.init_state()
        # initial aerosol loading present
        assert float(jnp.sum(state.micro.ff)) > 0
        xm2_init = np.asarray(state.met.xm2)
        assert np.all(xm2_init >= 0)
        step = model.jit_minute_step()
        for _ in range(10):
            state = step(state)
        ff = np.asarray(state.micro.ff)
        assert np.all(np.isfinite(ff))
        assert np.all(ff >= -1e-10)
        xm2 = np.asarray(state.met.xm2)
        assert np.all(np.isfinite(xm2)) and np.all(xm2 >= 0)
        t = np.asarray(state.met.t)
        assert np.all((t > 200) & (t < 330))
        feu = np.asarray(state.met.feu)
        assert np.all(feu[1:model.cfg.grid.nf] < 1.3)
        # deposition accounting moves forward
        assert float(state.surf.trdep) >= 0
