"""Radiation stack tests: tables, solver physics, day/night behavior."""

import numpy as np
import pytest

from mistra_tpu.radiation import tables as T


class TestTables:
    def test_pifm2_parsing(self, reference_inpdir):
        tb = T.load_pifm2(reference_inpdir)
        # total solar energy matches the value the reference derives
        assert abs(tb.s0tot - 1339.94507) < 1e-4
        # quadrature weights per band sum to ~1
        for b in range(1, 19):
            assert 0.9 < tb.hk[b].sum() < 1.1
        assert sum(len(tb.hk[b]) for b in tb.hk) == 121
        # droplet optics table spans 4.18 - 31.23 um
        assert abs(tb.ret[0] - 4.18e-6) < 1e-9
        assert abs(tb.ret[-1] - 3.123e-5) < 1e-9

    def test_mie_interpolation(self, synthetic_inpdir):
        from mistra_tpu.config import MistraConfig
        from mistra_tpu.grids import make_grids
        mie = T.load_mie_tables(synthetic_inpdir)
        g = make_grids(MistraConfig(chem=False))
        qa, qe, asym = T.interpolate_particle_optics(
            mie, g.micro.rn, g.micro.rq)
        assert qa.shape == (18, 70, 70, 3)
        assert np.all(qe >= qa - 1e-12)          # extinction >= absorption
        assert np.all((asym >= -0.01) & (asym <= 1.0))
        assert np.all(qa >= 0)


class TestPlanck:
    def test_stefan_boltzmann_consistency(self):
        """Sum of the 12 IR band integrals must be below sigma T^4 / pi
        and approach it as the bands cover 2200-0 cm^-1."""
        import jax.numpy as jnp
        from mistra_tpu.radiation.solver import WVL, plkavg
        t = 288.0
        total = sum(float(plkavg(WVL[b + 1], WVL[b], jnp.asarray(t)))
                    for b in range(12))
        sigma_t4_over_pi = 5.67032e-8 * t ** 4 / np.pi
        # bands 2200..0 cm^-1 cover almost all thermal emission at 288 K
        assert 0.9 * sigma_t4_over_pi < total <= sigma_t4_over_pi * 1.001

    def test_planck_monotone_in_t(self):
        import jax.numpy as jnp
        from mistra_tpu.radiation.solver import plkavg
        v = [float(plkavg(540.0, 670.0, jnp.asarray(t)))
             for t in (250.0, 270.0, 290.0, 310.0)]
        assert all(b > a for a, b in zip(v, v[1:]))


class TestFullSolve:
    @pytest.fixture(scope="class")
    def states(self, synthetic_inpdir):
        from mistra_tpu.config import MistraConfig
        from mistra_tpu.model import Model
        out = {}
        for label, hour in [("noon", 12), ("midnight", 0)]:
            cfg = MistraConfig(chem=False, mic=False, tw=288.15, zinv=800.0,
                               inpdir=synthetic_inpdir,
                               dtinv=7.0, alat=55.0, nday=21, nmonth=7,
                               nyear=1982, nhour=hour)
            m = Model(cfg)
            out[label] = (m, m.init_state())
        return out

    def test_noon_fluxes(self, states):
        m, s = states["noon"]
        assert float(s.rad.u0) > 0.7
        dtrad = np.asarray(s.rad.dtrad) * 86400.0
        assert np.all(np.isfinite(dtrad))
        # net solar at the surface positive and below the solar constant
        assert 0.0 < float(s.rad.sk) < 1400.0
        # downward longwave at surface: typical clear-sky 250-400 W/m2
        assert 150.0 < float(s.rad.sl) < 450.0
        assert np.abs(dtrad).max() < 50.0

    def test_midnight_cooling(self, states):
        m, s = states["midnight"]
        assert float(s.rad.u0) < 0.01
        dtrad = np.asarray(s.rad.dtrad) * 86400.0
        # boundary layer cools radiatively at night (clear sky)
        assert np.all(dtrad[1:60] < 0.0)
        assert -8.0 < dtrad[1:60].mean() < -0.3
        assert float(s.rad.sk) == pytest.approx(0.0, abs=1e-6)

    def test_solar_heats_relative_to_night(self, states):
        _, s_noon = states["noon"]
        _, s_night = states["midnight"]
        d_noon = np.asarray(s_noon.rad.dtrad)
        d_night = np.asarray(s_night.rad.dtrad)
        # adding sunlight must increase the column-mean heating rate
        assert d_noon[1:100].mean() > d_night[1:100].mean()
