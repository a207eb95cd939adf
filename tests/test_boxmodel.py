"""Box / chamber mode tests (reference str.f90:6613-7950)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.config import GridParams, MistraConfig


def tiny_grid():
    return GridParams(nf=12, n_extra=6, nka=16, nkt=16, nb=8)


class TestBoxMode:
    @pytest.fixture(scope="class")
    def box(self, reference_inpdir, mechdir):
        from mistra_tpu.boxmodel import BoxModel
        cfg = MistraConfig(grid=tiny_grid(), chem=True, mic=True, nkc_l=0,
                           inpdir=reference_inpdir, mechdir=mechdir,
                           zinv=100.0, box=True, nlevbox=5, z_box=50.0,
                           rst=False, netcdf=False)
        return BoxModel(cfg)

    def test_init_copies_level(self, box):
        st = box.init_state()
        # box level carries the nlevbox temperature/humidity (box_init)
        np.testing.assert_allclose(float(st.met.t[1]),
                                   float(st.met.t[box.cfg.nlevbox - 1]))
        assert 0.0 < float(st.met.feu[1]) < 1.0
        assert int(st.tim.kinv) == box.cfg.grid.nf

    def test_minute_step_runs_chemistry(self, box):
        st = box.init_state()
        st2 = box.minute_step(st)
        assert float(st2.tim.time) == 60.0
        n2i = box.model._chemistry.name2i
        o3 = float(st2.chem.sgas[n2i["O3"], 1])
        assert 1e-7 < o3 < 1e-5          # ~tens of ppb in mol/m3
        # deposition moved mass into the ground bucket (level 0)
        assert float(st2.chem.sgas[n2i["O3"], 0]) > 0.0


class TestChamberMode:
    def test_chamber_lights_schedule(self, reference_inpdir, mechdir):
        from mistra_tpu.boxmodel import BoxModel
        cfg = MistraConfig(grid=tiny_grid(), chem=True, mic=True, nkc_l=0,
                           inpdir=reference_inpdir, mechdir=mechdir,
                           zinv=100.0, chamber=True, z_box=50.0,
                           rst=False, netcdf=False)
        bm = BoxModel(cfg)
        st = bm.init_state()
        # chamber.dat initial conditions (t0=288.23 K, rh0=70.35 %)
        np.testing.assert_allclose(float(st.met.t[1]), 288.23)
        np.testing.assert_allclose(float(st.met.feu[1]), 0.7035)
        assert int(st.tim.lst) == 12
        st1 = bm.minute_step(st)
        assert float(st1.chem.photol_j[0, 1]) == 0.0      # lights off
        st1 = st1.replace(tim=st1.tim.replace(time=16.0 * 60))
        st2 = bm.minute_step(st1)
        # measured jNO2 from chamber.dat once lights are on
        np.testing.assert_allclose(float(st2.chem.photol_j[0, 1]), 6.3e-3)
