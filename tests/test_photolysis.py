"""Photolysis tests: table parsing and J-rate magnitudes."""

import numpy as np
import pytest

from mistra_tpu.photolysis.tables import load_photolysis_tables

@pytest.fixture(scope="module")
def tb(reference_inpdir):
    return load_photolysis_tables(reference_inpdir + "photolys/")


class TestTables:
    def test_wavelength_grid(self, tb):
        nm = tb.wave * 1.0e7
        assert abs(nm[0] - 179.4) < 0.5
        assert abs(nm[-1] - 850.0) < 0.5
        assert np.all(np.diff(nm) > 0)

    def test_flux_and_cross_sections(self, tb):
        assert tb.flux.shape == (176,)
        assert tb.flux.max() > 1e14  # visible flux ~2.7e15
        # O3 Hartley band peak ~1.1e-17 cm2 near 255 nm
        o3 = tb.cs_t["O3"][0]
        assert 5e-18 < o3.max() < 2e-17
        # NO2 cross section peaks ~6e-19 near 400 nm
        assert 3e-19 < tb.cs_t["NO2"][0].max() < 1e-18
        assert list(tb.cs_t["O3"][1]) == [226.0, 263.0, 298.0]

    def test_quantum_yields(self, tb):
        assert set(tb.qy) == {"CHOH", "COH2", "NO2O", "NOO2", "NO2"}
        assert tb.qy["NO2"].max() == 1.0
        assert 0.7 < tb.qy["CHOH"].max() < 0.8

    def test_chebyshev_coefficients(self, tb):
        assert tb.cheb_a.shape == (20, 13)
        # B coefficients are ln(cross sections): large negative values
        assert tb.cheb_b.min() < -40


@pytest.fixture(scope="module")
def noon_j(reference_inpdir):
    from mistra_tpu.config import MistraConfig
    from mistra_tpu.model import Model
    from mistra_tpu.photolysis.jrates import PhotolysisDriver
    cfg = MistraConfig(chem=False, mic=False, tw=288.15, zinv=800.0,
                       inpdir=reference_inpdir,
                       dtinv=7.0, alat=55.0, nday=21, nmonth=7,
                       nyear=1982, nhour=12)
    m = Model(cfg)
    s = m.init_state()
    pd = PhotolysisDriver(m, m._radiation)
    return np.asarray(pd(s))


class TestJRates:

    def test_canonical_midday_magnitudes(self, noon_j):
        pj = noon_j
        assert pj.shape[0] == 47
        assert np.all(np.isfinite(pj)) and np.all(pj >= 0)
        # canonical clear-sky midlatitude summer surface values
        assert 3e-3 < pj[0, 1] < 2e-2       # J_NO2 ~ 8e-3
        assert 5e-6 < pj[2, 1] < 1e-4       # J_O1D ~ 2.5e-5
        assert 1e-4 < pj[46, 1] < 1e-3      # J_O3P ~ 4e-4
        assert 5e-4 < pj[3, 1] < 5e-3       # J_HONO ~ 1.8e-3
        assert 1e-6 < pj[5, 1] < 3e-5       # J_H2O2 ~ 7e-6
        assert 0.05 < pj[26, 1] < 0.4       # J_I2 ~ 0.15
        assert 0.01 < pj[21, 1] < 0.1       # J_Br2 ~ 0.03

    def test_o1d_fraction_small(self, noon_j):
        # O(1D) channel is a small fraction of total O3 photolysis at sfc
        assert noon_j[2, 1] < 0.2 * noon_j[46, 1]

    def test_profile_increases_upward(self, noon_j):
        # UV rates increase with altitude (less overhead absorption)
        assert noon_j[2, -1] >= noon_j[2, 1]


class TestNoonSweep:
    """VERDICT r5 item 10: all populated J slots at clear-sky noon vs
    published midlatitude-summer surface magnitudes (Landgraf & Crutzen
    1998 band model heritage; DeMore/JPL kinetics compilations).
    Tolerance factor 3 (band-model + albedo + column differences).

    Slot 12 (N2O5) is excluded: the reference's own sig0900.dat table
    carries no N2O5 absorption above 284 nm, so the surface rate is
    ~1e-17 regardless of implementation (real N2O5 absorbs to 380 nm).
    Slot 45 is unused in the reference.
    """

    # slot (1-based) -> literature noon surface J [1/s]
    EXPECTED = {
        1: 8.0e-3,    # NO2
        2: 2.2e-2,    # NO3 -> NO + O2
        3: 2.5e-5,    # O3 -> O(1D)
        4: 1.8e-3,    # HONO
        5: 5.5e-7,    # HNO3
        6: 7.0e-6,    # H2O2
        7: 3.0e-6,    # HNO4 (2/3 channel)
        8: 3.0e-5,    # HCHO -> H + HCO
        9: 4.4e-5,    # HCHO -> H2 + CO
        10: 1.8e-1,   # NO3 -> NO2 + O
        11: 1.5e-6,   # HNO4 (1/3 channel)
        13: 2.5e-4,   # HOCl
        14: 4.5e-5,   # ClONO2
        15: 1.2e-3,   # BrNO3
        16: 1.3e-3,   # Cl2O2
        17: 5.0e-6,   # CH3OOH
        18: 3.3e-4,   # ClNO2
        19: 2.2e-3,   # Cl2
        20: 2.0e-3,   # HOBr
        21: 5.0e-3,   # BrNO2
        22: 3.2e-2,   # Br2
        23: 1.0e-2,   # BrCl
        24: 3.5e-2,   # BrO
        25: 3.0e-1,   # IO
        26: 6.0e-3,   # HOI
        27: 1.5e-1,   # I2
        28: 2.2e-2,   # ICl
        29: 6.5e-2,   # IBr
        30: 3.7e-3,   # INO3
        31: 6.0e-6,   # CH3I
        32: 1.8e-5,   # C3H7I
        33: 1.4e-4,   # CH2ClI
        34: 7.0e-3,   # CH2I2
        35: 7.4e-2,   # OClO
        37: 3.0e-3,   # INO2
        38: 3.5e-4,   # NO2m (aqueous nitrite)
        39: 3.5e-7,   # NO3n (aqueous nitrate)
        47: 4.0e-4,   # O3 -> O(3P)
    }
    # derived slots fixed by construction (jrates.py): 36 = 9*J16,
    # 40 = J35, 44 = J34/17, 46 = J31
    DERIVED = {36: (16, 9.0), 40: (35, 1.0), 44: (34, 1.0 / 17.0),
               46: (31, 1.0)}

    def test_all_slots_within_3x(self, noon_j):
        pj = noon_j[:, 1]
        bad = []
        for slot, ref in self.EXPECTED.items():
            v = pj[slot - 1]
            if not (ref / 3.0 < v < ref * 3.0):
                bad.append((slot, float(v), ref))
        assert not bad, f"J slots outside 3x of literature: {bad}"

    def test_derived_slots(self, noon_j):
        pj = noon_j[:, 1]
        for slot, (src, fac) in self.DERIVED.items():
            np.testing.assert_allclose(pj[slot - 1],
                                       fac * pj[src - 1], rtol=1e-6)
