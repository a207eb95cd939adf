"""Chemistry engine tests: mechanism parsing, rate laws, Ros3 integration."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from mistra_tpu.chemistry.gas_kernel import GasKernel, load_species_csv
from mistra_tpu.chemistry.mech import load_gas_mechanism, parse_eqn
from mistra_tpu.chemistry.rates import RateEnv

def _env(B=1, te=288.15, dark=True):
    am3 = 101325.0 / (8.3144743 * te)
    cm3 = am3 * 6.022140857e17
    ph = jnp.zeros((B, 47))
    return RateEnv(te=jnp.full((B,), te), aircc=jnp.full((B,), cm3),
                   h2oppm=jnp.full((B,), 1.2e4),
                   pk=jnp.full((B,), 101325.0), ph_rat=ph), am3


class TestToyMechanism:
    def test_linear_chain_analytic(self):
        toy = parse_eqn("{t1} A = B : 1.0 ;\n{t2} B = CC : 0.5 ;",
                        fixed=())
        kern = GasKernel(toy)
        env, _ = _env()
        k = kern.rate_constants(env)
        y0 = jnp.array([[1.0, 0.0, 0.0]])
        fix = jnp.zeros((1, 0))
        y, info = kern.integrate(y0, k, fix, 2.0)
        A = math.exp(-2.0)
        B = (math.exp(-2.0) - math.exp(-1.0)) / (0.5 - 1.0) * 0.5 * 2 \
            if False else 1.0 / (0.5 - 1.0) * (math.exp(-2.0)
                                               - math.exp(-1.0))
        C = 1.0 - A - B
        np.testing.assert_allclose(np.asarray(y[0]), [A, B, C], rtol=1e-3)
        assert bool(info["done"][0])

    def test_jacobian_matches_autodiff(self):
        import jax
        toy = parse_eqn(
            "{t1} A + B = CC : 2.0 ;\n{t2} CC = A + B : 0.3 ;\n"
            "{t3} A + A = B : 0.1 ;", fixed=())
        kern = GasKernel(toy)
        env, _ = _env()
        k = kern.rate_constants(env)
        fix = jnp.zeros((1, 0))
        y = jnp.array([[0.5, 1.5, 0.7]])
        J = np.asarray(kern.jac(y, k, fix)[0])
        J_ad = np.asarray(jax.jacobian(
            lambda yy: kern.fun(yy[None], k, fix)[0])(y[0]))
        np.testing.assert_allclose(J, J_ad, rtol=1e-12)


class TestGasMechanism:
    @pytest.fixture(scope="class")
    def mech(self, mechdir):
        return load_gas_mechanism(mechdir)

    def test_mechanism_size(self, mech):
        # exact parity with the KPP-generated gas mechanism:
        # NVAR=102 / NREACT=331 (gas_Parameters.h:26-49) = master_gas.eqn
        # plus the 8 active het-on-dry-aerosol reactions of gas.eqn
        assert mech.nvar == 102
        assert mech.nrxn == 331
        assert mech.fixed == ["O2", "N2", "H2O"]
        # het product species carry their aerosol-bin tag; gas-phase names
        # that merely end in "l2" (Cl2) must stay gas-phase
        binned = {s for s, b in zip(mech.species, mech.species_bin) if b}
        assert binned == {"HNO3l1", "DUMM1", "NH3l1", "SO4l1",
                          "HNO3l2", "NH3l2", "SO4l2"}
        # every reaction has at most 3 reactant slots, all valid
        assert mech.ridx.shape[1] == 3

    def test_mass_action_stoichiometry(self, mech):
        # O1D + O2 = O3P: first reaction consumes O1D, produces O3P
        rx = mech.reactions[0]
        assert rx.label == "O1"
        sp = {s: i for i, s in enumerate(mech.species)}
        assert mech.stoich[0, sp["O1D"]] == -1
        assert mech.stoich[0, sp["O3P"]] == 1

    def test_dark_stability_and_positivity(self, mech, mechdir):
        kern = GasKernel(mech)
        env, am3 = _env(B=2)
        sp_csv = load_species_csv(mechdir + "gas_species.csv")
        name2i = {s: i for i, s in enumerate(mech.species)}
        y0 = np.zeros((2, mech.nvar))
        xm = am3 * 1e-9
        for s in sp_csv:
            if s["name"] in name2i:
                y0[:, name2i[s["name"]]] = s["ground_ppb"] * xm
        vals = {"O2": 0.21 * am3, "N2": 0.79 * am3, "H2O": 0.012 * am3}
        fix = jnp.stack([jnp.full((2,), vals[s]) for s in mech.fixed],
                        axis=-1)
        k = kern.rate_constants(env, fix=fix)
        assert bool(jnp.all(jnp.isfinite(k)))
        y, info = kern.integrate(jnp.asarray(y0), k, fix, 10.0)
        y = np.asarray(y)
        assert np.all(np.isfinite(y))
        assert np.all(y >= -1e-20)
        assert np.all(np.asarray(info["done"]))
        # dark, 10 s: O3 essentially unchanged
        o3 = name2i["O3"]
        np.testing.assert_allclose(y[0, o3], y0[0, o3], rtol=1e-4)
        # halved steps give the same answer (adaptive-solver consistency)
        y_half1, _ = kern.integrate(jnp.asarray(y0), k, fix, 5.0)
        y_half2, _ = kern.integrate(y_half1, k, fix, 5.0)
        big = y0[0] > 1e-12
        np.testing.assert_allclose(np.asarray(y_half2)[0][big], y[0][big],
                                   rtol=1e-2)


class TestAerosolSources:
    def test_ion_loading_table_seasalt_ratios(self):
        from mistra_tpu.chemistry.sources import ion_loading_table
        from mistra_tpu.config import GridParams, MistraConfig
        from mistra_tpu.grids import make_grids
        cfg = MistraConfig(grid=GridParams(nf=12, n_extra=6, nka=24,
                                           nkt=24, nb=8), zinv=100.0)
        grids = make_grids(cfg)
        from mistra_tpu.init import koehler_coefficients
        _, _, fcs, xmol3 = koehler_coefficients(cfg, grids.micro.rn)
        sa1 = ion_loading_table(cfg, grids, fcs, xmol3)
        rn = grids.micro.rn
        large = rn >= 0.5
        # seawater molar ratios on the sea-salt mode
        np.testing.assert_allclose(sa1["Brm"][large] / sa1["Clm"][large],
                                   1.45e-3 / (1.0 - 0.0485 - 4.2e-3 - 1e-7
                                              - 1.45e-3 - 7.4e-8 / 0.545
                                              - 2.64e-7 / 0.545), rtol=1e-12)
        # ammonium sulfate mode carries no halogens
        assert np.all(sa1["Clm"][~large] == 0.0)
        assert np.all(sa1["NH4p"][~large] > 0.0)
        assert np.all(sa1["NH4p"][large] == 0.0)

    def test_apply_initial_ions(self):
        from mistra_tpu.chemistry.sources import apply_initial_ions
        nka, nkt, n = 4, 3, 6
        ka = 2
        ff = jnp.ones((nkt, nka, n))
        sa1 = {"Clm": np.array([0.0, 0.0, 2.0, 3.0]),
               "NH4p": np.array([1.0, 1.0, 0.0, 0.0])}
        n2i = {"Clml2": 0, "NH4pl1": 1}
        conc = jnp.zeros((2, n))
        out = apply_initial_ions(conc, sa1, ff, n2i, ka, 2, jnp.float64)
        # interior levels only
        assert float(out[0, 0]) == 0.0 and float(out[0, n - 1]) == 0.0
        # bin2 Cl-: ap=nkt per dry bin, (2+3)*3*1e6
        np.testing.assert_allclose(out[0, 1], 5 * 3 * 1e6)
        np.testing.assert_allclose(out[1, 2], 2 * 3 * 1e6)


class TestPitzerActivity:
    """Validate against CRC/Robinson-Stokes mean activity coefficients."""

    def test_nacl_hcl_water_activity(self):
        from mistra_tpu.chemistry.activity import pitzer
        tk = jnp.full((4,), 298.15)
        mc = jnp.array([[0.0, 0.0, 0.0, 1.0],
                        [0.0, 0.0, 0.0, 0.0],
                        [0.1, 1.0, 6.0, 0.0]])
        ma = jnp.array([[0.0] * 4, [0.0] * 4, [0.0] * 4,
                        [0.1, 1.0, 6.0, 1.0]])
        gc, ga, aw = pitzer(tk, mc, ma)
        gpm = np.sqrt(np.asarray(gc[2]) * np.asarray(ga[3]))
        np.testing.assert_allclose(gpm[0], 0.778, rtol=0.01)   # NaCl 0.1m
        np.testing.assert_allclose(gpm[1], 0.657, rtol=0.01)   # NaCl 1m
        np.testing.assert_allclose(gpm[2], 0.986, rtol=0.01)   # NaCl 6m
        ghcl = math.sqrt(float(gc[0, 3]) * float(ga[3, 3]))
        np.testing.assert_allclose(ghcl, 0.809, rtol=0.01)     # HCl 1m
        np.testing.assert_allclose(float(aw[1]), 0.967, rtol=0.002)
        np.testing.assert_allclose(float(aw[2]), 0.760, rtol=0.005)

    def test_xgamma_field_masks(self):
        from mistra_tpu.chemistry.activity import xgamma_field, NGAM
        n, nkc = 6, 2
        te = jnp.full((n,), 288.15)
        conc = jnp.zeros((4, n))
        n2i = {"Hpl1": 0, "Clml1": 1, "Hpl2": 2, "Clml2": 3}
        # bin 1 has liquid in level 1 only
        cm = jnp.zeros((nkc, n)).at[0, 1].set(1.0e-7)
        cw = cm
        conc = conc.at[0, :].set(1.0e-4)     # H+ 1 molal where cm=1e-7
        conc = conc.at[1, :].set(1.0e-4)
        xg, wact = xgamma_field(te, conc, cm, cw, n2i, nkc, 4, jnp.float64)
        assert xg.shape == (NGAM, nkc, n)
        # active cell gets gamma != 1; all masked cells stay exactly 1
        assert abs(float(xg[0, 0, 1]) - 1.0) > 0.05
        mask = np.ones((nkc, n), bool)
        mask[0, 1] = False
        assert np.all(np.asarray(xg)[:, mask] == 1.0)
        # gamma(Br-) aliases gamma(Cl-)
        np.testing.assert_allclose(np.asarray(xg[23]), np.asarray(xg[13]))
