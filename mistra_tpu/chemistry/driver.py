"""Chemistry driver: species registry, initial profiles, dry deposition,
emission, and the per-substep integration over all layers.

Parity map (gas-phase stage):
- species registry / index maps: ``mk_interface`` (utils.f90:20-166)
- initial concentration profiles: ``initc`` (kpp.f90:33-515)
- Henry-law table: ``henry_a`` (kpp.f90:1676-2151, gas-relevant subset)
- dry deposition velocities: ``gasdrydep`` (kpp.f90:5449-5899)
- surface exchange: ``sedc`` (str.f90:2417-2626)
- per-layer environment + mechanism dispatch: ``kpp_driver``
  (kpp.f90:4168-4481); the gas mechanism runs for all layers batched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.pytree import pytree_dataclass

from ..constants import AVOGADRO, GAS_CONST, M_AIR, PI
from .gas_kernel import GasKernel, load_species_csv
from .mech import load_gas_mechanism
from .rates import RateEnv
from . import rosenbrock

NPHRXN = 47

# Henry's-law constants: species -> (A, B) for A*exp(B*(1/T - 1/298.15))
# [mol/(L atm)], or a plain number for T-independent values
# (transcribed from henry_a, kpp.f90:1723-1921)
HENRY_TABLE = {
    "H2SO4": 1.0e16, "CH4": 1.3e-3, "C2H6": 2.0e-3, "ETHE": 4.9e-3,
    "HI": 0.0, "I2O2": 0.0, "INO2": 0.0, "INO3": 0.0, "C3H7I": 1.1e-1,
    "NO": (1.9e-3, 1480.0), "NO2": (6.4e-3, 2500.0),
    "HNO3": (2.5e6 / 15.0, 8694.0), "HNO4": (1.2e4, 6900.0),
    "NH3": (58.0, 4085.0), "SO2": (1.2, 3120.0), "O3": (1.2e-2, 2560.0),
    "ACO2": (3.7e3, 5700.0), "ACTA": (4.1e3, 6300.0),
    "HCHO": (7.0e3, 6425.0), "ALD2": (13.0, 5700.0),
    "H2O2": (1.0e5, 6338.0), "ROOH": (3.0e2, 5322.0),
    "HONO": (49.0, 4780.0), "PAN": (2.8, 6500.0),
    "HCl": (2.0 / 1.7, 9001.0), "NO3": (2.0, 2000.0),
    "DMS": (4.8e-1, 3100.0), "DMSO": (5.0e4, 6425.0), "DMSO2": 1.0e16,
    "CH3SO2H": 1.0e16, "CH3SO3H": 1.0e16, "HOCl": (6.7e2, 5862.0),
    "Cl2": (9.1e-2, 2500.0), "HBr": (1.3, 10239.0), "Br2": (7.6e-1, 4094.0),
    "BrCl": (9.4e-1, 5600.0), "HOBr": (93.0, 5862.0), "I2": (3.0, 4431.0),
    "HOI": (4.5e2, 5862.0), "ICl": (1.1e2, 5600.0), "IBr": (24.0, 5600.0),
    "CH3I": (1.4e-1, 4300.0), "CH2I2": (2.3, 5000.0),
    "CH2ClI": (8.9e-1, 4300.0), "OH": (30.0, 4300.0),
    "HO2": (3.9e3, 5900.0), "MO2": (6.0, 5600.0), "IO": (4.5e2, 5862.0),
    "CO2": (3.1e-2, 2423.0), "CO": (9.9e-4, 1300.0), "O2": (1.3e-3, 1500.0),
    "ClONO": 4.6e-2, "CH3OH": (1.6e2, 5600.0), "C2H5OH": (1.5e2, 6400.0),
    "H2": (7.8e-4, 500.0), "XOR": (1.5e2, 6400.0),
}

# species treated as infinitely soluble in gasdrydep (hs = -1 sentinel)
INFINITE_SOLUBILITY = ("N2O5", "ClNO3", "BrNO3", "HI", "INO3")

# f0 reactivity values by MISTRA gas index (gasdrydep; default 0.1)
F0_BY_INDEX = {1: 0.0, 3: 0.0, 4: 0.0, 5: 0.0, 7: 1.0, 8: 0.0, 9: 0.0,
               10: 0.0, 11: 0.0, 14: 0.0, 15: 0.0, 16: 0.0, 17: 0.0,
               19: 1.0, 20: 1.0, 30: 0.0, 35: 0.0, 36: 1.0, 42: 0.0}

U0MIN_DEFAULT = 3.48e-2
U0MIN_BUYS = 1.75e-2


@pytree_dataclass
class GasChemState:
    sgas: jnp.ndarray       # [nvar, n] concentrations [mol/m3]
    vg: jnp.ndarray         # [nvar] dry deposition velocity [m/s]
    photol_j: jnp.ndarray   # [nphrxn, n] photolysis rates [1/s]
    # cumulative count of (cell, substep) stiff-solver non-convergences
    # (cells frozen at max_steps; reference warns per cell, gas.f:764-767)
    nonconv: jnp.ndarray = 0


def henry_molar(name, t):
    """Henry constant [mol/(L atm)] at temperature t (vectorized)."""
    val = HENRY_TABLE.get(name)
    if val is None:
        return jnp.zeros_like(t)
    if isinstance(val, tuple):
        a0, b0 = val
        return a0 * jnp.exp(b0 * (1.0 / t - 3.3557e-3))
    return jnp.full_like(t, val)


class ChemistryDriver:
    def __init__(self, model):
        cfg = model.cfg
        self.model = model
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.mech = load_gas_mechanism(cfg.mechdir, iod=cfg.iod,
                                       halo=cfg.halo)
        self.kernel = GasKernel(self.mech, dtype=self.dtype)
        self.csv = load_species_csv(f"{cfg.mechdir.rstrip('/')}/"
                                    f"{cfg.cgaslistfile}")
        self.name2i = {s: i for i, s in enumerate(self.mech.species)}
        # static chemistry-bin membership of the 2-D spectrum, for the
        # het-on-dry-aerosol rates (dry_cw_rc, kpp.f90:4580-4642)
        from . import aqueous as aq
        self.masks = aq.bin_masks(model.grids.micro)
        # MISTRA index -> mechanism index maps for the CSV species
        self.csv_in_mech = [s for s in self.csv if s["name"] in self.name2i]
        self.u0min = U0MIN_BUYS if cfg.lp_buys13_0d else U0MIN_DEFAULT

        # molar masses [kg/mol] for vmean (CSV + common radical defaults)
        self.mass = {s["name"]: s["mass"] for s in self.csv}

        # eulerian advection source (neula=0; euler_in.dat,
        # kpp.f90:290-306, applied :4441-4448)
        self.advect = []
        if cfg.neula == 0:
            byidx = {s["index"]: s["name"] for s in self.csv}
            with open(f"{cfg.mechdir.rstrip('/')}/euler_in.dat") as f:
                lines = [l for l in f if l.strip()
                         and not l.lstrip().startswith("!")]
            nadv = int(lines[0].split()[0])
            for line in lines[1:1 + nadv]:
                toks = line.split()
                gidx = int(toks[0])
                if gidx == 0 or byidx.get(gidx) not in self.name2i:
                    continue
                xadv = float(toks[1].lower().replace("d", "e"))
                self.advect.append((byidx[gidx], xadv))

    # ------------------------------------------------------------------
    def eulerian_advection(self, chem, kinv, am3, dt):
        """Large-scale advective source below the inversion
        (kpp_driver, kpp.f90:4441-4448): xadv in mol/mol/day."""
        if not self.advect:
            return chem
        conc = chem.conc if hasattr(chem, "conc") else chem.sgas
        n2i = getattr(self, "tot_n2i", self.name2i)
        lev = jnp.arange(conc.shape[1])
        below = (lev >= 1) & (lev <= kinv)
        for name, xadv in self.advect:
            add = jnp.where(below, xadv * dt * am3 / 86400.0, 0.0)
            conc = conc.at[n2i[name]].add(add.astype(conc.dtype))
        return chem.replace(conc=conc) if hasattr(chem, "conc") \
            else chem.replace(sgas=conc)

    # ------------------------------------------------------------------
    def init_chem_state(self, state) -> GasChemState:
        """Initial exponential concentration profiles (initc)."""
        cfg = self.model.cfg
        gp = cfg.grid
        n = gp.n
        eta = self.model.grids.atm.eta
        rho = np.asarray(state.met.rho, np.float64)
        am3 = rho / M_AIR
        xm = am3 * 1.0e-9                 # ppb -> mol/m3
        kinv = int(state.tim.kinv)

        x4 = np.minimum(1.0, eta / 1900.0)
        sgas = np.zeros((self.mech.nvar, n))
        halogens = {"HCl", "HBr", "HI", "Cl2", "Br2", "I2", "CH3I", "CH2I2",
                    "CH2ClI", "C3H7I", "CH2BrI", "C2H5I", "DMS"}
        for s in self.csv_in_mech:
            i = self.name2i[s["name"]]
            grd, top = s["ground_ppb"], s["top_ppb"]
            if grd > 0.0:
                x2 = -np.log(grd) + np.log(top + 1.0e-10)
            else:
                x2 = 0.0
            prof = grd * np.exp(x4 * x2) * xm
            is_halo = s["name"] in halogens and s["name"] != "HCl"
            if is_halo:
                # halogens: well-mixed below the inversion, zero above
                prof[:kinv] = prof[np.minimum(np.arange(n), 2)][:kinv]
                prof[kinv:] = 0.0
            sgas[i] = prof
        sgas[:, 0] = 0.0

        # store air density conversions (constant during run, as initc does)
        self.am3 = jnp.asarray(am3, self.dtype)
        self.cm3 = jnp.asarray(rho * AVOGADRO / M_AIR * 1e-6, self.dtype)

        return GasChemState(
            sgas=jnp.asarray(sgas, self.dtype),
            vg=jnp.zeros((self.mech.nvar,), self.dtype),
            photol_j=jnp.zeros((NPHRXN, n), self.dtype),
            nonconv=jnp.zeros((), jnp.int32))

    # ------------------------------------------------------------------
    def gasdrydep(self, state) -> jnp.ndarray:
        """Wesely-type dry deposition velocities vg [nvar] (m/s)."""
        met = state.met
        t2 = met.t[1]
        rho2 = met.rho[1]
        xra = state.micro.xra
        ustern = state.surf.ustern
        dtype = self.dtype

        xeta = 1.8325e-5 * (416.16 / (t2 + 120.0)) * (t2 / 296.16) ** 1.5
        xnu = xeta / rho2
        freep = 2.28e-5 * t2 / met.p[1]   # mean free path proxy (see partdep)
        rb_fact = 5.0 / ustern * (xnu * freep / 3.0) ** (2.0 / 3.0)
        fct = 0.0820577 * t2
        sac = 10.0 ** (-8.1)

        def funa(a0, b0):
            return a0 * jnp.exp(b0 * (1.0 / t2 - 3.354e-3))

        vg = np.zeros(self.mech.nvar, dtype=object)
        vg_arr = jnp.zeros((self.mech.nvar,), dtype)
        for s in self.csv_in_mech:
            name = s["name"]
            i = self.name2i[name]
            mi = s["index"]
            vm = jnp.sqrt(8.0 * GAS_CONST * t2 / (PI * s["mass"]))
            if name in INFINITE_SOLUBILITY:
                v = 1.0 / (xra + rb_fact / vm ** (2.0 / 3.0) + 0.1)
                vg_arr = vg_arr.at[i].set(v)
                continue
            h = henry_molar(name, t2)
            # effective-solubility corrections for acids/bases
            if name == "HNO3":
                h = h * (1.0 + funa(1.54e1, 8700.0) / sac)
            elif name == "NH3":
                h = h * (1.0 + funa(1.7e-5, -4325.0) * sac
                         / funa(1.0e-14, -6710.0))
            elif name == "SO2":
                h = h * (1.0 + funa(1.7e-2, 2090.0) / sac
                         + funa(1.7e-2, 2090.0) * funa(6.0e-8, 1120.0)
                         / sac ** 2)
            elif name == "H2SO4":
                h = h * (1.0 + 1.0e3 / sac
                         + 1.0e3 * funa(1.02e-2, 2720.0) / sac ** 2)
            elif name == "HCl":
                h = h * (1.0 + funa(1.7e6, 6896.0) / sac)
            elif name == "HOCl":
                h = h * (1.0 + 3.2e-8 / sac)
            elif name == "HBr":
                h = h * (1.0 + 1.0e9 / sac)
            elif name == "HOBr":
                h = h * (1.0 + funa(2.3e-9, -3091.0) / sac)
            f0 = F0_BY_INDEX.get(mi, 0.1)
            hs_inv = 1.0 / (h * fct)   # dimensionless inverse Henry
            surf_term = hs_inv * 1.0e-5 + f0 / 2000.0
            v_sol = 1.0 / (xra + rb_fact / vm ** (2.0 / 3.0)
                           + 1.0 / jnp.maximum(surf_term, 1e-300))
            if f0 > 0.0:
                v_insol = 1.0 / (xra + rb_fact / vm ** (2.0 / 3.0)
                                 + 2000.0 / f0)
            else:
                v_insol = jnp.zeros_like(v_sol)
            v = jnp.where(h > 0.0, v_sol, v_insol)
            vg_arr = vg_arr.at[i].set(v)

        # special fixed values (sedc preamble, str.f90:2459-2500)
        def set_by_name(arr, name, val):
            if name in self.name2i:
                arr = arr.at[self.name2i[name]].set(val)
            return arr

        def copy_by_name(arr, dst, src):
            if dst in self.name2i and src in self.name2i:
                arr = arr.at[self.name2i[dst]].set(arr[self.name2i[src]])
            return arr

        vg_arr = set_by_name(vg_arr, "NH3", 0.27e-2)
        vg_arr = copy_by_name(vg_arr, "N2O5", "HCl")
        vg_arr = set_by_name(vg_arr, "DMS", 0.0)
        vg_arr = copy_by_name(vg_arr, "HOCl", "HCl")
        vg_arr = copy_by_name(vg_arr, "HOBr", "HCl")
        vg_arr = copy_by_name(vg_arr, "I2O2", "HOI")
        vg_arr = copy_by_name(vg_arr, "INO2", "HOI")
        for nm in ("CH3I", "CH2I2", "CH2ClI", "C3H7I", "CH2BrI",
                   "CHBr2I", "C2H5I"):
            vg_arr = set_by_name(vg_arr, nm, 0.0)
        vg_arr = copy_by_name(vg_arr, "CH3SO3H", "HCl")
        return vg_arr

    # ------------------------------------------------------------------
    def sedc(self, chem: GasChemState, dt, deta1, detw1) -> GasChemState:
        """Surface dry deposition + ground emission (str.f90:2520-2535)."""
        sgas = chem.sgas
        vg = chem.vg
        dep_fac = jnp.where(vg >= 1.0e-5,
                            jnp.exp(-dt / deta1 * vg), 1.0)
        s_old = sgas[:, 1]
        s_new = s_old * dep_fac
        sgas = sgas.at[:, 1].set(s_new)
        sgas = sgas.at[:, 0].add((s_old - s_new) * deta1)
        # emissions [molec/cm2/s] -> mol/m3 per step
        es = np.zeros(self.mech.nvar)
        for s in self.csv_in_mech:
            es[self.name2i[s["name"]]] = s["emission"]
        es1 = jnp.asarray(es, self.dtype)
        sgas = sgas.at[:, 1].add(es1 * dt * 1.0e4 / (detw1 * AVOGADRO))
        return chem.replace(sgas=sgas)

    # ------------------------------------------------------------------
    def _het_extras(self, state, lev, y0):
        """Heterogeneous-on-dry-aerosol rate namespace for the gas
        mechanism (dry_rates_g + fdhetg, kpp.f90:5042-5203, 8198-8265).

        In gas-only layers no aqueous bin is active, so xhet1 = xhet2 = 1
        (kpp_driver, kpp.f90:4435-4438).
        """
        from . import aqueous as aq
        met = state.met
        t, p = met.t, met.p
        freep = 2.28e-5 * t / p
        dry = aq.dry_aerosol_rates(None, state.micro.ff, t, p, self.masks,
                                   self.model.grids.micro, freep,
                                   self.model.cfg.grid.nf, self.dtype)
        xkmtd = {k: v[:, lev] for k, v in dry["xkmtd"].items()}   # [2, B]
        cwd = dry["cwd"][:, lev]
        hdry_hno3 = dry["henry_dry"]["HNO3"][lev]
        xeq_hno3 = dry["xeq_hno3"][lev]
        n2i = self.name2i

        def fdhetg(na, nb):
            names = {1: "HNO3", 2: "N2O5", 3: "NH3", 4: "H2SO4"}
            if nb == 1 and y0 is not None and f"HNO3l{na}" in n2i:
                # HNO3 uptake limited by Henry equilibrium at pH 2
                x1 = xkmtd["HNO3"][na - 1] * cwd[na - 1]
                caq = (y0[:, n2i[f"HNO3l{na}"]] * 1.5e3) * 1.0e-2 \
                    / (xeq_hno3 + 1.0e-2)
                hno3 = y0[:, n2i["HNO3"]]
                x2 = jnp.where((hno3 > 0.0) & (hdry_hno3 > 0.0),
                               -xkmtd["HNO3"][na - 1]
                               / jnp.maximum(hno3 * hdry_hno3, 1e-300)
                               * caq, 0.0)
                return jnp.maximum(0.0, x1 + x2)
            return xkmtd[names[nb]][na - 1] * cwd[na - 1]

        return {"fdhetg": fdhetg, "xhet1": 1.0, "xhet2": 1.0}

    def _gas_env(self, state, lev, y0=None):
        """Per-layer rate environment + fixed-species columns for ``lev``
        (kpp_driver per-layer scalars, kpp.f90:4315-4438)."""
        cfg = self.model.cfg
        met = state.met
        chem = state.chem
        te = met.t[lev]
        air_cc = self.cm3[lev]
        air = self.am3[lev]
        h2o = met.xm1[lev] * met.rho[lev] / 1.8e-2        # mol/m3
        h2o_cc = met.xm1[lev] * (6.022e20 / 18.0) * met.rho[lev]
        h2oppm = h2o_cc * 1.0e6 / air_cc
        pk = met.p[lev]
        # layer-mean photolysis rates, zeroed when the sun is low
        u0 = state.rad.u0
        phj = 0.5 * (chem.photol_j[:, lev - 1] + chem.photol_j[:, lev])
        phj = jnp.where(u0 >= self.u0min, phj, 0.0).T     # [B, nphrxn]
        extras = None
        if type(self) is ChemistryDriver and any(
                n.endswith(("l1", "l2")) for n in self.mech.species):
            extras = self._het_extras(state, lev, y0)
        env = RateEnv(te=te, aircc=air_cc, h2oppm=h2oppm, pk=pk,
                      ph_rat=phj,
                      xhal=1.0 if cfg.halo else 0.0,
                      xiod=1.0 if (cfg.halo and cfg.iod) else 0.0,
                      extras=extras)
        fix = jnp.stack([0.21 * air, 0.79 * air, h2o], axis=-1)
        fix = fix[:, [["O2", "N2", "H2O"].index(s) for s in self.mech.fixed]]
        return env, fix

    def reaction_rates_at(self, state, levels):
        """Instantaneous per-reaction rates [mol/(m3 s)] at ``levels``
        (budget diagnostics C33; bud_gas, bud_g.f:18-403)."""
        lev = np.asarray(levels)
        y = jnp.maximum(state.chem.sgas, 0.0)[:, lev].T
        env, fix = self._gas_env(state, lev, y0=y)
        k = self.kernel.rate_constants(env, fix=fix)
        return self.kernel.reaction_rates(y, k, fix)

    def integrate_column(self, state, dt) -> GasChemState:
        """One chemistry substep over all interior layers (kpp_driver)."""
        cfg = self.model.cfg
        gp = cfg.grid
        n = gp.n
        met = state.met
        chem = state.chem
        dtype = self.dtype

        sgas = jnp.maximum(chem.sgas, 0.0)

        # active layers: 1 .. n-2 (reference k = 2 .. n-1)
        lev = np.arange(1, n - 1)
        y0 = sgas[:, lev].T                               # [B, nvar]
        env, fix = self._gas_env(state, lev, y0=y0)

        k = self.kernel.rate_constants(env, fix=fix)
        y, info = self.kernel.integrate(y0, k, fix, dt)
        y = jnp.maximum(y, 0.0)
        sgas = sgas.at[:, lev].set(y.T)
        return chem.replace(sgas=sgas,
                            nonconv=chem.nonconv + info["n_failed"])
