"""Multiphase chemistry driver: the tot/aer mechanism with the aqueous
support stack (reference ``stem_kpp`` -> ``liq_parm`` -> ``kpp_driver``
chain, str.f90:5797-6136 / kpp.f90:516-657, 4168-4481).

Mechanism routing: the reference selects gas/aer/tot per layer
(kpp.f90:4451-4468).  Here the tot mechanism runs for all layers below the
chemistry top (nf) with per-layer xliq/xhet switches masking inactive
aqueous bins — the mechanism's own masking design — and the pure-gas
kernel covers the layers above, where no liquid can exist.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.pytree import pytree_dataclass

from ..constants import AVOGADRO, GAS_CONST, M_AIR, PI
from . import aqueous as aq
from .driver import (ChemistryDriver, GasChemState, NPHRXN, U0MIN_BUYS,
                     U0MIN_DEFAULT, henry_molar)
from .gas_kernel import GasKernel
from .mech import load_multiphase_mechanism
from .rates import RateEnv


@pytree_dataclass
class MultiphaseChemState:
    conc: jnp.ndarray       # [nvar_tot, n] all species [mol/m3]
    vg: jnp.ndarray         # [nvar_tot] dry deposition velocities
    photol_j: jnp.ndarray   # [nphrxn, n]
    cloud: jnp.ndarray      # [nkc, n] deliquescence hysteresis flags
    # cumulative count of (cell, substep) stiff-solver non-convergences
    # (cells frozen at max_steps; reference warns per cell, gas.f:764-767)
    nonconv: jnp.ndarray = 0

    @property
    def sgas(self):
        # compatibility alias used by difc wiring and diagnostics
        return self.conc


class MultiphaseDriver(ChemistryDriver):
    """Extends the gas driver with the aer/tot multiphase machinery."""

    def __init__(self, model):
        super().__init__(model)
        cfg = model.cfg
        nkc = min(cfg.nkc_l, 4)
        bins = tuple(range(1, nkc + 1))
        self.tot = load_multiphase_mechanism(cfg.mechdir, bins=bins,
                                             name="tot")
        # stiff-solver dtype: f64 unless explicitly disabled (see
        # MistraConfig.chem_f64); requires jax_enable_x64
        self.tot_dtype = jnp.float64 if getattr(cfg, "chem_f64", True)             else self.dtype
        if self.tot_dtype == jnp.float64 and not jax.config.jax_enable_x64:
            import warnings
            warnings.warn(
                "chem_f64 requested without jax_enable_x64; multiphase "
                "stiff solves fall back to float32 (expect frozen cells "
                "in strongly aqueous layers)")
            self.tot_dtype = self.dtype
        self.tot_kernel = GasKernel(self.tot, dtype=self.tot_dtype)
        self.tot_n2i = {s: i for i, s in enumerate(self.tot.species)}
        # gas-mechanism species embedded in tot (same names)
        self.gas_in_tot = np.array(
            [self.tot_n2i[s] for s in self.mech.species], dtype=np.int32)
        self.masks = aq.bin_masks(model.grids.micro)
        self.nkc = nkc
        # exchange species present in tot
        self.exch = [s for s in aq.EXCHANGE_SPECIES if s in self.tot_n2i]
        self.exch_idx = {s: i for i, s in enumerate(self.exch)}
        self.masses = dict(self.mass)
        self._init_konc()
        from .sources import ion_loading_table
        self.sa1_table = ion_loading_table(
            cfg, model.grids, model.consts["fcs"], model.consts["xmol3"])

    # ------------------------------------------------------------------
    def init_chem_state(self, state) -> MultiphaseChemState:
        gas = super().init_chem_state(state)
        n = self.model.cfg.grid.n
        conc = jnp.zeros((self.tot.nvar, n), self.dtype)
        conc = conc.at[jnp.asarray(self.gas_in_tot)].set(gas.sgas)
        # initial aerosol ion loading (init_konc, kpp.f90:3591-3715)
        from .sources import apply_initial_ions
        conc = apply_initial_ions(conc, self.sa1_table, state.micro.ff,
                                  self.tot_n2i, self.model.grids.micro.ka,
                                  self.nkc, self.dtype)
        vg = jnp.zeros((self.tot.nvar,), self.dtype)
        vg = vg.at[jnp.asarray(self.gas_in_tot)].set(gas.vg)
        cloud = jnp.ones((4, n), bool)
        return MultiphaseChemState(conc=conc, vg=vg,
                                   photol_j=gas.photol_j, cloud=cloud,
                                   nonconv=jnp.zeros((), jnp.int32))

    # ------------------------------------------------------------------
    def gasdrydep(self, state):
        vg_gas = super().gasdrydep(state)
        vg = jnp.zeros((self.tot.nvar,), self.dtype)
        return vg.at[jnp.asarray(self.gas_in_tot)].set(vg_gas)

    def sedc(self, chem, dt, deta1, detw1):
        sgas = chem.conc
        vg = chem.vg
        dep_fac = jnp.where(vg >= 1.0e-5, jnp.exp(-dt / deta1 * vg), 1.0)
        s_old = sgas[:, 1]
        s_new = s_old * dep_fac
        sgas = sgas.at[:, 1].set(s_new)
        sgas = sgas.at[:, 0].add((s_old - s_new) * deta1)
        es = np.zeros(self.tot.nvar)
        for s in self.csv_in_mech:
            es[self.tot_n2i[s["name"]]] = s["emission"]
        es1 = jnp.asarray(es, self.dtype)
        sgas = sgas.at[:, 1].add(es1 * dt * 1.0e4 / (detw1 * AVOGADRO))
        return chem.replace(conc=sgas)

    # ------------------------------------------------------------------
    def liq_parm(self, state):
        """The aqueous support stack; returns a dict of arrays [.., n]."""
        cfg = self.model.cfg
        gp = cfg.grid
        met = state.met
        dtype = self.dtype
        t, p = met.t, met.p
        freep = 2.28e-5 * t / p

        cw, cm, rc, conv2, cloud = aq.cw_rc(
            state.micro.ff, met.feu, state.chem.cloud,
            self.model.grids.micro, self.masks, dtype)
        # aqueous activity only below the chemistry top nf
        lev_ok = (jnp.arange(gp.n) < gp.nf)[None, :]
        cm = jnp.where(lev_ok, cm, 0.0)
        conv2 = jnp.where(lev_ok, conv2, 0.0)

        alpha = aq.sticking_coefficients(self.exch, t,
                                         cfg.lp_buxmann15alph, dtype)
        vmean = aq.mean_speeds(self.exch, self.masses, t, dtype)
        hinv = aq.inverse_henry(self.exch, t)
        xkmt, vt = aq.fast_k_mt(state.micro.ff, t, p, alpha, vmean, cw, cm,
                                self.masks, self.model.grids.micro, freep,
                                dtype)
        # Pitzer ion activity coefficients (SR activ, kpp.f90:5204-5404)
        from .activity import xgamma_field
        xgamma, wact = xgamma_field(t, jnp.maximum(state.chem.conc, 0.0),
                                    cm, cw, self.tot_n2i, self.nkc,
                                    gp.nf, dtype)
        kef, keb = aq.equil_constants(t, conv2, xgamma, dtype)
        dry = aq.dry_aerosol_rates(self.exch, state.micro.ff, t, p,
                                   self.masks, self.model.grids.micro,
                                   freep, gp.nf, dtype)
        return {"cw": cw, "cm": cm, "rc": rc, "conv2": conv2,
                "cloud": cloud, "xkmt": xkmt, "vt": vt, "kef": kef,
                "keb": keb, "dry": dry}

    # ------------------------------------------------------------------
    def _extras(self, lp, lev, y0_cols):
        """Rate-evaluation namespace extras for the batched layers ``lev``.

        y0_cols: [B, nvar] initial concentrations (frozen during the step,
        matching Update_RCONST semantics).
        """
        nkc = self.nkc
        conv2 = lp["conv2"][:, lev]            # [nkc, B]
        cm = lp["cm"][:, lev]
        cw = lp["cw"][:, lev]
        xkmt = lp["xkmt"][:, :, lev]           # [nexch, nkc, B]
        kef = {k: v[:, lev] for k, v in lp["kef"].items()}
        keb = {k: v[:, lev] for k, v in lp["keb"].items()}
        dry = lp["dry"]
        xkmtd = {k: v[:, lev] for k, v in dry["xkmtd"].items()}   # [2, B]
        hdry = {k: v[lev] for k, v in dry["henry_dry"].items()}
        cwd = dry["cwd"][:, lev]               # [2, B]

        ns = {}
        xliq = []
        for b in range(1, 5):
            active = (cm[b - 1] > 0.0).astype(conv2.dtype) \
                if b <= nkc else jnp.zeros_like(conv2[0])
            xliq.append(active)
            ns[f"xliq{b}"] = active
            ns[f"cvv{b}"] = conv2[b - 1] if b <= nkc else \
                jnp.zeros_like(conv2[0])
        ns["xhet1"] = 1.0 - xliq[0]
        ns["xhet2"] = 1.0 - xliq[1]

        n2i = self.tot_n2i
        for name, i in n2i.items():
            ns[f"ind_{name.lower()}"] = i
        for fi, name in enumerate(self.tot.fixed):
            ext = self.tot.nvar + 1 + fi
            ns[f"indf_{name.lower()}"] = ext
            # fixed species also carry an ind_ alias (KPP keeps FIX species
            # inside the NSPEC index space)
            ns.setdefault(f"ind_{name.lower()}", ext)

        def conc_of(i):
            return y0_cols[:, i]

        ns["c"] = conc_of

        def _key_name(ind_key):
            if ind_key < self.tot.nvar:
                return self.tot.species[ind_key]
            return self.tot.fixed[ind_key - self.tot.nvar - 1]

        def ykef(ind_key, b):
            return kef[_eq_key(_key_name(ind_key))][b - 1]

        def ykeb(ind_key, b):
            return keb[_eq_key(_key_name(ind_key))][b - 1]

        def yxkmt(ind, b):
            name = _key_name(ind)
            li = self.exch_idx.get(name)
            if li is None:
                return jnp.zeros_like(conv2[0])
            return xkmt[li, b - 1]

        def ycw(b):
            return cw[b - 1]

        hinv_cache = {}

        def yhenry(ind):
            name = _key_name(ind)
            if name not in hinv_cache:
                t_lev = self._t_lev
                fct = 0.0820577 * t_lev
                h = henry_molar(name, t_lev)
                hinv_cache[name] = jnp.where(
                    h > 0.0, 1.0 / (jnp.maximum(h, 1e-300) * fct), 0.0)
            return hinv_cache[name]

        ns["ykef"] = ykef
        ns["ykeb"] = ykeb
        ns["yxkmt"] = yxkmt
        ns["ycw"] = ycw
        ns["yhenry"] = yhenry

        # het functions on dry aerosol (fdhetg/a/t, kpp.f90:8198-8349)
        def fdhet(na, nb):
            names = {1: "HNO3", 2: "N2O5", 3: "NH3", 4: "H2SO4"}
            if nb == 1:
                x1 = xkmtd["HNO3"][na - 1] * cwd[na - 1]
                caq = (y0_cols[:, n2i[f"HNO3l{na}"]]
                       + y0_cols[:, n2i.get(f"NO3ml{na}", n2i[f"HNO3l{na}"])]) \
                    * 1.0e-2 / (dry["xeq_hno3"][lev] + 1.0e-2)
                hno3 = y0_cols[:, n2i["HNO3"]]
                hh = hdry["HNO3"]
                x2 = jnp.where((hno3 > 0.0) & (hh > 0.0),
                               -xkmtd["HNO3"][na - 1]
                               / jnp.maximum(hno3 * hh, 1e-300) * caq, 0.0)
                return jnp.maximum(0.0, x1 + x2)
            return xkmtd[names[nb]][na - 1] * cwd[na - 1]

        ns["fdhetg"] = fdhet
        ns["fdheta"] = fdhet
        ns["fdhett"] = fdhet

        def fhet_da(xliq_b, xhet_b, a0, b0, c0):
            cn = {1: "N2O5", 2: "ClNO3", 3: "BrNO3"}[c0]
            li = self.exch_idx.get(cn)
            xtr_l = xkmt[li, a0 - 1] if li is not None else 0.0
            # FIX(indf_H2Ol{a0}) = 55.55 / cvv (aer.f drive)
            h2oa_l = jnp.where(conv2[a0 - 1] > 0.0,
                               55.55 / jnp.maximum(conv2[a0 - 1], 1e-300),
                               0.0)
            h2oa_d = 55.55 * cwd[a0 - 1] * 1.0e3
            clm = y0_cols[:, n2i[f"Clml{a0}"]]
            brm = y0_cols[:, n2i[f"Brml{a0}"]]
            xhal = 1.0 if self.model.cfg.halo else 0.0
            hetT_l = h2oa_l + xhal * (5.0e2 * clm + 3.0e5 * brm) \
                + (1 - xhal) * 0.0
            hetT_d = h2oa_d + xhal * (5.0e2 * clm + 3.0e5 * brm)
            xbr_l = {1: h2oa_l, 2: 5.0e2, 3: 3.0e5}[b0]
            xbr_d = {1: h2oa_d, 2: 5.0e2, 3: 3.0e5}[b0]
            # liquid branch (xhet = 0)
            out_l = jnp.where(hetT_l > 0.0,
                              xtr_l * cw[a0 - 1] * xbr_l
                              / jnp.maximum(hetT_l, 1e-300), 0.0)
            # dry branch (xhet = 1): only HNO3-family xkmtd tabulated; for
            # ClNO3/BrNO3 on dry aerosol reuse the N2O5 transfer rate
            xtr_dd = xkmtd["N2O5"][a0 - 1]
            out_d = jnp.where(hetT_d > 0.0,
                              xtr_dd * cwd[a0 - 1] * xbr_d
                              / jnp.maximum(hetT_d, 1e-300), 0.0)
            out = xliq_b * out_l + xhet_b * out_d
            if (c0 in (2, 3) or b0 in (2, 3)) and not self.model.cfg.halo:
                return jnp.zeros_like(out_l)
            return out

        ns["fhet_da"] = fhet_da
        ns["fhet_dt"] = fhet_da

        def fhet_t(a0, b0, c0):
            return fhet_da(xliq[a0 - 1], 0.0, a0, b0, c0)

        ns["fhet_t"] = fhet_t
        return ns

    # ------------------------------------------------------------------
    def integrate_column(self, state, dt):
        """tot mechanism for layers 1..nf-1, gas mechanism above."""
        cfg = self.model.cfg
        gp = cfg.grid
        n, nf = gp.n, gp.nf
        met = state.met
        chem = state.chem

        conc = jnp.maximum(chem.conc, 0.0)
        lp = self.liq_parm(state)
        conc, nfail = self._integrate_tot(state, conc, lp,
                                          np.arange(1, nf), dt)
        conc = self._integrate_gas_above(state, conc, np.arange(nf, n - 1),
                                         dt)
        return chem.replace(conc=conc, cloud=lp["cloud"],
                            nonconv=chem.nonconv + nfail)

    def integrate_box(self, state, dt, n_bl=1):
        """Box/chamber mode: tot mechanism at the single level n_bl
        (reference kpp_driver box branch, kpp.f90:4440-4470)."""
        chem = state.chem
        conc = jnp.maximum(chem.conc, 0.0)
        lp = self.liq_parm(state)
        conc, nfail = self._integrate_tot(state, conc, lp,
                                          np.array([n_bl]), dt)
        return chem.replace(conc=conc, cloud=lp["cloud"],
                            nonconv=chem.nonconv + nfail)

    def reaction_rates_at(self, state, levels):
        """Instantaneous per-reaction tot-mechanism rates [mol/(m3 s)] at
        ``levels`` (budget diagnostics C33; bud_t.f / bud_s_t.f)."""
        lev = np.asarray(levels)
        conc = jnp.maximum(state.chem.conc, 0.0)
        lp = self.liq_parm(state)
        y0 = conc[:, lev].T
        k, fix = self._tot_env(state, lp, lev, y0)
        return self.tot_kernel.reaction_rates(y0, k, fix)

    def _tot_env(self, state, lp, lev, y0):
        """Rate constants + fixed-species columns for the tot mechanism at
        layers ``lev`` (kpp_driver per-layer scalars, kpp.f90:4315-4438)."""
        cfg = self.model.cfg
        met = state.met
        chem = state.chem
        te = met.t[lev]
        self._t_lev = te
        air_cc = self.cm3[lev]
        air = self.am3[lev]
        h2o = met.xm1[lev] * met.rho[lev] / 1.8e-2
        h2o_cc = met.xm1[lev] * (6.022e20 / 18.0) * met.rho[lev]
        h2oppm = h2o_cc * 1.0e6 / air_cc
        pk = met.p[lev]
        u0 = state.rad.u0
        phj = 0.5 * (chem.photol_j[:, lev - 1] + chem.photol_j[:, lev])
        phj = jnp.where(u0 >= self.u0min, phj, 0.0).T

        env = RateEnv(te=te, aircc=air_cc, h2oppm=h2oppm, pk=pk,
                      ph_rat=phj,
                      xhal=1.0 if cfg.halo else 0.0,
                      xiod=1.0 if (cfg.halo and cfg.iod) else 0.0,
                      extras=self._extras(lp, lev, y0))

        # fixed species: O2/N2/H2O gas + aqueous water 55.55/cvv per bin
        conv2_lev = lp["conv2"][:, lev]
        fix_cols = {"O2": 0.21 * air, "N2": 0.79 * air, "H2O": h2o}
        for b in range(1, self.nkc + 1):
            cv = conv2_lev[b - 1]
            fix_cols[f"H2Ol{b}"] = jnp.where(cv > 0.0,
                                             55.55 / jnp.maximum(cv, 1e-300),
                                             0.0)
        fix = jnp.stack([fix_cols.get(s, jnp.zeros_like(air))
                         for s in self.tot.fixed], axis=-1)

        k = self.tot_kernel.rate_constants(env, fix=fix)
        return k, fix

    def _integrate_tot(self, state, conc, lp, lev, dt):
        y0 = conc[:, lev].T.astype(self.tot_dtype)   # [B, nvar_tot]
        k, fix = self._tot_env(state, lp, lev, y0)
        y, info = self.tot_kernel.integrate(
            y0, k.astype(self.tot_dtype), fix.astype(self.tot_dtype), dt)
        y = jnp.maximum(y, 0.0).astype(conc.dtype)
        return conc.at[:, lev].set(y.T), info["n_failed"]

    def _integrate_gas_above(self, state, conc, lev_g, dt):
        cfg = self.model.cfg
        met = state.met
        chem = state.chem
        u0 = state.rad.u0
        air_g = self.am3[lev_g]
        h2o_g = met.xm1[lev_g] * met.rho[lev_g] / 1.8e-2
        te_g = met.t[lev_g]
        phj_g = 0.5 * (chem.photol_j[:, lev_g - 1]
                       + chem.photol_j[:, lev_g])
        phj_g = jnp.where(u0 >= self.u0min, phj_g, 0.0).T
        env_g = RateEnv(
            te=te_g, aircc=self.cm3[lev_g],
            h2oppm=met.xm1[lev_g] * (6.022e20 / 18.0) * met.rho[lev_g]
            * 1.0e6 / self.cm3[lev_g],
            pk=met.p[lev_g], ph_rat=phj_g,
            xhal=1.0 if cfg.halo else 0.0,
            xiod=1.0 if (cfg.halo and cfg.iod) else 0.0)
        fix_g = jnp.stack([0.21 * air_g, 0.79 * air_g, h2o_g], axis=-1)
        fix_g = fix_g[:, [["O2", "N2", "H2O"].index(s)
                          for s in self.mech.fixed]]
        kg = self.kernel.rate_constants(env_g, fix=fix_g)
        gidx = jnp.asarray(self.gas_in_tot)
        y0g = conc[gidx][:, lev_g].T
        yg, _ = self.kernel.integrate(y0g, kg, fix_g, dt)
        yg = jnp.maximum(yg, 0.0)
        return conc.at[gidx[:, None], jnp.asarray(lev_g)[None, :]].set(yg.T)


def _eq_key(name: str) -> str:
    """Equilibrium-table key for a ykef/ykeb reference: bin-suffixed ion
    names keep their bin-1 table key (ind_HSO3ml1 etc.)."""
    import re
    if name in aq.EQUILIBRIA:
        return name
    base = re.sub(r"l[1-4]$", "l1", name)
    if base in aq.EQUILIBRIA:
        return base
    base2 = re.sub(r"l[1-4]$", "", name)
    if base2 in aq.EQUILIBRIA:
        return base2
    raise KeyError(f"no equilibrium table entry for {name}")


# --------------------------------------------------------------------------
# konc: aqueous-species redistribution after microphysical growth
# (reference kpp.f90:3370-3590)
# --------------------------------------------------------------------------

def _pair_indices(tot, n2i, b_src, b_dst):
    """Species index pairs (i_src, i_dst) matching bin b_src to b_dst."""
    import re
    pairs = []
    for name, i in n2i.items():
        m = re.search(rf"l{b_src}$", name)
        if m:
            other = re.sub(rf"l{b_src}$", f"l{b_dst}", name)
            if other in n2i:
                pairs.append((i, n2i[other]))
    return np.array(pairs, dtype=np.int32)


class KoncMixin:
    def _init_konc(self):
        self.pairs13 = _pair_indices(self.tot, self.tot_n2i, 1, 3) \
            if self.nkc >= 3 else np.zeros((0, 2), np.int32)
        self.pairs24 = _pair_indices(self.tot, self.tot_n2i, 2, 4) \
            if self.nkc >= 4 else np.zeros((0, 2), np.int32)

    def konc(self, chem, ff_before, ff_after):
        """Shift aqueous species between aerosol and droplet bins in
        proportion to the particles that crossed the kw threshold."""
        if self.pairs13.size == 0 and self.pairs24.size == 0:
            return chem
        mg = self.model.grids.micro
        dtype = self.dtype
        rq = jnp.asarray(mg.rq, dtype)
        vol = 4.0 / 3.0 * PI * rq ** 3
        kw = np.asarray(mg.kw)
        ka = mg.ka
        nkt, nka, n = ff_before.shape
        jt = np.arange(nkt)[:, None]
        aero_m = jnp.asarray((jt < kw[None, :]).astype(float), dtype)

        # per-(ia, level) particle counts and volumes, aerosol vs droplet
        def counts(ff):
            pa = jnp.einsum("tkn,tk->kn", ff, aero_m)
            pd = jnp.einsum("tkn,tk->kn", ff, 1.0 - aero_m)
            va = jnp.einsum("tkn,tk,tk->kn", ff, vol, aero_m)
            vd_ = jnp.einsum("tkn,tk,tk->kn", ff, vol, 1.0 - aero_m)
            return pa, pd, va, vd_

        pa_o, pd_o, va_o, vd_o = counts(ff_before)
        pa_n, pd_n, _, _ = counts(ff_after)

        conc = chem.conc

        def apply_group(conc, pairs, ia_range, vol2_a, vol2_d):
            if pairs.size == 0:
                return conc
            src = jnp.asarray(pairs[:, 0])
            dst = jnp.asarray(pairs[:, 1])
            A = conc[src]           # aerosol-bin species [np, n]
            D = conc[dst]           # droplet-bin species

            def body(carry, ia):
                A, D = carry
                dp_a = pa_o[ia] - pa_n[ia]          # [n]
                dp_d = pd_o[ia] - pd_n[ia]
                to_drop = dp_a >= 1.0e-10           # aerosol lost particles
                xs = (jnp.abs(dp_a) >= 1.0e-10).astype(A.dtype)
                delta_ad = jnp.where(
                    (vol2_a > 0.0) & (pa_o[ia] > 0.0),
                    va_o[ia] / jnp.maximum(vol2_a, 1e-300)
                    * dp_a / jnp.maximum(pa_o[ia], 1e-300) * xs, 0.0)
                delta_da = jnp.where(
                    (vol2_d > 0.0) & (pd_o[ia] > 0.0),
                    vd_o[ia] / jnp.maximum(vol2_d, 1e-300)
                    * dp_d / jnp.maximum(pd_o[ia], 1e-300) * xs, 0.0)
                delta = jnp.where(to_drop, delta_ad, delta_da)
                ok = (delta > 0.0) & (delta <= 1.0)
                delta = jnp.where(ok, delta, 0.0)
                # transfer direction
                dA = jnp.where(to_drop, A * delta, -D * delta)
                A = jnp.maximum(0.0, A - dA)
                D = jnp.maximum(0.0, D + dA)
                return (A, D), None

            (A, D), _ = jax.lax.scan(body, (A, D),
                                     jnp.asarray(ia_range))
            conc = conc.at[src].set(A)
            conc = conc.at[dst].set(D)
            return conc

        # vol2 per bin: total old liquid volume of the bin
        m = jnp.asarray(self.masks, self.dtype)
        vol2 = jnp.einsum("tkn,tk,tkc->cn", ff_before, vol, m)
        conc = apply_group(conc, self.pairs13, np.arange(0, ka),
                           vol2[0], vol2[2])
        conc = apply_group(conc, self.pairs24, np.arange(ka, nka),
                           vol2[1], vol2[3])
        return chem.replace(conc=conc)

    # ------------------------------------------------------------------
    def sedl(self, state, dt):
        """Wet deposition of aqueous species (str.f90:2627-2792)."""
        from ..physics.sedimentation import advsed1, vterm
        cfg = self.model.cfg
        gp = cfg.grid
        nf = gp.nf
        dtype = self.dtype
        met = state.met
        chem = state.chem
        grid = self.model.atm
        deta, detw = grid.deta, grid.detw

        lp_cw, lp_cm, rc, _, _ = aq.cw_rc(
            state.micro.ff, met.feu, chem.cloud, self.model.grids.micro,
            self.masks, dtype)
        # vt per bin
        _, vt = aq.fast_k_mt(
            state.micro.ff, met.t, met.p,
            jnp.ones((1, gp.n), dtype), jnp.ones((1, gp.n), dtype),
            lp_cw, lp_cm, self.masks, self.model.grids.micro,
            2.28e-5 * met.t / met.p, dtype)
        # vdm: LWC-weighted particle deposition velocity per bin (partdep)
        rq3 = jnp.asarray(self.model.grids.micro.rq, dtype) ** 3 * 1.0e-18
        m = jnp.asarray(self.masks, dtype)
        xx1 = jnp.einsum("tk,tk,tkc->c", state.micro.vd * rq3 * 1.0e6,
                         state.micro.ff[:, :, 1], m)
        cw2 = lp_cw[:, 1]
        vdm = jnp.where(cw2 > 0.0,
                        4.0 * PI / 3.0 / jnp.maximum(cw2, 1e-300) * xx1,
                        0.0)

        conc = chem.conc
        for kc in range(self.nkc):
            idx = np.nonzero(self.tot.species_bin == kc + 1)[0]
            if idx.size == 0:
                continue
            x4 = jnp.maximum(0.01, 1.0e6 * rc[kc]) * 1.0e-6   # [n] radius m
            cc = -vterm(x4, met.t, met.p) / deta
            cc = jnp.minimum(cc, -vt[kc] / deta)
            cc = cc.at[1].set(jnp.minimum(cc[1], -vdm[kc] / deta[1]))
            # time splitting bound from the bottom Courant number;
            # iterations beyond the needed split are masked no-ops
            # (active = dt0 > 0.1), so the bound only has to be safe:
            # vterm tops out near 9 m/s and deta >= 10 m, so 8 covers
            # dt = 10 s with a wide margin (reference adaptive loop,
            # str.f90:2627-2792)
            xxxt = -0.999 / cc[1]
            nsub = 8

            sk = conc[jnp.asarray(idx)][:, 1:nf] * detw[None, 1:nf]
            psi = jnp.concatenate([sk[:, :1], sk], axis=1)  # ghost level
            ground = jnp.zeros((idx.size,), dtype)
            dt0 = jnp.asarray(dt, dtype)

            def body(carry, _):
                psi, ground, dt0 = carry
                dtmax = jnp.minimum(dt0, xxxt)
                active = dt0 > 0.1
                c_arr = cc[None, :nf] * dtmax
                c_arr = c_arr.at[:, 0].set(c_arr[:, 1])
                c_arr = c_arr.at[:, nf - 1].set(0.0)
                psi_in = psi.at[:, 0].set(psi[:, 1])
                x1 = psi_in[:, 1]
                out = advsed1(jnp.broadcast_to(c_arr, psi.shape), psi_in)
                ground_new = ground + out[:, 0] - x1
                psi = jnp.where(active, out, psi)
                ground = jnp.where(active, ground_new, ground)
                dt0 = jnp.where(active, dt0 - dtmax, dt0)
                return (psi, ground, dt0), None

            (psi, ground, _), _ = jax.lax.scan(
                body, (psi, ground, dt0), None, length=nsub)
            new_vals = psi[:, 1:nf - 1] / detw[None, 1:nf - 1]
            conc = conc.at[jnp.asarray(idx)[:, None],
                           jnp.arange(1, nf - 1)[None, :]].set(new_vals)
            # level 0 is the surface reservoir in column-integral units
            # [mol/m2] (same convention as sedc/sedc_box); ``ground``
            # accumulates psi = conc*detw, already mol/m2
            conc = conc.at[jnp.asarray(idx), 0].add(ground)
        return chem.replace(conc=conc)


# attach the redistribution/deposition methods to the driver
MultiphaseDriver._init_konc = KoncMixin._init_konc
MultiphaseDriver.konc = KoncMixin.konc
MultiphaseDriver.sedl = KoncMixin.sedl


# --------------------------------------------------------------------------
# aerosol processing: particle redistribution along the dry-mass grid due to
# chemically produced/destroyed aerosol mass (stem_kpp, str.f90:5900-6134)
# --------------------------------------------------------------------------

# sion1 slots defining aerosol mass (lj2, str.f90:5884) with molar masses
# [g/mol]; HCO3- counts 44 (water stays when CO2 degasses); Na+ is inert
# here (no chemistry changes it between the two snapshots), so it drops out
# of the difference and is omitted.
MASS_IONS = (("Hp", 1.0), ("NH4p", 18.0), ("SO42m", 96.0),
             ("HCO3m", 44.0), ("NO3m", 62.0), ("Clm", 35.5),
             ("HSO4m", 97.0), ("CH3SO3m", 95.0))


class MassFeedbackMixin:
    def _mass_ion_idx(self, kc):
        out = []
        for nm, mm in MASS_IONS:
            sp = f"{nm}l{kc}"
            if sp in self.tot_n2i:
                out.append((self.tot_n2i[sp], mm))
        return out

    def aerosol_mass_feedback(self, state, conc_before):
        """Shift particles to new dry-mass bins after chemistry changed
        their soluble mass; carry dissolved species across chemistry-bin
        boundaries with the displaced volume (str.f90:5975-6134).

        Design note: the reference mutates ff in place with a
        direction-dependent loop order; here each dry bin maps
        independently to its bracketing target bins and the update is one
        gather/scatter matrix product per chemistry bin, which is
        mass-conserving by construction.
        """
        cfg = self.model.cfg
        gp = cfg.grid
        mg = self.model.grids.micro
        dtype = self.dtype
        chem = state.chem
        micro = state.micro
        nf = gp.nf
        n = gp.n

        en = jnp.asarray(mg.en, dtype)          # [nka] dry mass mg
        en_np = np.asarray(mg.en)
        rq = jnp.asarray(mg.rq, dtype)
        masks = jnp.asarray(self.masks, dtype)  # [nkt, nka, nkc=4]
        nkt, nka, _ = self.masks.shape
        fpi = 4.0 / 3.0 * PI

        lev = jnp.arange(n)
        lev_ok = (lev >= 1) & (lev < nf)

        cw, cm, _, _, _ = aq.cw_rc(micro.ff, state.met.feu, chem.cloud,
                                   mg, self.masks, dtype)

        ff = micro.ff
        conc = chem.conc
        vc = jnp.zeros((4, 4, n), dtype)        # [to, from, n] volume um3/cm3

        # chemistry-bin id of a (jt, target-ia) cell: 1..4
        binid = jnp.argmax(masks, axis=2) + 1   # [nkt, nka]

        for kc in range(1, self.nkc + 1):
            ion_idx = self._mass_ion_idx(kc)
            if not ion_idx:
                continue
            mkc = masks[:, :, kc - 1]           # [nkt, nka]
            # per-level totals over this bin
            sap = jnp.einsum("tk,tkn->n", mkc, ff)
            smp = jnp.einsum("tk,k,tkn->n", mkc, en, ff)
            dion = jnp.zeros((n,), dtype)
            for idx, mm in ion_idx:
                dion = dion + (conc[idx] - conc_before[idx]) * mm
            # den: new aerosol mass per particle [mg]
            den = jnp.where(sap > 1.0e-6,
                            dion * 1.0e-6 / jnp.maximum(sap, 1e-30)
                            * 1000.0, 0.0)
            active = (sap > 1.0e-6) & (cm[kc - 1] > 0.0) & lev_ok

            # target dry mass for every source bin: x0[ia, n]
            x0 = en[:, None] + den[None, :] * en[:, None] \
                / jnp.maximum(smp[None, :], 1e-30) * sap[None, :]
            ix = jnp.clip(jnp.searchsorted(jnp.asarray(en_np), x0,
                                           side="right") - 1, 0, nka - 2)
            enl = en[ix]
            enr = en[jnp.minimum(ix + 1, nka - 1)]
            c0 = (enr - x0) / jnp.maximum(enr - enl, 1e-300)
            c0 = jnp.clip(c0, 0.0, 1.0)
            c0 = jnp.where(x0 < en[0], 1.0, c0)
            c0 = jnp.where(x0 >= en[-1], 0.0, c0)
            # no move where inactive
            ix = jnp.where(active[None, :], ix, jnp.arange(nka)[:, None])
            c0 = jnp.where(active[None, :], c0, 1.0)

            # scatter matrix W[ia, dest, n]
            oh_l = jax.nn.one_hot(ix, nka, dtype=dtype, axis=1)
            oh_r = jax.nn.one_hot(jnp.minimum(ix + 1, nka - 1), nka,
                                  dtype=dtype, axis=1)
            w = oh_l * c0[:, None, :] + oh_r * (1.0 - c0[:, None, :])

            moved = ff * mkc[:, :, None]        # [nkt, nka, n]
            ff = ff - moved \
                + jnp.einsum("tan,adn->tdn", moved, w)

            # volume landing in a different chemistry bin
            vol = moved * (fpi * rq ** 3)[:, :, None]
            dest_bin = jax.nn.one_hot(binid - 1, 4, dtype=dtype)  # [t,d,4]
            vmoved = jnp.einsum("tan,adn,tdb->bn", vol, w, dest_bin)
            for b in range(4):
                if b + 1 != kc:
                    vc = vc.at[b, kc - 1].add(vmoved[b])

        micro = micro.replace(ff=ff, fsum=jnp.sum(ff, axis=(0, 1)))

        # move dissolved species with the displaced volume
        for kc in range(1, self.nkc + 1):
            src = np.nonzero(self.tot.species_bin == kc)[0]
            if src.size == 0:
                continue
            for kkc in range(1, self.nkc + 1):
                if kkc == kc:
                    continue
                prs = _pair_indices(self.tot, self.tot_n2i, kc, kkc)
                if prs.size == 0:
                    continue
                vol_ch = vc[kkc - 1, kc - 1] * 1.0e-12
                cw_kc = cw[kc - 1]
                xfact = jnp.where(cw_kc > 0.0,
                                  vol_ch / jnp.maximum(cw_kc, 1e-300),
                                  0.0)
                xfact = jnp.clip(xfact, 0.0, 1.0)
                i_src = jnp.asarray(prs[:, 0])
                i_dst = jnp.asarray(prs[:, 1])
                xch = conc[i_src] * xfact[None, :]
                conc = conc.at[i_src].add(-xch)
                conc = conc.at[i_dst].add(xch)

        chem = chem.replace(conc=conc)
        return state.replace(micro=micro, chem=chem)


MultiphaseDriver.aerosol_mass_feedback = \
    MassFeedbackMixin.aerosol_mass_feedback
MultiphaseDriver._mass_ion_idx = MassFeedbackMixin._mass_ion_idx
