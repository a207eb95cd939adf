"""Box and chamber model modes.

The reference can collapse the 1-D column to a single well-mixed box
(``box=.true.``, str.f90:6613-7104) or a smog chamber
(``chamber=.true.``, str.f90:7699-7950): dynamics, microphysics and
radiation are frozen after initialisation and only chemistry (plus
deposition and sea-salt emission) runs at one level ``n_bl``.

The box is a 1-cell batch of the same chemistry kernel the 1-D column
uses, so this mode shares every compiled kernel with the column model; a
box ensemble (vmapped over perturbed initial conditions) is the natural
accelerator use of this mode.

Parity map: box_init/box_update str.f90:6613-6883, sedc_box
str.f90:6890-7014, box_partdep str.f90:7021-7104, get_n_box
str.f90:7229-7268, chamb_init/chamb_update str.f90:7699-7950,
photol_chamber kpp.f90:8606-8687, ave_j kpp.f90:6291-6343.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .model import Model, solar_zenith
from .physics.thermo import p21

# gas deposition-velocity overrides for box runs (sedc_box,
# str.f90:6961-6990): name -> fixed value [m/s] or the species whose vg
# is copied
VG_FIXED = {"NH3": 0.27e-2, "DMS": 0.0, "CH3I": 0.0, "CH2I2": 0.0,
            "CH2ClI": 0.0, "C3H7I": 0.0, "CH2BrI": 0.0, "CHBr2I": 0.0,
            "C2H5I": 0.0}
VG_COPY = {"N2O5": "HCl", "HOCl": "HCl", "HOBr": "HCl", "CH3SO3H": "HCl",
           "I2O2": "HOI", "INO2": "HOI"}

N_BL = 1          # 0-based box level (reference n_bl = 2)


def get_n_box(atm_grid, z_box):
    """Snap the box top to the nearest full-level boundary
    (str.f90:7229-7268)."""
    etw = np.asarray(atm_grid.etw)
    nz = int(np.argmin(np.abs(etw - z_box)))
    return nz, float(etw[nz])


def read_chamber_dat(path):
    """chamber.dat: t0 [K], rh0 [%], then measured J slots
    '<slot> <value> <name>' (photol_chamber, kpp.f90:8644-8661)."""
    with open(path) as f:
        lines = f.readlines()
    t0 = float(lines[0].split()[0])
    rh0 = float(lines[1].split()[0])
    jmeas = {}
    for line in lines[4:]:
        parts = line.split()
        if len(parts) >= 2:
            try:
                jmeas[int(parts[0])] = float(parts[1])
            except ValueError:
                continue
    return t0, rh0, jmeas


class BoxModel:
    """Single-level (box / chamber) run reusing the 1-D model kernels."""

    def __init__(self, cfg):
        if not (cfg.box or cfg.chamber):
            raise ValueError("BoxModel requires cfg.box or cfg.chamber")
        self.cfg = cfg
        self.model = Model(cfg)
        if cfg.chamber:
            # chamber runs start at midday with fixed declination
            # (initm, str.f90:1075,1095)
            import dataclasses
            self.model.astro = dataclasses.replace(self.model.astro,
                                                   declin=18.0)
        self.nz_box, self.z_box = get_n_box(self.model.grids.atm,
                                            cfg.z_box)
        self.chamber_dat = None
        if cfg.chamber:
            import os
            path = os.path.join(cfg.cinpdir_phot, "chamber.dat") \
                if getattr(cfg, "cinpdir_phot", None) else \
                "/root/reference/input/photolys/chamber.dat"
            self.chamber_dat = read_chamber_dat(path)

    # ------------------------------------------------------------------
    def init_state(self):
        m = self.model
        state = m.init_state()
        met = state.met
        cfg = self.cfg

        if cfg.chamber:
            t0, rh0, _ = self.chamber_dat
            feu0 = rh0 * 1.0e-2
            zp21 = p21(jnp.asarray(t0, met.t.dtype))
            xm10 = (0.62198 * feu0 * zp21) / (met.p[N_BL]
                                              - 0.37802 * feu0 * zp21)
            t_bl, xm1_bl, feu_bl = t0, xm10, feu0
        elif cfg.bl_box:
            # arithmetic average over the boundary layer (box_init)
            sel = slice(1, self.nz_box + 1)
            t_bl = jnp.mean(met.t[sel])
            xm1_bl = jnp.mean(met.xm1[sel])
            feu_bl = xm1_bl * met.p[N_BL] / (
                (0.62198 + 0.37802 * xm1_bl) * p21(t_bl))
        else:
            lev = cfg.nlevbox - 1
            t_bl = met.t[lev]
            xm1_bl = met.xm1[lev]
            feu_bl = xm1_bl * met.p[N_BL] / (
                (0.62198 + 0.37802 * xm1_bl) * p21(t_bl))

        met = met.replace(t=met.t.at[N_BL].set(t_bl),
                          xm1=met.xm1.at[N_BL].set(xm1_bl),
                          feu=met.feu.at[N_BL].set(feu_bl))
        if cfg.mic:
            # re-equilibrate the particle spectrum at the box level with
            # the overridden humidity (box_update/chamb_update both call
            # equil(1, n_bl) after resetting T/rh, str.f90:6846/7897)
            from .physics import microphysics
            met, micro = microphysics.equil(
                met, state.micro, m.grids.micro, m.consts["a0m"],
                jnp.asarray(m.consts["b0m"]), 1, cfg.grid.nf,
                level=N_BL)
            state = state.replace(micro=micro)
        tim = state.tim.replace(kinv=jnp.asarray(cfg.grid.nf))
        if cfg.chamber:
            tim = tim.replace(lst=12)
        state = state.replace(met=met, tim=tim)

        # particle deposition velocities once (frozen meteorology)
        from .physics.sedimentation import partdep
        vd, xra = partdep(m, state)
        state = state.replace(micro=state.micro.replace(vd=vd, xra=xra))
        return state

    # ------------------------------------------------------------------
    def _sedc_box(self, state, dt):
        """Gas dry deposition + emission over the box depth
        (str.f90:6890-7014)."""
        m = self.model
        drv = m._chemistry
        chem = state.chem
        vg = drv.gasdrydep(state)
        n2i = getattr(drv, "tot_n2i", drv.name2i)
        for sp, val in VG_FIXED.items():
            if sp in n2i:
                vg = vg.at[n2i[sp]].set(val)
        for sp, src in VG_COPY.items():
            if sp in n2i and src in n2i:
                vg = vg.at[n2i[sp]].set(vg[n2i[src]])
        conc = chem.sgas if not hasattr(chem, "conc") else chem.conc
        dep = jnp.where(vg >= 1.0e-5, jnp.exp(-dt / self.z_box * vg), 1.0)
        s_old = conc[:, N_BL]
        s_new = s_old * dep
        conc = conc.at[:, N_BL].set(s_new)
        conc = conc.at[:, 0].add((s_old - s_new) * self.z_box)
        # emissions [molec/cm2/s] -> mol/m3
        from .constants import AVOGADRO
        es = np.zeros(conc.shape[0])
        for s in drv.csv_in_mech:
            es[n2i[s["name"]]] = s["emission"]
        conc = conc.at[:, N_BL].add(
            jnp.asarray(es, conc.dtype) * dt * 1.0e4
            / (self.z_box * AVOGADRO))
        chem = chem.replace(conc=conc) if hasattr(chem, "conc") \
            else chem.replace(sgas=conc)
        return state.replace(chem=chem)

    # ------------------------------------------------------------------
    def _box_partdep(self, state, dt):
        """Deposit particles and dissolved species from the box
        (str.f90:7021-7104)."""
        m = self.model
        micro = state.micro
        ff_old = micro.ff[:, :, N_BL]
        ff_new = ff_old * jnp.exp(-dt / self.z_box * micro.vd)
        ff = micro.ff.at[:, :, N_BL].set(ff_new)
        ff = ff.at[:, :, 0].add((ff_old - ff_new) * self.z_box)
        micro = micro.replace(ff=ff, fsum=jnp.sum(ff, axis=(0, 1)))
        state = state.replace(micro=micro)

        drv = m._chemistry
        if hasattr(drv, "tot"):
            from .chemistry import aqueous as aq
            from .constants import PI
            dtype = drv.dtype
            met = state.met
            lp_cw, _, _, _, _ = aq.cw_rc(
                state.micro.ff, met.feu, state.chem.cloud,
                m.grids.micro, drv.masks, dtype)
            rq3 = jnp.asarray(m.grids.micro.rq, dtype) ** 3 * 1.0e-18
            msk = jnp.asarray(drv.masks, dtype)
            xx1 = jnp.einsum("tk,tk,tkc->c", micro.vd * rq3 * 1.0e6,
                             ff[:, :, N_BL], msk)
            cw_bl = lp_cw[:, N_BL]
            vdm = jnp.where(cw_bl > 0.0,
                            4.0 * PI / 3.0 / jnp.maximum(cw_bl, 1e-300)
                            * xx1, 0.0)
            conc = state.chem.conc
            sb = drv.tot.species_bin
            kc_of = jnp.asarray(np.maximum(sb, 1) - 1)   # bin 1..4 -> 0..3
            is_aq = jnp.asarray(sb > 0)
            depf = jnp.where(is_aq,
                             jnp.exp(-dt / self.z_box * vdm[kc_of]), 1.0)
            s_old = conc[:, N_BL]
            s_new = s_old * depf
            conc = conc.at[:, N_BL].set(s_new)
            conc = conc.at[:, 0].add((s_old - s_new) * self.z_box)
            state = state.replace(chem=state.chem.replace(conc=conc))
        return state

    # ------------------------------------------------------------------
    def _chamber_photolysis(self, state):
        """Measured J values, with unmeasured slots scaled by the
        jNO2 ratio (photol_chamber); lights on 15 min after start, off
        after 2 h (chamb_update schedule)."""
        _, _, jmeas = self.chamber_dat
        m = self.model
        pj_model = m._photolysis(state)              # [nphrxn, n]
        nph = pj_model.shape[0]
        jratio = jmeas.get(1, 0.0) / jnp.maximum(pj_model[0, N_BL], 1e-30)
        pj = pj_model[:, N_BL] * jratio
        meas = np.zeros(nph)
        have = np.zeros(nph, bool)
        for slot, val in jmeas.items():
            if 1 <= slot <= nph:
                meas[slot - 1] = val
                have[slot - 1] = True
        pj = jnp.where(jnp.asarray(have), jnp.asarray(meas, pj.dtype), pj)

        t = state.tim.time
        lights = (t >= 15.0 * 60.0) & (t < 2.0 * 3600.0)
        pj = jnp.where(lights, pj, 0.0)
        return jnp.broadcast_to(pj[:, None],
                                (nph, state.chem.photol_j.shape[1]))

    # ------------------------------------------------------------------
    def minute_step(self, state):
        """One outer minute: clock, 6 chemistry substeps, photolysis."""
        m = self.model
        cfg = self.cfg
        lmin = state.tim.lmin + 1
        lst = state.tim.lst + lmin // 60
        lmin = lmin % 60
        lday = state.tim.lday + lst // 24
        lst = lst % 24
        state = state.replace(tim=state.tim.replace(lmin=lmin, lst=lst,
                                                    lday=lday))

        def substep(state, _):
            dd = 10.0
            if cfg.box and cfg.iaertyp == 3 and cfg.mic \
                    and hasattr(m._chemistry, "sa1_table"):
                from .chemistry.sources import aer_source
                state = aer_source(m, state, dd, k_in=N_BL,
                                   d_z=self.z_box)
            state = self._sedc_box(state, dd)
            state = self._box_partdep(state, dd)
            if hasattr(m._chemistry, "integrate_box"):
                chem = m._chemistry.integrate_box(state, dd, N_BL)
            else:
                chem = m._chemistry.integrate_column(state, dd)
            state = state.replace(chem=chem)
            state = state.replace(tim=state.tim.replace(
                time=state.tim.time + dd))
            return state, None

        # scan (not a Python loop): six copies of the stiff-solver body
        # in one flat graph overflow the XLA CPU compiler's stack
        state, _ = jax.lax.scan(substep, state, None, length=6)

        u0 = solar_zenith(state.tim.lst, state.tim.lmin,
                          m.astro.alat, m.astro.declin)
        state = state.replace(rad=state.rad.replace(u0=u0))

        if cfg.chamber:
            pj = self._chamber_photolysis(state)
            state = state.replace(chem=state.chem.replace(photol_j=pj))
        elif m._photolysis is not None:
            u0min = m._chemistry.u0min
            even = state.tim.lmin % 2 == 0
            compute = (u0 > u0min) & even
            pj = jax.lax.cond(compute, lambda s: m._photolysis(s),
                              lambda s: s.chem.photol_j, state)
            pj = jnp.where(u0 > u0min, pj, 0.0)
            if cfg.bl_box:
                # average J over the boundary layer (ave_j)
                avg = jnp.mean(pj[:, 1:self.nz_box + 1], axis=1)
                pj = pj.at[:, N_BL].set(avg)
            state = state.replace(chem=state.chem.replace(photol_j=pj))
        return state

    def jit_minute_step(self):
        return jax.jit(self.minute_step)
