"""Model assembly: the operator-splitting timestep schedule.

The reference's two-level time loop (outer 1-minute steps, inner 6 x 10-s
substeps; str.f90:324-535) is encoded declaratively here: ``substep``
applies the fast physics in the reference's fixed order, ``minute_step``
wraps six substeps plus the 60-s radiation call and the clock update.
Everything is a pure function of the state pytree so the whole minute jits
into one XLA program and vmaps over column ensembles.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .config import MistraConfig
from .constants import PI
from .grids import Grids, make_grids
from .init import AstroConsts, initial_state, solar_constants
from .io.synthetic_inputs import announce_if_synthetic
from .physics import diffusion, microphysics, surface
from .physics.turbulence import atk0
from .state import ModelState


def solar_zenith(lst, lmin, alat, declin):
    """Cosine of solar zenith angle with spherical-shell path correction
    (reference: radinit.f90:1180-1189)."""
    zeit = lst * 3600.0 + lmin * 60.0
    horang = 7.272205e-5 * zeit - PI
    rlat = alat * 1.745329e-2
    rdec = declin * 1.745329e-2
    u00 = jnp.cos(rdec) * jnp.cos(rlat) * jnp.cos(horang) \
        + jnp.sin(rdec) * jnp.sin(rlat)
    ru0 = 6371.0 * u00
    return 8.0 / (jnp.sqrt(ru0 ** 2 + 102000.0) - ru0)


class Model:
    """Owns static configuration, grids and tables; provides step functions.

    The jitted step functions close over the static data; the dynamic state
    is the ModelState pytree.
    """

    def __init__(self, cfg: MistraConfig):
        self.cfg = cfg
        self.grids: Grids = make_grids(cfg)
        announce_if_synthetic(cfg.inpdir)
        self.clarke = surface.load_clarke_table(cfg.inpdir)
        self.astro: AstroConsts = solar_constants(cfg)
        self.consts: dict = {}
        self._radiation = None  # installed below (or None to disable)
        self._chemistry = None
        self._photolysis = None
        self._nucleation = None
        self.radiation_enabled = True
        # device copies of the atmosphere grid in the compute dtype
        import numpy as _np
        dt = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        from .grids import AtmGrid
        self.atm = AtmGrid(
            eta=jnp.asarray(self.grids.atm.eta, dt),
            etw=jnp.asarray(self.grids.atm.etw, dt),
            detw=jnp.asarray(self.grids.atm.detw, dt),
            deta=jnp.asarray(self.grids.atm.deta, dt))

    # ------------------------------------------------------------------
    def init_state(self, host_init: bool = True) -> ModelState:
        """Build the initial state (init sequence of str.f90:72-321).

        The init path runs once, eagerly, op by op.  By default it runs on
        the host CPU and the caller ``jax.device_put``s the result: for
        the float32 BTZ96 column on an H100 (700 W), eager init on the GPU
        took 61-63 s against 34-35 s on the host CPU plus the transfer,
        because every eager op compiles and launches a kernel of its own.
        """
        import contextlib
        ctx = contextlib.nullcontext()
        if host_init and jax.default_backend() != "cpu":
            ctx = jax.default_device(jax.local_devices(backend="cpu")[0])
        with ctx:
            return self._init_state_impl()

    def _init_state_impl(self) -> ModelState:
        state, consts = initial_state(self.cfg, self.grids, self.clarke)
        self.consts.update(consts)
        if self.radiation_enabled and self._radiation is None:
            from .radiation.driver import RadiationDriver
            self._radiation = RadiationDriver(self)
        if self.cfg.chem and self._chemistry is None:
            if self.cfg.mic and self.cfg.nkc_l > 0:
                from .chemistry.driver_aq import MultiphaseDriver
                self._chemistry = MultiphaseDriver(self)
            else:
                from .chemistry.driver import ChemistryDriver
                self._chemistry = ChemistryDriver(self)
        if (self.cfg.chem and self._photolysis is None
                and self._radiation is not None):
            from .photolysis.jrates import PhotolysisDriver
            self._photolysis = PhotolysisDriver(self, self._radiation)
        if (self.cfg.nuc and self.cfg.chem
                and self._nucleation is None
                and self._chemistry is not None):
            from .physics.nucleation import NucleationDriver
            self._nucleation = NucleationDriver(self)
        # initial exchange coefficients (atk0)
        turb = atk0(state.met, state.turb, state.surf, self.atm,
                    self.cfg.ug, self.cfg.vg, self.cfg.z0)
        state = state.replace(turb=turb)
        # aerosols onto the Koehler equilibrium curve
        met, micro = microphysics.equil(
            state.met, state.micro, self.grids.micro,
            consts["a0m"], jnp.asarray(consts["b0m"]), ncase=0,
            nf=self.cfg.grid.nf)
        state = state.replace(met=met, micro=micro)
        # initial solar zenith angle
        u0 = solar_zenith(state.tim.lst, state.tim.lmin,
                          self.astro.alat, self.astro.declin)
        state = state.replace(rad=state.rad.replace(u0=u0))
        # initial chemistry concentrations
        if self._chemistry is not None:
            state = state.replace(chem=self._chemistry.init_chem_state(state))
        # initial radiation call
        if self._radiation is not None:
            state = self._radiation(state, init=True)
        # initial photolysis rates
        if self._photolysis is not None:
            pj = jnp.where(state.rad.u0 > self._chemistry.u0min,
                           self._photolysis(state), 0.0)
            state = state.replace(chem=state.chem.replace(photol_j=pj))
        return state

    # ------------------------------------------------------------------
    def substep(self, state: ModelState, dd: float) -> ModelState:
        """One 10-s fractional step (dynamics + microphysics + surface)."""
        cfg, grids = self.cfg, self.grids
        n = cfg.grid.n
        a0m = self.consts["a0m"]
        b0m = jnp.asarray(self.consts["b0m"])

        # turbulent exchange of momentum/heat/moisture/TKE (+ closure)
        with jax.named_scope("difm"):
            met, turb, kinv = diffusion.difm(
                state.met, state.turb, state.surf, state.micro, self.atm, dd,
                cfg.ug, cfg.vg)
        state = state.replace(met=met, turb=turb,
                              tim=state.tim.replace(kinv=kinv))

        # turbulent exchange of chemical species
        if self._chemistry is not None:
            with jax.named_scope("difc"):
                out = diffusion.difc({"c": state.chem.sgas.T}, state.met,
                                     state.turb, self.atm, dd)
            new_c = out["c"].T
            if hasattr(state.chem, "conc"):
                state = state.replace(chem=state.chem.replace(conc=new_c))
            else:
                state = state.replace(chem=state.chem.replace(sgas=new_c))

        if cfg.mic:
            with jax.named_scope("difp"):
                micro = diffusion.difp(state.micro, state.met, state.turb,
                                       self.atm, dd)
            state = state.replace(micro=micro)
            ff_before_kon = state.micro.ff
            with jax.named_scope("kon"):
                state = self._kon(state, dd)
            # shift aqueous species between chemistry bins along with the
            # particles that crossed the aerosol/droplet threshold (konc)
            if self._chemistry is not None and hasattr(self._chemistry,
                                                       "konc"):
                chem = self._chemistry.konc(state.chem, ff_before_kon,
                                            state.micro.ff)
                state = state.replace(chem=chem)
            with jax.named_scope("sedp"):
                state = self._sedp(state, dd)
            met, micro = microphysics.equil(
                state.met, state.micro, grids.micro, a0m, b0m, ncase=2,
                nf=cfg.grid.nf)
            state = state.replace(met=met, micro=micro)
        else:
            # non-mic runs keep the boundary-layer top level in equilibrium
            met, micro = microphysics.equil(
                state.met, state.micro, grids.micro, a0m, b0m, ncase=1,
                nf=cfg.grid.nf, level=cfg.grid.nf - 1)
            state = state.replace(met=met, micro=micro)

        # radiative heating of interior levels
        t = state.met.t
        t = t.at[1:n - 1].add(state.rad.dtrad[1:n - 1] * dd)
        state = state.replace(met=state.met.replace(t=t))

        # surface boundary condition
        if cfg.isurf == 0:
            met, surf_state = surface.surf0(
                self.clarke, state.met, state.surf, self.atm.eta, dd,
                rhsurf=cfg.rhsurf, ltwcst=cfg.ltwcst, ntwopt=cfg.ntwopt)
            state = state.replace(met=met, surf=surf_state)
        else:
            surf_state = surface.soil(state.surf, grids.soil, dd)
            state = state.replace(surf=surf_state)
            met, surf_state = surface.surf1(
                self.clarke, state.met, state.surf, state.rad, self.atm,
                grids.soil, dd)
            state = state.replace(met=met, surf=surf_state)

        # gas-phase chemistry: surface exchange then stiff integration
        if self._chemistry is not None:
            # sea-salt aerosol + ion source (aer_source, kpp.f90:3810-4063)
            if (cfg.mic and cfg.iaertyp == 3
                    and hasattr(self._chemistry, "sa1_table")
                    and not cfg.chamber):
                from .chemistry.sources import aer_source
                state = aer_source(self, state, dd)
            vg = self._chemistry.gasdrydep(state)
            chem = state.chem.replace(vg=vg)
            chem = self._chemistry.sedc(chem, dd, self.atm.deta[1],
                                        self.atm.detw[1])
            state = state.replace(chem=chem)
            # wet deposition of dissolved species (sedl)
            if cfg.mic and hasattr(self._chemistry, "sedl"):
                chem = self._chemistry.sedl(state, dd)
                state = state.replace(chem=chem)
            # eulerian advective source below the inversion (neula=0)
            if cfg.neula == 0:
                chem = self._chemistry.eulerian_advection(
                    state.chem, state.tim.kinv, self._chemistry.am3, dd)
                state = state.replace(chem=chem)
            conc_before = state.chem.conc \
                if hasattr(state.chem, "conc") else None
            with jax.named_scope("chemistry"):
                chem = self._chemistry.integrate_column(state, dd)
            state = state.replace(chem=chem)
            # aerosol-mass feedback to the particle grid (stem_kpp,
            # str.f90:5975-6134)
            if (cfg.mic and conc_before is not None
                    and hasattr(self._chemistry, "aerosol_mass_feedback")):
                state = self._chemistry.aerosol_mass_feedback(state,
                                                              conc_before)
            # nucleation after chemistry (str.f90:397-405)
            if cfg.nuc and self._nucleation is not None:
                state, _ = self._nucleation(state, dd)

        tim = state.tim.replace(time=state.tim.time + dd)
        return state.replace(tim=tim)

    # placeholders filled in by the microphysics growth/sedimentation stage
    def _kon(self, state, dd):
        from .physics import growth
        return growth.kon(self, state, dd)

    def _sedp(self, state, dd):
        from .physics import sedimentation
        return sedimentation.sedp(self, state, dd)

    # ------------------------------------------------------------------
    def pre_minute(self, state: ModelState) -> ModelState:
        """Clock advance + once-per-minute deposition velocities."""
        lmin = state.tim.lmin + 1
        lst = state.tim.lst + lmin // 60
        lmin = lmin % 60
        lday = state.tim.lday + lst // 24
        lst = lst % 24
        state = state.replace(tim=state.tim.replace(lmin=lmin, lst=lst,
                                                    lday=lday))

        # particle dry deposition velocities, once per minute
        if not self.cfg.chamber:
            from .physics.sedimentation import partdep
            vd, xra = partdep(self, state)
            state = state.replace(micro=state.micro.replace(vd=vd, xra=xra))
        return state

    def post_minute(self, state: ModelState) -> ModelState:
        """Solar geometry, radiative transfer and photolysis (per minute)."""
        u0 = solar_zenith(state.tim.lst, state.tim.lmin,
                          self.astro.alat, self.astro.declin)
        state = state.replace(rad=state.rad.replace(u0=u0))
        if self._radiation is not None:
            with jax.named_scope("radiation"):
                state = self._radiation(state, init=False)

        # photolysis rates: recompute on even minutes when the sun is up,
        # hold when sun up on odd minutes, zero when dark (str.f90:445-476)
        if self._photolysis is not None:
            u0min = self._chemistry.u0min
            even = state.tim.lmin % 2 == 0
            compute = (u0 > u0min) & even

            def do_phot(s):
                return self._photolysis(s)

            def keep(s):
                return s.chem.photol_j

            pj = jax.lax.cond(compute, do_phot, keep, state)
            pj = jnp.where(u0 > u0min, pj, 0.0)
            state = state.replace(chem=state.chem.replace(photol_j=pj))
        return state

    def minute_step(self, state: ModelState) -> ModelState:
        """One outer 1-minute step: clock, 6 substeps, radiation."""
        state = self.pre_minute(state)

        # 6 × 10-s fractional steps as a scan: one substep body in the
        # compiled program instead of six unrolled copies, which keeps the
        # program and its compile time six times smaller
        def _sub(s, _):
            return self.substep(s, 10.0), None

        state, _ = jax.lax.scan(_sub, state, None, length=6)
        return self.post_minute(state)

    # ------------------------------------------------------------------
    def jit_minute_step(self):
        return jax.jit(self.minute_step)
