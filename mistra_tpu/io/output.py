"""Science output writer without native dependencies.

Stands in for the native netCDF writer (io/netcdf.py) where that library
cannot be built or libnetcdf is missing.  It keeps the reference's
variable groups (``out_netCDF.f``:30-4676: grid / met / mic / chem_gas /
chem_aq / jrate) and cadences (15-min group snapshots, 30-min particle
spectra; str.f90:479-508), written with numpy alone: ``grid.npz`` once,
then one ``snapshot_NNNNN.npz`` per snapshot whose keys are
``group/name``.
"""

from __future__ import annotations

import os

import numpy as np


class OutputWriter:
    """Writes time-slab snapshots of the state as numpy ``.npz`` files."""

    def __init__(self, outdir: str, model):
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self.model = model
        self._isnap = 0
        self._write_grid()

    # ------------------------------------------------------------------
    def _write_grid(self):
        atm = self.model.grids.atm
        mic = self.model.grids.micro
        grid = {name: np.asarray(arr) for name, arr in [
            ("eta", atm.eta), ("etw", atm.etw), ("detw", atm.detw),
            ("deta", atm.deta), ("rn", mic.rn), ("rq", mic.rq),
            ("rw", mic.rw), ("en", mic.en), ("e", mic.e),
            ("rpw", mic.rpw)]}
        if self.model._chemistry is not None:
            grid["gas_species"] = np.array(self.model._chemistry.mech.species)
        np.savez(os.path.join(self.outdir, "grid.npz"), **grid)

    # ------------------------------------------------------------------
    def snapshot(self, state, particles: bool = False):
        """Write one 15-min snapshot (particle spectra optional, 30-min)."""
        met = state.met
        out = {"met/time": state.tim.time}
        for name in ("u", "v", "t", "theta", "xm1", "xm2", "feu", "tke",
                     "rho", "p"):
            out[f"met/{name}"] = getattr(met, name)
        out["met/dtrad"] = state.rad.dtrad
        out["met/u0"] = state.rad.u0
        out["met/atkh"] = state.turb.atkh

        if self.model.cfg.mic:
            out["mic/fsum"] = state.micro.fsum
            out["mic/lcl"] = state.micro.lcl
            out["mic/lct"] = state.micro.lct
            from ..physics.projection import oneD_dist
            out["mic/part1D"] = oneD_dist(state.micro.ff,
                                          self.model.grids.micro,
                                          self.model.cfg.grid.nf)
            if particles:
                out["mic/ff"] = state.micro.ff

        if state.chem is not None:
            out["chem_gas/sgas"] = state.chem.sgas
            out["jrate/photol_j"] = state.chem.photol_j
            if hasattr(state.chem, "sl1"):
                out["chem_aq/sl1"] = state.chem.sl1
                out["chem_aq/sion1"] = state.chem.sion1
        path = os.path.join(self.outdir, f"snapshot_{self._isnap:05d}.npz")
        np.savez(path, **{k: np.asarray(v) for k, v in out.items()})
        self._isnap += 1

    def close(self):
        pass
