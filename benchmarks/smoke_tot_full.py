"""Production-size multiphase smoke: the FULL BTZ96-style column
(n=150 layers, 70x70 bins, nkc=4 aqueous bins, 421-species tot
mechanism) advanced through real minute steps on the GPU.

This is the configuration the reference spends its life in
(kpp_driver -> tot_drive for every layer below nf, kpp.f90:4168-4468);
the smoke proves the block-arrow solver + full aqueous parameter stack
compile and run at production shape, and reports the wall time per model
minute.  Needs the reference tables and mechanism (INPDIR, MECHDIR).

Usage: python benchmarks/smoke_tot_full.py [--minutes 2] [--platform cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the combined f64-chemistry + full-physics graph exceeds CPython's
# default recursion limit during MLIR lowering
sys.setrecursionlimit(100000)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=int, default=2)
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    # model state in f32; the multiphase stiff solves need f64
    # (cfg.chem_f64), which requires x64 support enabled
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from mistra_tpu.config import MistraConfig
    from mistra_tpu.model import Model
    from mistra_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()

    cfg = MistraConfig(chem=True, mic=True, nkc_l=4, halo=True,
                       iod=False, dtype="float32", tw=288.15,
                       zinv=800.0, dtinv=7.0, ug=8.5, vg=0.0,
                       nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
    model = Model(cfg)

    dev = jax.devices()[0]
    state = jax.device_put(model.init_state(), dev)

    step = model.jit_minute_step()
    t0 = time.time()
    state = jax.block_until_ready(step(state))   # compile + first step
    t_compile = time.time() - t0

    t0 = time.time()
    for _ in range(args.minutes):
        state = step(state)
    jax.block_until_ready(state)
    dt_min = (time.time() - t0) / args.minutes

    conc = np.asarray(state.chem.conc)
    ok = bool(np.all(np.isfinite(conc))) and \
        bool(np.all(np.isfinite(np.asarray(state.met.t))))
    gp = cfg.grid
    print(json.dumps({
        "metric": "tot_full_column_s_per_model_minute",
        "value": round(dt_min, 2),
        "unit": "s/model-minute",
        "ok": ok,
        "grid": [gp.n, gp.nka, gp.nkt], "nkc": 4,
        "nvar_tot": int(conc.shape[0]),
        "nonconv": int(np.asarray(state.chem.nonconv)),
        "compile_and_first_step_s": round(t_compile, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
