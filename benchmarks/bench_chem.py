"""Chemistry throughput: cell-steps/s per device for the gas and tot
mechanisms.

One "cell-step" = one (column, layer) cell advanced through one 10-s
operator-splitting substep by the batched Ros3 integrator (adaptive
internal stepping).  Needs the reference mechanism (``--mechdir``, default
MECHDIR).

Usage: python benchmarks/bench_chem.py [--mech gas|tot] [--cells N]
       [--dtype float32|float64] [--mechdir DIR] [--platform cpu]
"""

from __future__ import annotations

import argparse
import numpy as np
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mech", default="gas", choices=["gas", "tot"])
    ap.add_argument("--cells", type=int, default=2048)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--platform", default="")
    ap.add_argument("--dt", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--mechdir", default="")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mistra_tpu.config import MistraConfig
    from mistra_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()

    from mistra_tpu.chemistry.gas_kernel import GasKernel
    from mistra_tpu.chemistry.mech import (load_gas_mechanism,
                                           load_multiphase_mechanism)
    from mistra_tpu.chemistry.rates import RateEnv

    mechdir = args.mechdir or MistraConfig(chem=False).mechdir
    if args.mech == "gas":
        mech = load_gas_mechanism(mechdir)
    else:
        mech = load_multiphase_mechanism(mechdir, name="tot")
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    kernel = GasKernel(mech, dtype=dtype)

    B = args.cells
    key = jax.random.PRNGKey(0)
    # representative environment: near-surface marine boundary layer
    te = jnp.full((B,), 288.15, dtype)
    aircc = jnp.full((B,), 2.55e19, dtype)
    air = jnp.full((B,), 42.3, dtype)           # mol/m3
    h2oppm = jnp.full((B,), 1.2e4, dtype)
    pk = jnp.full((B,), 1.013e5, dtype)
    phj = jnp.full((B, 47), 1.0e-5, dtype)       # daytime-magnitude J's

    fix_names = list(mech.fixed)
    fix_cols = {"O2": 0.21 * air, "N2": 0.79 * air,
                "H2O": jnp.full((B,), 0.5, dtype)}
    for b in range(1, 5):
        fix_cols[f"H2Ol{b}"] = jnp.zeros((B,), dtype)
    fix = jnp.stack([fix_cols.get(s, jnp.zeros((B,), dtype))
                     for s in fix_names], axis=-1)
    env = RateEnv(te=te, aircc=aircc, h2oppm=h2oppm, pk=pk,
                  ph_rat=phj, xhal=1.0, xiod=1.0)
    if args.mech == "tot":
        # aqueous machinery off (dry cells): zero transfer/equilibria
        from mistra_tpu.chemistry.rates import probe_dry_extras
        extras = probe_dry_extras(mech, env, jnp.zeros((B,), dtype))
        env = RateEnv(te=te, aircc=aircc, h2oppm=h2oppm, pk=pk,
                      ph_rat=phj, xhal=1.0, xiod=1.0, extras=extras)

    # physical initial concentrations: the reference's ground-level gas
    # mixing ratios (gas_species.csv, as initc kpp.f90:33 loads them) with
    # a +-50% per-cell log-perturbation; random log-uniform states are
    # unphysically stiff (Jacobian entries ~1e15 from radical-radical
    # terms) and measure rejection-loop throughput, not chemistry
    from mistra_tpu.chemistry.gas_kernel import load_species_csv
    sp_csv = load_species_csv(mechdir + "/gas_species.csv")
    name2i = {s: i for i, s in enumerate(mech.species)}
    conv = 42.3e-9                                  # ppb -> mol/m3 at sfc
    y0_np = np.zeros((B, mech.nvar))  # unspecified species start at exactly 0 (initc)
    for s in sp_csv:
        if s["name"] in name2i and s["ground_ppb"] > 0:
            y0_np[:, name2i[s["name"]]] = s["ground_ppb"] * conv
    import numpy as np_mod
    rng = np_mod.random.default_rng(0)
    y0 = jnp.asarray(y0_np * np_mod.exp(rng.uniform(-0.5, 0.5, y0_np.shape)),
                     dtype)

    k = kernel.rate_constants(env, fix=fix)

    @jax.jit
    def substep(y):
        ynew, info = kernel.integrate(y, k, fix, args.dt)
        return jnp.maximum(ynew, 0.0), info["nsteps"], info["n_failed"]

    y, nsteps, nfail = jax.block_until_ready(substep(y0))
    t0 = time.perf_counter()
    for _ in range(args.reps):
        y, nsteps, nfail = substep(y)
    jax.block_until_ready(y)
    dt_wall = (time.perf_counter() - t0) / args.reps

    steps_mean = float(jnp.mean(nsteps))
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"chem_{args.mech}_cell_steps_per_s",
        "value": round(B / dt_wall, 1),
        "unit": "cell-substeps/s/device",
        "cells": B, "nvar": mech.nvar, "nrxn": mech.nrxn,
        "dtype": args.dtype,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "wall_per_substep_s": round(dt_wall, 4),
        # one substep = several adaptive Ros3 steps; the per-Ros-step
        # rate is the unit the serial native baseline reports
        "ros_steps_per_substep_mean": round(steps_mean, 1),
        "ros_steps_per_substep_max": int(jnp.max(nsteps)),
        "cell_ros_steps_per_s": round(B * steps_mean / dt_wall, 1),
        "n_nonconverged": int(nfail),
    }))


if __name__ == "__main__":
    main()
