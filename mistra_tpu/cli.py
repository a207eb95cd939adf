"""Run harness: the reference's param/namelist launch workflow as a CLI.

Parity with the bash launchers (param/param_*, C40): configuration comes
from the INPDIR / OUTDIR / MECHDIR / NAMELIST environment variables or
command-line flags; the run writes 15-min science output, a per-minute
progress line (tima.out equivalent), 12-hourly restart checkpoints and a
final restart + aerosol dump.

Usage:
    python -m mistra_tpu --namelist /path/to/namelist.BTZ96 [--hours H]
                         [--outdir DIR] [--restart CKPT] [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time as wallclock


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mistra_tpu")
    ap.add_argument("--namelist",
                    default=os.environ.get("NAMELIST", ""),
                    help="Fortran namelist file (reference format)")
    ap.add_argument("--outdir", default=os.environ.get("OUTDIR", "./output"))
    ap.add_argument("--hours", type=float, default=None,
                    help="override lstmax integration hours")
    ap.add_argument("--restart", default="",
                    help="checkpoint directory to restore from")
    ap.add_argument("--platform", default="",
                    help="force jax platform (e.g. cpu)")
    ap.add_argument("--grid", default="",
                    help="override grid sizes for quick runs, e.g. "
                         "'nf=12,n_extra=6,nka=16,nkt=16,nb=8[,zinv=100]'")
    ap.add_argument("--minutes", type=int, default=None,
                    help="integrate this many minutes instead of full hours")
    ap.add_argument("--profile", default="",
                    help="capture a jax.profiler trace of minutes 2-4 "
                         "into this directory (view with TensorBoard)")
    ap.add_argument("--x64", action="store_true", default=True)
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    from .utils.compile_cache import configure_compile_cache
    configure_compile_cache()

    import numpy as np

    from .config import MistraConfig, config_from_namelist
    from .model import Model
    from .io.checkpoint import restore_checkpoint, save_checkpoint
    from .io.output import OutputWriter

    if args.namelist:
        cfg = config_from_namelist(args.namelist)
    else:
        cfg = MistraConfig()
    if args.hours is not None:
        cfg.lstmax = max(1, int(round(args.hours)))
    if args.grid:
        from .config import GridParams
        kv = dict(p.split("=") for p in args.grid.split(","))
        zinv = kv.pop("zinv", None)
        cfg.grid = GridParams(**{k: int(v) for k, v in kv.items()})
        if zinv is not None:
            cfg.zinv = float(zinv)
    cfg.outdir = args.outdir
    os.makedirs(args.outdir, exist_ok=True)

    print(f"mistra_tpu: {'box' if cfg.box else 'chamber' if cfg.chamber else '1-D'}"
          f" run, {cfg.lstmax} h, chem={cfg.chem} mic={cfg.mic}")
    if cfg.box or cfg.chamber:
        from .boxmodel import BoxModel
        box = BoxModel(cfg)
        model = box.model
        state = box.init_state()
        step_owner = box
    else:
        model = Model(cfg)
        state = model.init_state()
        step_owner = model
    if args.restart:
        state = restore_checkpoint(args.restart, state)
        print(f"restored state from {args.restart}")

    from .io import netcdf as ncio
    if ncio.available():
        # reference-layout netCDF groups via the native async writer
        writer = ncio.NetCDFOutputWriter(args.outdir, model)
        print(f"output: native netCDF writer -> {args.outdir}/*.nc")
    else:
        writer = OutputWriter(args.outdir, model)
        print(f"output: numpy writer -> {args.outdir}/*.npz (native "
              f"netCDF writer unavailable: {ncio._LIB_ERR!r})")
    writer.snapshot(state, particles=cfg.mic)

    step = step_owner.jit_minute_step()
    itmax = args.minutes if args.minutes is not None else 60 * cfg.lstmax

    # hourly element-family mass closure (mass_ch, kpp.f90:5900-6181)
    mass_fn = None
    if model._chemistry is not None:
        from .chemistry import diagnostics as chem_diag
        drv = model._chemistry
        mech_m = getattr(drv, "tot", drv.mech)
        sb = getattr(mech_m, "species_bin", None)
        detw_d = model.atm.detw
        mass_fn = jax.jit(lambda s: chem_diag.family_column_totals(
            s.chem.sgas, mech_m.species, detw_d, species_bin=sb))
        mass_out = open(os.path.join(args.outdir, "mass.out"), "w")
        mass_out.write("# day hh:mm  column totals [mol/m2]: "
                       "Cl Br I S N\n")

    # opt-in per-reaction budgets (C33): accumulate every minute at the
    # nlev_bud output levels, write with each 15-min snapshot
    budgets = None
    if cfg.binout and model._chemistry is not None \
            and hasattr(writer, "write_budgets") and writer.rxn is not None:
        lev_bud = writer.bud_levels
        rates_fn = jax.jit(
            lambda s: model._chemistry.reaction_rates_at(s, lev_bud))
        bud_cum = None
        # S/DMS species budgets at all levels (bud_s_{g,a,t}.f):
        # restrict the full-level rate evaluation to the S channels
        import jax.numpy as jnp
        s_ch = jnp.asarray(writer.s_channels)
        lev_all = np.arange(1, cfg.grid.n - 1)
        s_rates_fn = jax.jit(lambda s: model._chemistry.reaction_rates_at(
            s, lev_all)[:, s_ch])
        sbud_cum = None
        s_inst_full = None
    xn_apacc = None   # cumulative apparent-nucleation count (nucout2)
    tima = open(os.path.join(args.outdir, "tima.out"), "w")
    t_start = wallclock.time()

    for it in range(1, itmax + 1):
        if args.profile and it == 2:
            import jax.profiler as _prof
            _prof.start_trace(args.profile)
        state = step(state)
        if args.profile and it == 4:
            import numpy as _np
            _np.asarray(state.met.t)    # block before stopping the trace
            import jax.profiler as _prof
            _prof.stop_trace()
            print(f"profiler trace written to {args.profile}")
        lday, lst, lmin = (int(state.tim.lday), int(state.tim.lst),
                           int(state.tim.lmin))
        # progress line (reference cadence: every minute; str.f90:517-531)
        tke = np.asarray(state.met.tke)
        atkh = np.asarray(state.turb.atkh)
        xm2 = np.asarray(state.met.xm2)
        rho = np.asarray(state.met.rho)
        line = (f"{lday:2d}:{lst:2d}:{lmin:2d} "
                f"tke={tke[:100].max():8.3f} atkh={atkh[:100].max():8.3f} "
                f"lwc={1000 * (xm2[:100] / rho[:100]).max():8.3f}")
        nonconv = int(getattr(state.chem, "nonconv", 0) or 0) \
            if state.chem is not None else 0
        if nonconv:
            # per-cell stiff-solver failures (reference warning path,
            # gas.f:764-767): frozen cells, cumulative count
            line += f" chem_nonconv={nonconv}"
        tima.write(line + "\n")
        tima.flush()
        if cfg.binout and model._chemistry is not None \
                and hasattr(writer, "write_budgets") \
                and writer.rxn is not None:
            inst = np.asarray(rates_fn(state)).T        # [nrxn, nlev]
            bud_cum = inst * 60.0 if bud_cum is None else bud_cum \
                + inst * 60.0
            s_lev = np.asarray(s_rates_fn(state)).T     # [nch_s, n-2]
            s_inst_full = np.zeros((s_lev.shape[0], cfg.grid.n))
            s_inst_full[:, 1:cfg.grid.n - 1] = s_lev
            sbud_cum = s_inst_full * 60.0 if sbud_cum is None \
                else sbud_cum + s_inst_full * 60.0
        if it % 15 == 0:
            writer.snapshot(state, particles=cfg.mic and it % 30 == 0)
            if cfg.binout and hasattr(writer, "write_budgets") \
                    and writer.rxn is not None and bud_cum is not None:
                writer.write_budgets(inst, bud_cum, s_inst_full, sbud_cum)
            if getattr(writer, "nuc", None) is not None \
                    and model._nucleation is not None:
                # nucleation diagnostics snapshot (nucout1/2)
                _, nuc_diag = model._nucleation(state, 60.0)
                xn_apacc = xn_apacc + np.asarray(
                    nuc_diag["xn_app"]) * 900.0 \
                    if xn_apacc is not None else \
                    np.asarray(nuc_diag["xn_app"]) * 900.0
                writer.write_nucleation(nuc_diag, xn_apacc)
        if lmin == 0:   # hourly ASCII profiles (str.f90:504-508)
            from .io import profiles as prof
            with open(os.path.join(args.outdir, "profm.out"), "a") as fh:
                prof.profm(fh, state, model.atm, cfg.grid.nf)
            with open(os.path.join(args.outdir, "profr.out"), "a") as fh:
                prof.profr(fh, state, model.atm, cfg.grid.nf)
            if model._chemistry is not None:
                drv0 = model._chemistry
                mech0 = getattr(drv0, "tot", drv0.mech)
                with open(os.path.join(args.outdir, "profc.out"),
                          "a") as fh:
                    prof.profc(fh, state, model.atm, mech0.species,
                               cfg.grid.nf)
        if mass_fn is not None and lmin == 0:
            tot = {k: float(v) for k, v in mass_fn(state).items()}
            mass_out.write(f"{lday:2d} {lst:02d}:{lmin:02d}  "
                           + " ".join(f"{tot[e]:.6e}" for e in
                                      ("Cl", "Br", "I", "S", "N")) + "\n")
            mass_out.flush()
        if lst % 12 == 0 and lmin == 0 and not cfg.box:
            save_checkpoint(os.path.join(args.outdir, "restart"), state)
        if it % 60 == 0:
            el = wallclock.time() - t_start
            print(f"  {it}/{itmax} min done ({el:.0f}s wall, "
                  f"{el / it:.1f} s/min)")

    save_checkpoint(os.path.join(args.outdir, "restart"), state)
    # final aerosol spectrum (ae*.out equivalent; str.f90:540-553)
    if cfg.mic:
        aer = np.asarray(state.micro.ff).sum(axis=0)  # [nka, n]
        np.save(os.path.join(args.outdir, "aerosol_final.npy"), aer.T)
    writer.close()
    if mass_fn is not None:
        mass_out.close()
    tima.close()
    print("run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
