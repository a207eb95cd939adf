"""GPU smoke test of the BTZ96 column model at full width.

Drives the main path once on one NVIDIA GPU, at the reference's full
width (150 layers, 70x70 bins, 18-band PIFM2 radiation), on seeded
generated input tables (io/synthetic_inputs.py; INPDIR overrides):

  a. card: name and power limit from nvidia-smi, JAX device and version;
  b. CLI: ``mistra_tpu.cli.main`` on a BTZ96 namelist, 3 minutes, f64;
     checks the progress file, snapshot, restart and physical bounds;
  c. GPU against CPU: the same f64 column for 2 minutes on both, with the
     trip counts of the data-dependent while loops;
  d. ensemble: ``jit(vmap(minute_step))`` over 128 f32 columns: compile
     time, warm seconds per minute step, memory, per-component split,
     device idle share, and agreement with phase c's f64 column;
  e. the multiphase solver's block inverse ``batched_inv`` in f64 at the
     tot mechanism's block shapes, against numpy;
  k. the Bott advection kernels (physics/bott_triton.py) against the
     banded XLA form at the model's bin width, and their times.

The last line of standard output is one JSON object naming the device.
Without a GPU it exits non-zero and prints no result.

Usage:
    python chip_smoke.py            # phases a-e on one GPU
    python chip_smoke.py --four     # only the 4-GPU dp ensemble against
                                    # the same columns on one GPU
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mistra_tpu.config import BTZ96, MistraConfig  # noqa: E402
from mistra_tpu.io.synthetic_inputs import ensure_synthetic_inputs  # noqa
from mistra_tpu.utils.compile_cache import configure_compile_cache  # noqa

BATCH = 128

# Phase c (f64, GPU against CPU): both sides run the same f64 program; they
# differ by summation order in reductions, scans and the Bott walk, and by
# the libraries' transcendental functions (~1e-16 relative per operation).
# Measured on an H100 after 2 minutes: T 2.4e-15, xm1 1.5e-13, xm2 7.3e-13,
# tke 3.8e-12, ff column sums 1.3e-13; each limit is about 30 to 400 times
# its reading, so any float32 stage in the GPU's f64 path (>= 1e-8) fails.
# Tolerances are relative to each field's maximum magnitude.
TOL_C = {"T": 1e-12, "xm1": 1e-11, "xm2": 1e-10, "tke": 1e-10,
         "ff_colsum": 1e-11}
# Phase d (f32 ensemble column 0 against the f64 column): float32 rounding
# (eps 1.2e-7) over 2 minutes of implicit solves and the Newton loop, and
# float32 contractions that XLA may run in TF32 (10-bit mantissa) at the
# default matmul precision.  Measured on an H100: T 2.1e-6, xm1 2.7e-5,
# xm2 1.4e-4, tke 6.5e-4, ff column sums 2.6e-5; limits about 10 times that.
TOL_D = {"T": 2e-5, "xm1": 3e-4, "xm2": 1.5e-3, "tke": 5e-3,
         "ff_colsum": 3e-4}
# Phase k: max |kernel - XLA| in f64 (both sum the walk times in another
# order; 2.2e-11 measured on an H100), and max |kernel f32 - XLA f64| on
# contents in [0, 1] (float32 rounding of the walk times and the Bott
# polynomial; 1.5e-5 measured on an H100 at 896,000 rows, where the XLA
# form in float32 is 0.15 off).
TOL_K64 = 1e-10
TOL_K32 = 1e-4


def log(msg=""):
    print(msg, flush=True)


def rel_diff(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def fields(state):
    """The compared fields of one column."""
    return {"T": state.met.t, "xm1": state.met.xm1, "xm2": state.met.xm2,
            "tke": state.met.tke,
            "ff_colsum": jnp.sum(state.micro.ff, axis=(-3, -2))}


def compare(label, got, ref, tol):
    worst = {}
    for k in tol:
        d = rel_diff(got[k], ref[k])
        worst[k] = d
        log(f"  {label} {k:10s} max rel diff {d:.3e}  (tolerance {tol[k]:.0e})")
    bad = {k: d for k, d in worst.items() if not d <= tol[k]}
    if bad:
        raise AssertionError(f"{label}: outside tolerance: {bad}")


def check_physical(label, t, xm1, tke, ff=None):
    t, xm1, tke = (np.asarray(x) for x in (t, xm1, tke))
    assert np.all(np.isfinite(t)) and np.all((t > 200) & (t < 330)), label
    assert np.all(np.isfinite(xm1)) and np.all((xm1 >= 0) & (xm1 < 0.05)), \
        label
    assert np.all(np.isfinite(tke)) and np.all(tke >= 1e-6), label
    if ff is not None:
        ff = np.asarray(ff)
        assert np.all(np.isfinite(ff)) and np.all(ff >= -1e-10), label
    log(f"  {label}: T {t.min():.2f}..{t.max():.2f} K, xm1 max "
        f"{xm1.max():.3e}, tke max {tke.max():.4f} — finite and physical")


def btz96_namelist(path):
    """The BTZ96 settings in the reference's namelist format."""
    with open(path, "w") as f:
        f.write("&mistra_cfg\n"
                " rst = F, lstmax = 1, netcdf = F, binout = F,\n"
                " mic = T, chem = F, tw = 288.15, zinv = 800.,\n"
                " dtinv = 7., ug = 8.5, vg = 0., nwProfOpt = 1,\n"
                " wmax = -0.005, z0 = 0.0001, alat = 55.\n"
                "/\n")
    return path


# --------------------------------------------------------------------------

def phase_a():
    log("== a. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    dev = jax.devices()[0]
    log(f"  nvidia-smi: {smi}")
    log(f"  jax {jax.__version__}, device_kind {dev.device_kind}, "
        f"{len(jax.devices())} device(s)")
    return smi


def phase_b(inpdir, minutes=3, grid=None):
    log("== b. CLI path (f64, BTZ96 namelist)")
    from mistra_tpu import cli
    from mistra_tpu.io import netcdf as ncio
    work = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(REPO, "build"))
    nl = btz96_namelist(os.path.join(work, "namelist.BTZ96"))
    outdir = os.path.join(work, "out")
    argv = ["--namelist", nl, "--outdir", outdir, "--minutes", str(minutes)]
    if grid:
        argv += ["--grid", grid]
    old = os.environ.get("INPDIR")
    os.environ["INPDIR"] = inpdir
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        if old is None:
            os.environ.pop("INPDIR")
        else:
            os.environ["INPDIR"] = old
    log(f"  cli.main returned {rc} after {time.perf_counter() - t0:.1f} s "
        f"(init, compile and {minutes} minutes)")
    assert rc == 0
    with open(os.path.join(outdir, "tima.out")) as f:
        lines = f.read().splitlines()
    assert len(lines) == minutes, lines
    snap = "meteo.nc" if ncio.available() else "snapshot_00000.npz"
    assert os.path.exists(os.path.join(outdir, snap)), snap
    restart = os.path.join(outdir, "restart", "state.npz")
    with np.load(restart) as data:
        leaf = {str(k): data[f"{i:04d}"]
                for i, k in enumerate(data["__keys__"])}
    check_physical("restart state", leaf[".met.t"], leaf[".met.xm1"],
                   leaf[".met.tke"], leaf[".micro.ff"])
    assert float(leaf[".tim.time"]) == 60.0 * minutes
    log(f"  tima.out {len(lines)} lines, {snap} and restart/state.npz "
        f"written")


def run_column(model, state, device, minutes):
    state = jax.device_put(state, device)
    step = jax.jit(model.minute_step)
    for _ in range(minutes):
        state = step(state)
    return jax.block_until_ready(state)


def phase_c(inpdir, gpu, minutes=2, overrides=None):
    log("== c. GPU against CPU (f64 column, same configuration)")
    from mistra_tpu.model import Model
    from mistra_tpu.utils import loop_stats
    model = Model(MistraConfig(inpdir=inpdir,
                               **{**BTZ96, **(overrides or {})}))
    state0 = model.init_state()
    cpu = jax.devices("cpu")[0]
    counts = {}
    for label, dev in (("gpu", gpu), ("cpu", cpu)):
        with loop_stats.counting() as c:
            t0 = time.perf_counter()
            out = run_column(model, state0, dev, minutes)
            jax.effects_barrier()
            log(f"  {label}: {minutes} minutes in "
                f"{time.perf_counter() - t0:.1f} s (compile included)")
        counts[label] = {k: [int(np.max(v)) for v in vs]
                         for k, vs in c.items()}
        if label == "gpu":
            gpu_out = out
        else:
            cpu_out = out
    for label, c in counts.items():
        for k, v in sorted(c.items()):
            per_min = len(v) // minutes
            log(f"  while-loop trips ({label}) {k}: {sum(v) / minutes:.1f} per "
                f"minute step over {per_min} loops/minute; per loop {v}")
    check_physical("gpu column", gpu_out.met.t, gpu_out.met.xm1,
                   gpu_out.met.tke, gpu_out.micro.ff)
    assert float(gpu_out.tim.time) == 60.0 * minutes
    compare("gpu vs cpu", fields(gpu_out), fields(cpu_out), TOL_C)
    return model, state0, gpu_out


def phase_d(inpdir, gpu, ref64, minutes=2, batch=BATCH, overrides=None,
            reps=3):
    log(f"== d. ensemble: jit(vmap(minute_step)) over {batch} f32 columns")
    from mistra_tpu.model import Model
    from mistra_tpu.parallel.mesh import replicate_state
    from mistra_tpu.utils.profiling import device_busy
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from profile_step import component_times

    model = Model(MistraConfig(dtype="float32", inpdir=inpdir,
                               **{**BTZ96, **(overrides or {})}))
    log(f"  default matmul precision: "
        f"{jax.config.jax_default_matmul_precision or 'default'} (f32 "
        f"contractions may run in TF32)")
    ens = jax.device_put(replicate_state(model.init_state(), batch), gpu)
    t_in = float(ens.tim.time[0])
    step = jax.jit(jax.vmap(model.minute_step), donate_argnums=0)
    t0 = time.perf_counter()
    compiled = step.lower(ens).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")

    for _ in range(minutes):
        ens = compiled(ens)
    jax.block_until_ready(ens)
    col0 = jax.tree.map(lambda x: x[0], ens)
    compare("f32 col0 vs f64", fields(col0), fields(ref64), TOL_D)
    # identical inputs: columns differ only where a reduction's order
    # depends on the column (atomics), i.e. at float32 rounding level
    spread = max(rel_diff(v, jnp.broadcast_to(v[:1], v.shape))
                 for v in fields(ens).values())
    log(f"  max rel |column - column 0| over the compared fields: "
        f"{spread:.3e} (tolerance 1e-5)")
    assert spread <= 1e-5, "columns of identical inputs differ"

    n_time = 5
    t0 = time.perf_counter()
    for _ in range(n_time):
        ens = compiled(ens)
    jax.block_until_ready(ens)
    dt = (time.perf_counter() - t0) / n_time
    log(f"  warm: {dt:.4f} s per minute step for {batch} columns "
        f"({batch / dt:.2f} column-minutes/s)")
    expect = t_in + 60.0 * (minutes + n_time)
    assert abs(float(ens.tim.time[0]) - expect) < 1e-3, \
        (float(ens.tim.time[0]), expect)
    assert bool(jnp.all(ens.tim.time == ens.tim.time[0]))

    trace_dir = tempfile.mkdtemp(prefix="trace_",
                                 dir=os.path.join(REPO, "build"))
    jax.profiler.start_trace(trace_dir)
    for _ in range(2):
        ens = compiled(ens)
    jax.block_until_ready(ens)
    jax.profiler.stop_trace()
    for plane, b in device_busy(trace_dir).items():
        log(f"  trace of 2 steps, {plane}: busy {b['busy_s']:.4f} s of a "
            f"{b['window_s']:.4f} s window, idle share "
            f"{b['idle_share']:.3f} ({b['events']} events)")
    check_physical("ensemble col 0", ens.met.t[0], ens.met.xm1[0],
                   ens.met.tke[0], ens.micro.ff[0])

    stats = gpu.memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"bytes_limit {stats.get('bytes_limit')}")
    del ens
    split = component_times(model, jax.device_put(
        replicate_state(model.init_state(), batch), gpu), reps)
    for name, s in split.items():
        log(f"  component {name:12s} {s * 1e3:10.2f} ms per call "
            f"(x6 per minute except partdep, radiation)")
    return dt


def phase_e(gpu, cells=2048, m_aq=80, m_gas=100, nbin=4):
    log("== e. batched_inv (f64) at the tot block shapes")
    from mistra_tpu.chemistry.block_solver import batched_inv
    rng = np.random.default_rng(0)
    inv = jax.jit(batched_inv)
    for label, n, m in (("aqueous", cells * nbin, m_aq),
                        ("gas core", cells, m_gas)):
        # diagonally dominant, then rows scaled to unit max norm (the
        # solver's power-of-2 row equilibration)
        a = rng.uniform(-1.0, 1.0, (n, m, m)) + 0.5 * m * np.eye(m)
        a /= np.abs(a).max(axis=2, keepdims=True)
        cond = np.linalg.cond(a[:16]).max()
        a_dev = jax.device_put(a, gpu)
        x = inv(a_dev).block_until_ready()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            inv(a_dev).block_until_ready()
            times.append(time.perf_counter() - t0)
        x = np.asarray(x)
        resid = np.abs(np.einsum("bij,bjk->bik", a, x) - np.eye(m)).max()
        diff = np.abs(x - np.linalg.inv(a)).max()
        # backward-stable LU: |A X - I| ~ m * eps * cond
        bound = 100.0 * m * np.finfo(np.float64).eps * cond
        log(f"  {label}: {n} x {m}x{m}, cond <= {cond:.2f}, median "
            f"{np.median(times) * 1e3:.3f} ms, max|AX-I| {resid:.2e} "
            f"(bound {bound:.1e}), max|X-X_numpy| {diff:.2e}")
        assert resid < bound and diff < bound, (label, resid, diff, bound)


def phase_k(gpu, rows64=112_000, rows32=896_000, nkt=70, band=32,
            interpret=False):
    log("== k. Bott advection kernels against the banded XLA form")
    from mistra_tpu.physics.bott_triton import bott_advect_gpu
    from mistra_tpu.physics.growth import _bott_xla
    rng = np.random.default_rng(0)

    def fields(rows, dtype):
        z = rng.uniform(0.0, 1.0, (rows, nkt)).astype(dtype)
        u = rng.uniform(-2.0, 2.0, (rows, nkt)).astype(dtype)
        u[rng.uniform(size=u.shape) < 0.1] = 0.0
        u[::97] *= 8.0                    # walks longer than the band
        return jax.device_put(u, gpu), jax.device_put(z, gpu)

    kern = jax.jit(lambda u, z: bott_advect_gpu(u, z, dt=10.0, band=band,
                                                interpret=interpret))
    xla = jax.jit(lambda u, z: _bott_xla(10.0, u, z, band, "banded"))
    u, z = fields(rows64, np.float64)
    got, want = np.asarray(kern(u, z)), np.asarray(xla(u, z))
    d = np.abs(got - want).max()
    # f64: the two forms sum the walk times in a different order (~1e-16
    # relative), which moves a stop position by as much
    log(f"  f64, {rows64} x {nkt} rows: max |kernel - XLA| {d:.2e} "
        f"(tolerance {TOL_K64:.0e}), mass change "
        f"{np.abs(got.sum(1) - want.sum(1)).max():.2e}")
    assert d < TOL_K64

    # f32 (the ensemble's dtype): both forms against the f64 XLA form of
    # the same inputs, advected in chunks of rows64 rows
    u, z = fields(rows32, np.float32)
    u64, z64 = np.asarray(u, np.float64), np.asarray(z, np.float64)
    ref = np.concatenate([
        np.asarray(xla(jax.device_put(u64[r:r + rows64], gpu),
                       jax.device_put(z64[r:r + rows64], gpu)))
        for r in range(0, rows32, rows64)])
    err = {}
    for name, f in (("kernels", kern), ("XLA banded", xla)):
        err[name] = np.abs(np.asarray(f(u, z), np.float64) - ref).max()
        log(f"  f32, {rows32} x {nkt} rows, {name:10s}: max |f32 - f64| "
            f"{err[name]:.2e} (contents in [0, 1])")
    assert err["kernels"] < TOL_K32, err
    for name, f in (("XLA banded", xla), ("kernels", kern),
                    ("kernels", kern), ("XLA banded", xla)):
        jax.block_until_ready(f(u, z))
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f(u, z))
            t.append(time.perf_counter() - t0)
        log(f"  f32, {rows32} x {nkt} rows, {name:10s}: median "
            f"{np.median(t) * 1e3:.3f} ms")


def four_gpus(inpdir, batch=BATCH, minutes=2, overrides=None):
    log(f"== four GPUs: dp ensemble of 4 x {batch} columns")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mistra_tpu.model import Model
    from mistra_tpu.parallel import mesh as pmesh
    n_dev = 4
    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} GPUs, found {len(devs)}"
    model = Model(MistraConfig(dtype="float32", inpdir=inpdir,
                               **{**BTZ96, **(overrides or {})}))
    state = model.init_state()
    ens = pmesh.replicate_state(state, n_dev * batch)
    # perturbed initial temperatures make every column distinct
    dtemp = jnp.linspace(0.0, 0.5, n_dev * batch, dtype=ens.met.t.dtype)
    ens = ens.replace(met=ens.met.replace(t=ens.met.t + dtemp[:, None]))
    host = jax.device_get(ens)

    mesh = pmesh.make_mesh(n_dev)
    sharded = pmesh.shard_state(host, mesh)
    step4 = pmesh.make_ensemble_step(model, mesh, donate=False)
    t0 = time.perf_counter()
    out4 = jax.block_until_ready(step4(sharded))
    log(f"  4-GPU compile + first step {time.perf_counter() - t0:.1f} s")
    for _ in range(minutes - 1):
        out4 = step4(out4)
    jax.block_until_ready(out4)
    shard_devs = {s.device for s in out4.micro.ff.addressable_shards}
    log(f"  ff shards on {sorted(str(d) for d in shard_devs)}")
    assert len(shard_devs) == n_dev
    assert out4.micro.ff.sharding.is_equivalent_to(
        NamedSharding(mesh, P("dp")), 4)
    t0 = time.perf_counter()
    out4 = jax.block_until_ready(step4(out4))
    dt4 = time.perf_counter() - t0

    step1 = jax.jit(jax.vmap(model.minute_step))
    worst = {}
    dt1 = None
    for q in range(n_dev):
        part = jax.device_put(jax.tree.map(
            lambda x: x[q * batch:(q + 1) * batch], host), devs[0])
        for _ in range(minutes + 1):
            t0 = time.perf_counter()
            part = jax.block_until_ready(step1(part))
        dt1 = time.perf_counter() - t0
        for k, v in fields(part).items():
            got = fields(out4)[k][q * batch:(q + 1) * batch]
            worst[k] = max(worst.get(k, 0.0), rel_diff(got, v))
    for k, d in worst.items():
        log(f"  4-GPU vs 1-GPU per column {k:10s} max rel diff {d:.3e} "
            f"(tolerance 1e-6: same program per column, other batch split)")
        assert d <= 1e-6, (k, d)
    log(f"  minute step: {dt4:.4f} s for {n_dev * batch} columns on 4 GPUs, "
        f"{dt1:.4f} s for {batch} columns on 1 GPU")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-GPU dp ensemble and its comparison")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform}")
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    inpdir = os.environ.get("INPDIR") or ensure_synthetic_inputs()
    log(f"input tables: {inpdir}")
    smi = phase_a()
    t_all = time.perf_counter()
    if args.four:
        four_gpus(inpdir)
    else:
        gpu = devs[0]
        phase_b(inpdir)
        _, _, ref64 = phase_c(inpdir, gpu)
        phase_d(inpdir, gpu, ref64)
        phase_e(gpu)
        phase_k(gpu)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
