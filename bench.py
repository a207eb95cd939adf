"""Benchmark: ensemble column-model throughput on one GPU.

Runs each stage in a child process, one at a time; this parent never
imports JAX.  Each stage prints one JSON line naming the device it ran on.

Stages:
  btz96     full-physics column model steps per second: one step is one
            outer minute of the operator-splitting schedule (6 x 10-s
            substeps of diffusion + MY2.5 closure, Koehler/condensation
            growth over the 70x70 bin spectrum with Bott advection,
            sedimentation, surface balance) plus the 18-band PIFM2
            radiation call, for 128 independent float32 columns of the
            BTZ96 radiation-fog configuration (namelist.BTZ96: chem=F,
            mic=T).  vs_baseline divides by a single unbatched column on
            the host CPU, the stand-in for the reference's serial
            one-column execution.  Input tables: INPDIR, else the
            generated tables (io/synthetic_inputs.py), and the line says
            which.
  chem_tot  multiphase chemistry cell-substeps/s (benchmarks/bench_chem.py)
  native    serial native sparse-LU baseline (benchmarks/bench_chem_native.py)
  tot_full  production multiphase column (benchmarks/smoke_tot_full.py)

The chemistry stages need the reference mechanism (MECHDIR); without it
each says so by name and is skipped.  A stage that fails, or a missing
GPU, makes the script exit non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _child_btz96(batch: int, n_steps: int):
    """Measure in-process and print one JSON result line."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from mistra_tpu.config import BTZ96, MistraConfig
    from mistra_tpu.io.synthetic_inputs import ensure_synthetic_inputs
    from mistra_tpu.model import Model
    from mistra_tpu.parallel.mesh import replicate_state
    from mistra_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform}")
    configure_compile_cache()
    inpdir = os.environ.get("INPDIR") or ensure_synthetic_inputs()
    model = Model(MistraConfig(dtype="float32", inpdir=inpdir, **BTZ96))
    state = model.init_state()
    ensemble = jax.device_put(replicate_state(state, batch), dev)
    step = jax.jit(jax.vmap(model.minute_step), donate_argnums=(0,))

    t_in = float(ensemble.tim.time[0])
    out = jax.block_until_ready(step(ensemble))      # compile + warm
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = step(out)
    jax.block_until_ready(out)
    dt_ens = (time.perf_counter() - t0) / n_steps

    # validation canaries: the program really ran and stayed finite
    finite = bool(jnp.all(jnp.isfinite(out.met.t))) and \
        bool(jnp.all(jnp.isfinite(out.micro.ff)))
    t_out = float(out.tim.time[0])
    expect = t_in + 60.0 * (n_steps + 1)
    if not finite or abs(t_out - expect) > 1.0:
        raise SystemExit(f"bench: validation failed: finite={finite} "
                         f"time={t_out} expect={expect}")

    # serial single-column baseline on the host CPU
    cpu = jax.devices("cpu")[0]
    cpu_step = jax.jit(model.minute_step)
    s = jax.block_until_ready(cpu_step(jax.device_put(state, cpu)))
    t0 = time.perf_counter()
    for _ in range(2):
        s = cpu_step(s)
    jax.block_until_ready(s)
    dt_one = (time.perf_counter() - t0) / 2

    print(json.dumps({
        "metric": "btz96_column_steps_per_s",
        "value": batch / dt_ens, "unit": "column-minutes/s",
        "vs_baseline": (batch / dt_ens) * dt_one,
        "ms_per_step": dt_ens * 1000.0, "batch": batch,
        "inputs": "synthetic" if os.path.exists(os.path.join(
            inpdir, "SYNTHETIC_INPUTS")) else inpdir,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}))


def _mechdir() -> str:
    sys.path.insert(0, ROOT)
    from mistra_tpu.config import MistraConfig
    return MistraConfig(chem=False).mechdir


def _run(name, cmd, timeout):
    """Run one stage; its last stdout line is its JSON result."""
    print(f"bench: stage {name}: {' '.join(cmd[1:])}", file=sys.stderr,
          flush=True)
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    sys.stderr.write(out.stderr[-4000:])
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise SystemExit(f"bench: stage {name} failed (rc={out.returncode})")
    print(lines[-1], flush=True)
    return json.loads(lines[-1])


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--child-btz96":
        _child_btz96(batch=int(sys.argv[2]), n_steps=int(sys.argv[3]))
        return

    py = sys.executable
    _run("btz96", [py, os.path.abspath(__file__), "--child-btz96", "128",
                   "10"], timeout=1800)

    mechdir = _mechdir()
    if not os.path.isdir(mechdir):
        for name in ("chem_tot", "native", "tot_full"):
            print(f"bench: skipping stage {name}: reference mechanism not "
                  f"found at {mechdir} (set MECHDIR)", file=sys.stderr)
        return
    bdir = os.path.join(ROOT, "benchmarks")
    _run("chem_tot", [py, os.path.join(bdir, "bench_chem.py"), "--mech",
                      "tot", "--cells", "2048", "--dtype", "float32",
                      "--reps", "3"], timeout=1800)
    _run("native", [py, os.path.join(bdir, "bench_chem_native.py"),
                    "--mech", "tot", "--cells", "200"], timeout=600)
    _run("tot_full", [py, os.path.join(bdir, "smoke_tot_full.py"),
                      "--minutes", "1"], timeout=1800)


if __name__ == "__main__":
    main()
