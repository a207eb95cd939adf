"""Per-component timing of the minute step on the GPU.

Usage: python benchmarks/profile_step.py [batch] [reps]

Times each physics component of the substep separately (compiled, warm,
``block_until_ready``), then the whole substep and minute step, for a
float32 BTZ96 ensemble of ``batch`` columns.  Reads the input tables from
``INPDIR``, else uses the generated tables (io/synthetic_inputs.py).
Exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timeit(fn, state, reps):
    out = fn(state)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(state)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def component_times(model, ens, reps: int = 3) -> dict:
    """{component: seconds per call} for the vmapped substep components
    (difm, difp, kon, sedp, equil, partdep, radiation), their sum, the
    whole substep and the minute step, each compiled separately."""
    from mistra_tpu.physics import diffusion, growth, microphysics
    from mistra_tpu.physics import sedimentation

    cfg = model.cfg
    atm = model.atm
    a0m = model.consts["a0m"]
    b0m = jnp.asarray(model.consts["b0m"])

    def f_difm(s):
        met, turb, kinv = diffusion.difm(s.met, s.turb, s.surf, s.micro,
                                         atm, 10.0, cfg.ug, cfg.vg)
        return met.t, met.tke, turb.atkh

    def f_difp(s):
        return diffusion.difp(s.micro, s.met, s.turb, atm, 10.0).ff

    def f_kon(s):
        return growth.kon(model, s, 10.0).micro.ff

    def f_sedp(s):
        return sedimentation.sedp(model, s, 10.0).micro.ff

    def f_equil(s):
        met, mic = microphysics.equil(s.met, s.micro, model.grids.micro,
                                      a0m, b0m, ncase=2, nf=cfg.grid.nf)
        return met.t, mic.ff

    def f_partdep(s):
        return sedimentation.partdep(model, s)

    def f_rad(s):
        return model._radiation(s, init=False).rad.dtrad

    parts = [("difm", f_difm), ("difp", f_difp), ("kon", f_kon),
             ("sedp", f_sedp), ("equil", f_equil), ("partdep", f_partdep),
             ("radiation", f_rad)]
    out = {}
    for name, f in parts:
        out[name] = timeit(jax.jit(jax.vmap(f)), ens, reps)
    out["sum(parts)"] = sum(out.values())
    out["substep"] = timeit(jax.jit(jax.vmap(
        lambda s: model.substep(s, 10.0))), ens, reps)
    out["minute_step"] = timeit(jax.jit(jax.vmap(model.minute_step)), ens,
                                reps)
    return out


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    from mistra_tpu.config import BTZ96, MistraConfig
    from mistra_tpu.io.synthetic_inputs import ensure_synthetic_inputs
    from mistra_tpu.model import Model
    from mistra_tpu.parallel.mesh import replicate_state
    from mistra_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"profile_step: needs a GPU, found {dev.platform}")
    configure_compile_cache()
    inpdir = os.environ.get("INPDIR") or ensure_synthetic_inputs()
    model = Model(MistraConfig(dtype="float32", inpdir=inpdir, **BTZ96))
    ens = jax.device_put(replicate_state(model.init_state(), batch), dev)
    print(f"device={dev.device_kind}, batch={batch}, reps={reps}")
    for name, dt in component_times(model, ens, reps).items():
        print(f"{name:28s} {dt * 1000.0:10.2f} ms")


if __name__ == "__main__":
    main()
