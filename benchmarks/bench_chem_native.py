"""Serial native (C++ -O3) chemistry LU baseline on this host CPU.

Exports the tot mechanism's static sparse-LU structure (the same
symbolic analysis the JAX block solver is built from) to a flat
schedule, compiles native/chem_lu_bench.cpp, and measures
decompose + 3-solve "cell steps" per second on ONE core — the
reference's serial execution model (KppDecomp/KppSolve,
/root/reference/src/tot.f:39468; no Fortran compiler exists in this
image, so g++ on the identical index-array loops is the stand-in).

Usage: python benchmarks/bench_chem_native.py [--mech tot] [--cells 200]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def export_schedule(mech, path):
    from mistra_tpu.chemistry.sparse_lu import (SparseLU,
                                                jac_pattern_from_mech)
    slu = SparseLU(jac_pattern_from_mech(mech), mech.nvar)
    n, nnz = slu.n, slu.nnz
    div, sub = [], []
    for op in slu.schedule:
        if op[0] == "div":
            div.append((op[1], op[2]))
        else:
            sub.append((op[1], op[2], op[3]))
    # forward solve ops: rows ascending, below-diagonal slots
    sl = []
    for i in range(n):
        for j in range(i):
            s = slu.slots.get((i, j))
            if s is not None:
                sl.append((i, j, s))
    # backward: rows descending; divide sentinel when the row completes
    su = []
    for i in range(n - 1, -1, -1):
        for j in range(i + 1, n):
            s = slu.slots.get((i, j))
            if s is not None:
                su.append((i, j, s))
        su.append((i, slu.slots[(i, i)], -1))
    diag = [slu.slots[(i, i)] for i in range(n)]
    # representative values: diagonally dominant (ghinv-shifted stage
    # matrix shape)
    rng = np.random.default_rng(0)
    vals = rng.uniform(-0.1, 0.1, nnz).astype(np.float32)
    for i in range(n):
        vals[diag[i]] = 3.0 + 0.01 * i

    with open(path, "wb") as f:
        f.write(struct.pack("<6i", n, nnz, len(div), len(sub),
                            len(sl), len(su)))
        np.asarray(div, np.int32).tofile(f)
        np.asarray(sub, np.int32).tofile(f)
        np.asarray(sl, np.int32).tofile(f)
        np.asarray(su, np.int32).tofile(f)
        np.asarray(diag, np.int32).tofile(f)
        vals.tofile(f)
    return {"n": n, "nnz": nnz, "n_div": len(div), "n_sub": len(sub)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mech", default="tot", choices=["gas", "tot"])
    ap.add_argument("--cells", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mechdir", default="")
    args = ap.parse_args()

    from mistra_tpu.chemistry.mech import (load_gas_mechanism,
                                           load_multiphase_mechanism)
    from mistra_tpu.config import MistraConfig
    mechdir = args.mechdir or MistraConfig(chem=False).mechdir
    mech = (load_gas_mechanism(mechdir) if args.mech == "gas"
            else load_multiphase_mechanism(mechdir, name="tot"))

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "native", "chem_lu_bench.cpp")
    with tempfile.TemporaryDirectory() as td:
        sched = os.path.join(td, "sched.bin")
        info = export_schedule(mech, sched)
        exe = os.path.join(td, "chem_lu_bench")
        subprocess.run(["g++", "-O3", "-march=native", "-o", exe, src],
                       check=True)
        out = subprocess.run([exe, sched, str(args.cells),
                              str(args.reps)],
                             capture_output=True, text=True, check=True)
        r = json.loads(out.stdout.strip())

    print(json.dumps({
        "metric": f"chem_{args.mech}_native_serial_cell_steps_per_s",
        "value": round(r["cell_steps_per_s"], 1),
        "unit": "cell-steps/s/core",
        "nvar": mech.nvar, **info,
        "note": "decompose + 3 solves per step; g++ -O3 single core "
                "(reference serial execution model)",
    }))


if __name__ == "__main__":
    main()
