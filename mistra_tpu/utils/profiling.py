"""Tracing / profiling subsystem (SURVEY.md §5.1).

The reference has no built-in profiling beyond a per-minute progress line
(str.f90:516-531) and compiler-flag builds; this framework makes
observability first-class:

- ``trace(logdir)``: capture a ``jax.profiler`` device trace of any code
  block (viewable in TensorBoard / Perfetto).
- ``annotate(name)``: named scope that shows up in traces, so each physics
  operator (difm, kon, sedp, nstrahl, kpp) is attributable on the timeline.
- ``Roofline``: analytic per-kernel FLOP/byte cost model from the grid
  dimensions, used with measured wall time to report achieved fraction of
  the device's peak compute / memory bandwidth (``device_peaks``).
- ``benchmark(fn, args)``: block-until-ready timing harness with compile
  time split out.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import jax

# Roofline denominators per device, keyed by ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 part, dense rates
# (no sparsity) at the full 700 W power limit.  FLOP/s per precision:
# fp64 (CUDA cores), fp64_tc (tensor cores), fp32, tf32 (tensor cores),
# bf16 (tensor cores); hbm in bytes/s.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp64": 34e12, "fp64_tc": 67e12, "fp32": 67e12, "tf32": 495e12,
        "bf16": 989e12, "hbm": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Published peak rates of a device; an unknown device is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add them "
            f"to DEVICE_PEAKS with their source") from None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope visible in profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


def benchmark(fn, *args, iters: int = 10, warmup: int = 1):
    """Time a jitted callable: returns (seconds/iter, compile_seconds).

    The first call (compile + run) is measured separately; steady-state
    timing blocks on the final result only, letting XLA pipeline steps.
    """
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, compile_s


@dataclass
class KernelCost:
    """Analytic cost of one kernel invocation."""
    name: str
    flops: float
    bytes: float

    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


@dataclass
class Roofline:
    """Roofline bookkeeping: register analytic kernel costs, then report
    achieved compute / bandwidth fractions from measured wall time.

    The peaks come from ``device_peaks`` or are given explicitly;
    ``report`` refuses to run without them.
    """
    peak_flops: float | None = None
    peak_bw: float | None = None
    kernels: dict = field(default_factory=dict)

    def add(self, cost: KernelCost):
        self.kernels[cost.name] = cost

    def report(self, name: str, wall_s: float, batch: int = 1) -> dict:
        if self.peak_flops is None or self.peak_bw is None:
            raise ValueError("Roofline has no peaks; take them from "
                             "device_peaks(device_kind)")
        c = self.kernels[name]
        flops = c.flops * batch
        byts = c.bytes * batch
        bound = "compute" if c.intensity() > self.peak_flops / self.peak_bw \
            else "memory"
        return {
            "kernel": name,
            "wall_s": wall_s,
            "achieved_tflops": flops / wall_s / 1e12,
            "pct_peak_flops": 100.0 * flops / wall_s / self.peak_flops,
            "achieved_gbps": byts / wall_s / 1e9,
            "pct_peak_bw": 100.0 * byts / wall_s / self.peak_bw,
            "arithmetic_intensity": c.intensity(),
            "bound": bound,
        }


def model_costs(cfg, dtype_bytes: int = 4) -> Roofline:
    """Analytic per-minute-step costs for the main physics operators,
    derived from the survey's cost-model facts (SURVEY.md §6): chemistry
    Fun/Jac/LU sizes, radiation 121 (ig,ib) quadrature points x layers,
    growth iterations over the (nkt, nka) spectrum."""
    g = cfg.grid
    n, nf, nka, nkt = g.n, g.nf, g.nka, g.nkt
    r = Roofline()
    nsub = 6
    # difm/difc/difp: tridiagonal sweeps, ~10 flops/cell/sweep
    r.add(KernelCost("difm", 5 * 10 * n * nsub, 5 * 3 * n * dtype_bytes))
    r.add(KernelCost("difp", 10 * nka * nkt * n * nsub,
                     nka * nkt * n * dtype_bytes * 2))
    # kon/subkon: <=10 Newton iterations x spectrum x levels per substep
    r.add(KernelCost("kon", 10 * 40 * nka * nkt * nf * nsub,
                     nka * nkt * n * dtype_bytes * 4))
    # sedp: Courant-split advection over the spectrum
    r.add(KernelCost("sedp", 3 * 20 * nka * nkt * nf * nsub,
                     nka * nkt * n * dtype_bytes * 2))
    # radiation: 121 quadrature points x 18 bands worth of layer recursions
    nrlay = n + 10
    r.add(KernelCost("nstrahl", 121 * nrlay * 60.0,
                     121 * nrlay * dtype_bytes * 6))
    return r


# derived timelines the profiler adds beside the per-stream kernel lines
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework Name Scope",
                  "Framework Ops", "Source code", "Launch Stats")


def device_busy(trace_dir: str) -> dict:
    """Busy and idle time of each device in a ``jax.profiler`` trace.

    Busy is the union of the intervals of the events on the device's
    stream lines (kernels and copies); the window runs from the first
    event's start to the last event's end on that device, and the idle
    share is 1 - busy / window.  Host time before the first or after the
    last device event is not in the window.  Returns
    {plane name: {"busy_s", "window_s", "idle_share", "events"}}; an
    empty dict when the trace holds no device plane (a CPU run).
    """
    import glob
    import os
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if "Stream" in ln.name] or \
            [ln for ln in lines if ln.name not in _DERIVED_LINES]
        spans = sorted((ev.start_ns, ev.end_ns) for ln in streams
                       for ev in ln.events)
        if not spans:
            continue
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        out[plane.name] = {"busy_s": busy * 1e-9, "window_s": window * 1e-9,
                           "idle_share": 1.0 - busy / window if window
                           else 0.0, "events": len(spans)}
    return out


def print_report(rows):
    for row in rows:
        print(json.dumps(row))
