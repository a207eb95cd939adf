"""Profiling subsystem (utils/profiling.py; SURVEY.md §5.1)."""

import jax
import jax.numpy as jnp

import pytest

from mistra_tpu.utils.profiling import (KernelCost, Roofline, annotate,
                                        benchmark, device_peaks,
                                        model_costs, trace)


def test_benchmark_and_annotate():
    @jax.jit
    def f(x):
        with annotate("double"):
            return x * 2.0

    x = jnp.ones((64, 64))
    per_iter, compile_s = benchmark(f, x, iters=3)
    assert per_iter > 0.0 and compile_s >= per_iter


def test_roofline_report():
    r = Roofline(peak_flops=1e12, peak_bw=1e11)
    r.add(KernelCost("k", flops=1e9, bytes=1e6))
    rep = r.report("k", wall_s=1e-2, batch=10)
    assert abs(rep["achieved_tflops"] - 1.0) < 1e-9
    assert rep["bound"] == "compute"          # intensity 1000 > 10
    assert abs(rep["pct_peak_flops"] - 100.0) < 1e-6


def test_device_peaks_h100_and_unknown():
    pk = device_peaks("NVIDIA H100 80GB HBM3")
    assert pk["fp64"] == 34e12 and pk["tf32"] == 495e12
    assert pk["hbm"] == 3.35e12
    assert pk["fp64_tc"] == 67e12 and pk["fp32"] == 67e12
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("cpu")


def test_roofline_without_peaks_raises():
    r = Roofline()
    r.add(KernelCost("k", flops=1.0, bytes=1.0))
    with pytest.raises(ValueError, match="no peaks"):
        r.report("k", wall_s=1.0)


def test_model_costs_registry():
    from mistra_tpu.config import GridParams, MistraConfig
    cfg = MistraConfig(grid=GridParams(nf=12, n_extra=6, nka=16, nkt=16,
                                       nb=8))
    r = model_costs(cfg)
    for k in ("difm", "difp", "kon", "sedp", "nstrahl"):
        assert k in r.kernels
        assert r.kernels[k].flops > 0


def test_trace_context(tmp_path):
    with trace(str(tmp_path)):
        jnp.sum(jnp.ones((8, 8))).block_until_ready()
    # a trace directory must have been produced
    assert any(tmp_path.iterdir())


def test_device_busy_on_cpu_trace(tmp_path):
    """A CPU trace has no device plane: the reduction returns nothing
    rather than inventing device numbers."""
    from mistra_tpu.utils.profiling import device_busy
    with trace(str(tmp_path)):
        jnp.sum(jnp.ones((8, 8))).block_until_ready()
    assert device_busy(str(tmp_path)) == {}
    import pytest
    with pytest.raises(FileNotFoundError):
        device_busy(str(tmp_path / "missing"))
