"""The GPU smoke test's phases (chip_smoke.py) rehearsed on the CPU at a
tiny grid: paths, arguments, checks and control flow, not device numbers.
The script itself refuses to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from mistra_tpu.config import GridParams
from mistra_tpu.paths import REPO_ROOT

sys.path.insert(0, REPO_ROOT)
import chip_smoke  # noqa: E402

TINY = dict(grid=GridParams(nf=12, n_extra=6, nka=8, nkt=8, nb=8),
            zinv=100.0)


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def ref64(synthetic_inpdir, cpu):
    _, _, out = chip_smoke.phase_c(synthetic_inpdir, cpu, overrides=TINY)
    return out


def test_phase_b_cli(synthetic_inpdir, capsys):
    chip_smoke.phase_b(synthetic_inpdir, minutes=3,
                       grid="nf=12,n_extra=6,nka=8,nkt=8,nb=8,zinv=100")
    out = capsys.readouterr().out
    assert "SYNTHETIC input tables" in out
    assert "output: " in out


def test_phase_c_counts_loops(ref64, capsys, synthetic_inpdir, cpu):
    chip_smoke.phase_c(synthetic_inpdir, cpu, minutes=1, overrides=TINY)
    out = capsys.readouterr().out
    assert "while-loop trips (gpu) kon_newton" in out
    assert "while-loop trips (cpu) sedp_courant" in out
    assert float(ref64.tim.time) == 120.0


def test_phase_d_ensemble(synthetic_inpdir, cpu, ref64, capsys):
    chip_smoke.phase_d(synthetic_inpdir, cpu, ref64, batch=2,
                       overrides=TINY, reps=1)
    out = capsys.readouterr().out
    for name in ("difm", "difp", "kon", "sedp", "equil", "partdep",
                 "radiation"):
        assert f"component {name}" in out


def test_phase_e_inverse(cpu):
    chip_smoke.phase_e(cpu, cells=4, m_aq=23, m_gas=30)


def test_four_device_path(synthetic_inpdir):
    assert len(jax.devices()) >= 4        # conftest's virtual CPU devices
    chip_smoke.four_gpus(synthetic_inpdir, batch=2, overrides=TINY)


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO_ROOT,
                                                     "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_phase_k_kernels(cpu):
    chip_smoke.phase_k(cpu, rows64=40, rows32=40, interpret=True)
