"""Native C++ async netCDF writer (native/mistra_io.cpp) round-trip."""

import numpy as np
import pytest

from mistra_tpu.io import netcdf as ncio


@pytest.fixture(autouse=True)
def _native_writer():
    """Skip where the native library cannot be built or loaded."""
    if not ncio.available():
        pytest.skip(f"native netCDF writer unavailable: {ncio._LIB_ERR!r}")


def test_roundtrip_async(tmp_path):
    path = str(tmp_path / "rt.nc")
    f = ncio.NcFile(path)
    f.def_dim("time", None)
    f.def_dim("n", 7)
    f.def_dim("m", 3)
    f.def_var("a", ("time", "m", "n"), units="K")
    f.def_var("t", ("time",), units="s")
    f.enddef()
    rng = np.random.default_rng(0)
    slabs = [rng.standard_normal((3, 7)) for _ in range(5)]
    for r, s in enumerate(slabs):
        f.put("a", s, record=r)          # async path
        f.put("t", np.float64(r), record=r)
    f.drain()
    f.close()

    r = ncio.NcReader(path)
    assert r.dimlen("time") == 5
    got = r.get("a", (5, 3, 7))
    np.testing.assert_allclose(got, np.stack(slabs))
    np.testing.assert_allclose(r.get("t", (5,)), np.arange(5.0))
    r.close()


def test_classic_format_magic(tmp_path):
    # files must stay readable by reference tooling (NCL reads CDF-2)
    path = str(tmp_path / "fmt.nc")
    f = ncio.NcFile(path)
    f.def_dim("n", 2)
    f.def_var("x", ("n",))
    f.enddef()
    f.put("x", np.array([1.0, 2.0]), async_=False)
    f.close()
    with open(path, "rb") as fh:
        magic = fh.read(4)
    assert magic[:3] == b"CDF"


def test_output_writer_mic(tmp_path, synthetic_inpdir):
    """Full writer with microphysics on: regression for the two-unlimited-
    dims bug (classic netCDF allows one per file) and the ff/part1D
    dimension-order mismatches."""
    from mistra_tpu.config import GridParams, MistraConfig
    from mistra_tpu.model import Model

    cfg = MistraConfig(chem=False, mic=True, dtype="float32",
                       inpdir=synthetic_inpdir,
                       grid=GridParams(nf=8, n_extra=4, nka=8, nkt=8, nb=4),
                       zinv=60.0, tw=288.15, dtinv=7.0, ug=8.5, vg=0.0,
                       nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
    model = Model(cfg)
    model.radiation_enabled = False
    state = model.init_state()
    w = ncio.NetCDFOutputWriter(str(tmp_path), model)
    w.snapshot(state, particles=True)
    w.snapshot(state, particles=False)
    w.close()

    n = cfg.grid.n
    r = ncio.NcReader(str(tmp_path / "mic.nc"))
    assert r.dimlen("time") == 2
    fsum = r.get("fsum", (2, n))
    np.testing.assert_allclose(fsum[0], np.asarray(state.micro.fsum),
                               rtol=1e-6)
    r.close()
    rp = ncio.NcReader(str(tmp_path / "part.nc"))
    assert rp.dimlen("time") == 1
    ff = rp.get("ff", (1, cfg.grid.nkt, cfg.grid.nka, n))
    np.testing.assert_allclose(ff[0], np.asarray(state.micro.ff),
                               rtol=1e-6)
    rp.close()
