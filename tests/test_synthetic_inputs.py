"""Generated input tables (io/synthetic_inputs.py) read back through the
model's own loaders."""

import os

import numpy as np
import pytest

from mistra_tpu.io import synthetic_inputs as syn
from mistra_tpu.paths import REPO_ROOT
from mistra_tpu.physics.surface import load_clarke_table
from mistra_tpu.radiation import tables as T


def test_clarke_roundtrip(synthetic_inpdir):
    tab = load_clarke_table(synthetic_inpdir)
    assert tab.fu.shape == tab.ft.shape == (18, 7)
    np.testing.assert_allclose(tab.xzpdl, syn.XZPDL)
    np.testing.assert_allclose(tab.xzpdz0, syn.XZPDZ0)
    fu, ft = syn.clarke_functions()
    np.testing.assert_allclose(tab.fu, fu, rtol=1e-7)
    np.testing.assert_allclose(tab.ft, ft, rtol=1e-7)
    # neutral column: the log law u/u* = ln(z/z0) / kappa for both
    neutral = int(np.nonzero(syn.XZPDL == 0.0)[0][0])
    np.testing.assert_allclose(tab.fu[neutral], syn.XZPDZ0 / 0.4)
    np.testing.assert_allclose(tab.ft[neutral], syn.XZPDZ0 / 0.4)
    # drag grows with instability, shrinks with stability
    assert np.all(np.diff(tab.fu, axis=0) > 0)


def test_pifm2_roundtrip(synthetic_inpdir):
    tb = T.load_pifm2(synthetic_inpdir)
    assert sorted(tb.hk) == list(range(1, 19))
    for b in range(1, 19):
        assert tb.hk[b].shape == (T.KG[b - 1],)
        assert abs(tb.hk[b].sum() - 1.0) < 1e-7
        assert np.all(tb.hk[b] > 0)
    assert sum(len(tb.hk[b]) for b in tb.hk) == 121
    assert 1300.0 < tb.s0tot < 1400.0
    assert tb.seanew.shape == (8, T.MB, 4)
    assert tb.b2wt.shape == (T.NCW, T.MB)
    for arr in (tb.seanew, tb.saanew, tb.b2wt, tb.w2wt, tb.s0b, tb.berayl,
                tb.o3un, tb.cgas["fk1o3"]):
        assert np.all(arr >= 0)
    assert np.all(tb.saanew <= tb.seanew)
    assert tb.cgas["c2h2o"].shape == (3, 11, T.KG[1])
    assert tb.cgas["c14hcb"].shape == (3, 19, T.KG[13])
    assert tb.cgas["c10ch4"].shape == (3, 19)
    assert np.all(np.diff(tb.o3un) <= 0)          # column above z


def test_mie_roundtrip(synthetic_inpdir):
    mie = T.load_mie_tables(synthetic_inpdir)
    assert mie.shape == (3, T.MB, len(T.XW0), len(T.XA0), 3)
    qabs, qext, asym = mie[..., 0], mie[..., 1], mie[..., 2]
    assert np.all(qabs >= 0) and np.all(qabs <= qext)
    assert np.all((asym > 0) & (asym < 1))


def test_generation_is_seeded(tmp_path):
    a = syn.write_synthetic_inputs(str(tmp_path / "a"), seed=3)
    b = syn.write_synthetic_inputs(str(tmp_path / "b"), seed=3)
    c = syn.write_synthetic_inputs(str(tmp_path / "c"), seed=4)
    for f in syn.FILES:
        with open(os.path.join(a, f)) as fa, open(os.path.join(b, f)) as fb:
            assert fa.read() == fb.read(), f
    with open(os.path.join(a, "pifm2_171115.dat")) as fa, \
            open(os.path.join(c, "pifm2_171115.dat")) as fc:
        assert fa.read() != fc.read()


def test_announce_only_for_generated_tables(tmp_path, capsys,
                                            synthetic_inpdir):
    assert syn.announce_if_synthetic(synthetic_inpdir)
    assert not syn.announce_if_synthetic(str(tmp_path))
    out = capsys.readouterr().out
    assert str(tmp_path) not in out


def test_default_inpdir_is_not_synthetic(monkeypatch):
    from mistra_tpu.config import MistraConfig
    monkeypatch.delenv("INPDIR", raising=False)
    cfg = MistraConfig(chem=False)
    assert os.path.abspath(cfg.inpdir) != os.path.abspath(syn.DEFAULT_DIR)


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, set_env):
    import jax
    from mistra_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if set_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "unchanged")
            assert compile_cache.configure_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "unchanged"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            d = compile_cache.configure_compile_cache()
            assert d == compile_cache.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == d
            assert d.startswith(REPO_ROOT + os.sep)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_state_dataclass_replace_and_roundtrip():
    import jax
    import jax.numpy as jnp
    from mistra_tpu.state import RadState, TimeState
    tim = TimeState(time=jnp.zeros(()), lday=jnp.int32(1), lst=jnp.int32(2),
                    lmin=jnp.int32(3), kinv=jnp.int32(4))
    t2 = tim.replace(lmin=jnp.int32(9))
    assert int(t2.lmin) == 9 and int(tim.lmin) == 3
    with pytest.raises(Exception):
        tim.lmin = 5                                 # frozen
    leaves, treedef = jax.tree_util.tree_flatten(tim)
    assert len(leaves) == 5
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back == tim
    rad = RadState(dtrad=jnp.ones(3), totrad=jnp.ones((2, 3)), u0=1.0,
                   sk=2.0, sl=3.0)
    out = jax.jit(lambda r: r.replace(u0=r.u0 * 2))(rad)
    assert float(out.u0) == 2.0
    assert [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(rad)[0]][0] == ".dtrad"
