"""Device-mesh sharding unit tests (virtual 8-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mistra_tpu.parallel import mesh as pmesh


def test_make_mesh_dp_tp():
    # one "dp" axis: columns are independent, so nothing else is sharded
    mesh = pmesh.make_mesh(n_devices=8)
    assert dict(mesh.shape) == {"dp": 8}
    state = {"ff": jnp.ones((8, 6, 16, 4)), "time": jnp.zeros(())}
    placed = pmesh.shard_state(state, mesh)
    assert placed["ff"].sharding.is_equivalent_to(
        NamedSharding(mesh, P("dp")), 4)
    assert len({s.device for s in placed["ff"].addressable_shards}) == 8
    assert placed["time"].sharding.is_fully_replicated


def test_host_mesh_and_sharding():
    mesh = pmesh.make_host_mesh()
    assert dict(mesh.shape) == {"hosts": 1, "dp": len(jax.devices())}
    x = jnp.ones((8, 6, 16, 4))
    y = pmesh.shard_state_hosts({"ff": x}, mesh)["ff"]
    assert y.sharding.is_equivalent_to(
        NamedSharding(mesh, P(("hosts", "dp"))), 4)
    # a computation over the sharded array partitions without gather
    s = jax.jit(lambda a: jnp.sum(a, axis=(1, 2, 3)))(y)
    np.testing.assert_allclose(np.asarray(s), 6 * 16 * 4)


def test_init_distributed_single_process_noop():
    assert pmesh.init_distributed() is False
    assert pmesh.init_distributed(num_processes=1) is False


def test_make_mesh_more_devices_than_exist_raises():
    n = len(jax.devices())
    with pytest.raises(ValueError, match="available"):
        pmesh.make_mesh(n_devices=n + 1)
