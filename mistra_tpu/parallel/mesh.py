"""Device-mesh sharding of column ensembles.

Scale-out (SURVEY.md section 2.4 / 5.8): columns are physically
independent in this model family, so the one parallel axis is the
ensemble ("dp"): every device advances its own columns and no collective
runs.  The GPUs of one host are joined all to all, so a 1-D mesh is all
the layout needs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Build a 1-D "dp" mesh over the default backend's devices.

    Asking for more devices than exist raises ``ValueError``.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available")
    return Mesh(np.asarray(devices[:n_devices]), axis_names=("dp",))


def replicate_state(state, batch: int):
    """Tile a single-column state into a [batch, ...] ensemble."""
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape),
                        state)


def shard_state(state, mesh: Mesh):
    """Place a batched state on the mesh: the batch axis over "dp"."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P("dp") if x.ndim else P())), state)


def make_ensemble_step(model, mesh: Mesh | None = None, donate: bool = True):
    """Jitted ensemble step: vmap of the minute step over the batch axis.

    With a mesh, the step runs under ``shard_map``: every device advances
    its own "dp" shard of the columns, so the GPU kernels inside the step
    see local arrays and no collective runs; columns are independent.  Without a mesh it is ``jit(vmap(...))`` on
    the devices the state lives on.
    """
    step = jax.vmap(model.minute_step)
    if mesh is not None:
        step = jax.shard_map(step, mesh=mesh, in_specs=P("dp"),
                             out_specs=P("dp"), check_vma=False)
    return jax.jit(step, donate_argnums=(0,) if donate else ())


# --------------------------------------------------------------------------
# multi-process orchestration (SURVEY.md section 5.8: jax.distributed + a
# ("hosts", "dp") factorization of the ensemble axis)
# --------------------------------------------------------------------------

def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize multi-process JAX.

    The launcher passes all three arguments (``coordinator`` is
    ``host:port``); single-process runs are a no-op.  After this,
    jax.devices() spans every process and the meshes below shard the
    ensemble across all of them.
    """
    if num_processes in (None, 1):
        return False
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_host_mesh(devices=None) -> Mesh:
    """("hosts", "dp") mesh: the leading axis separates hosts so the batch
    sharding puts whole sub-ensembles on each host and the only cross-host
    traffic is diagnostics reductions (columns are independent so no halo
    exchange exists).
    """
    if devices is None:
        devices = jax.devices()
    n_hosts = max(1, jax.process_count())
    arr = np.asarray(devices).reshape(n_hosts, len(devices) // n_hosts)
    return Mesh(arr, axis_names=("hosts", "dp"))


def shard_state_hosts(state, mesh: Mesh):
    """Place a batched state on a multi-host mesh: the batch axis over the
    combined (hosts, dp) axes."""
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, P(("hosts", "dp")) if x.ndim else P())), state)
