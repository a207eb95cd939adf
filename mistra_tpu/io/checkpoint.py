"""Checkpoint / restart of the full model state.

Replaces the reference's unformatted Fortran restart records (``outm``/
``outc`` writing rstm.dat/rstc.dat, outp.f90:55-313; read back by
``startm``/``startc``, str.f90:1914-2163) with one numpy ``.npz`` file of
the flattened state pytree (met + microphysics + chemistry + clock),
preserving the reference's restart-equivalence property: running N steps
equals running N/2, checkpointing, restoring, and running N/2 more.
"""

from __future__ import annotations

import os

import jax
import numpy as np

_FILE = "state.npz"


def save_checkpoint(path: str, state) -> str:
    """Write the state pytree into directory ``path``; returns the path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    arrays = {f"{i:04d}": np.asarray(leaf) for i, (_, leaf) in
              enumerate(flat)}
    keys = np.array([jax.tree_util.keystr(p) for p, _ in flat])
    tmp = os.path.join(path, _FILE + ".tmp.npz")
    np.savez(tmp, __keys__=keys, **arrays)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def restore_checkpoint(path: str, template):
    """Restore a state saved with save_checkpoint.

    ``template`` provides the pytree structure, shapes and dtypes (e.g. a
    freshly built initial state from the same configuration); a checkpoint
    whose leaves do not match it raises ``ValueError``.
    """
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(os.path.join(os.path.abspath(path), _FILE)) as data:
        keys = [str(k) for k in data["__keys__"]]
        want = [jax.tree_util.keystr(p) for p, _ in flat]
        if keys != want:
            raise ValueError(f"checkpoint leaves {keys} do not match the "
                             f"template's {want}")
        leaves = []
        for i, (name, (_, ref)) in enumerate(zip(keys, flat)):
            arr = data[f"{i:04d}"]
            ref = np.asarray(ref)
            if arr.shape != ref.shape or arr.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint leaf {name}: {arr.dtype}{arr.shape} != "
                    f"template {ref.dtype}{ref.shape}")
            leaves.append(jax.numpy.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves)
