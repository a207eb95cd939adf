"""Implicit vertical diffusion solves (Thomas algorithm) as JAX scans.

Design: the vertical axis (n=150) is a *sequential* first-order
recurrence kept on the device as a ``lax.scan``; the parallel axes are the
column-ensemble batch (via vmap/shard_map) and the trailing field axis
(multiple prognostic fields, or the 4900 microphysics bins, solved in one
sweep as a vector RHS).  This mirrors the reference's semi-implicit scheme
(forward sweep + backward substitution, Roache form; str.f90:2944-3131) with
Dirichlet conditions at surface and model top.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def diffusion_coefficients(atk: jnp.ndarray, detw: jnp.ndarray,
                           deta: jnp.ndarray, dt) -> tuple:
    """Build the implicit-diffusion coefficient vectors.

    Index convention: 0-based; element k corresponds to the reference's
    layer k+1.  Returns (xa, xc) of length n; only entries 0..n-2 are used.
      xa[k] = atk[k]*dt/(detw[k]*deta[k])
      xc[k] = xa[k-1]*detw[k-1]/detw[k]  (xc[0] = 0, unused)
    """
    xa = atk * dt / (detw * deta)
    xc = jnp.concatenate([jnp.zeros((1,), xa.dtype),
                          xa[:-1] * detw[:-1] / detw[1:]])
    return xa, xc


def implicit_sweep(xa: jnp.ndarray, xc: jnp.ndarray,
                   fields: jnp.ndarray,
                   rhs: jnp.ndarray | None = None,
                   bottom: jnp.ndarray | None = None) -> jnp.ndarray:
    """Solve (I + D) x = rhs with Dirichlet BCs at both ends.

    Args:
      xa, xc: [n] coefficient vectors from ``diffusion_coefficients``.
      fields: [n, ...] current field values; fields[0] and fields[n-1] are the
        Dirichlet boundary values and are returned unchanged.
      rhs: [n, ...] right-hand side (defaults to ``fields``; pass explicitly
        when source terms, e.g. Coriolis, are folded in).
      bottom: override for the bottom boundary value entering the forward
        sweep (the particle solve uses the first interior level instead of
        the surface level; str.f90:3226).

    Returns the updated [n, ...] fields.
    """
    if rhs is None:
        rhs = fields
    n = fields.shape[0]
    xb = 1.0 + xa + xc

    # forward sweep over k = 1 .. n-2
    def fwd(carry, inp):
        e_prev, f_prev = carry
        xa_k, xb_k, xc_k, rhs_k = inp
        d = xb_k - xc_k * e_prev
        e = xa_k / d
        f = (rhs_k + xc_k * f_prev) / d
        return (e, f), (e, f)

    e0 = jnp.zeros((), fields.dtype)
    f0 = fields[0] if bottom is None else bottom
    (_, _), (es, fs) = jax.lax.scan(
        fwd, (e0, f0),
        (xa[1:n - 1], xb[1:n - 1], xc[1:n - 1], rhs[1:n - 1]))

    # backward substitution over k = n-2 .. 1
    def bwd(x_above, inp):
        e_k, f_k = inp
        x_k = e_k * x_above + f_k
        return x_k, x_k

    _, xs = jax.lax.scan(bwd, fields[n - 1], (es, fs), reverse=True)
    return jnp.concatenate([fields[:1], xs, fields[n - 1:]], axis=0)


def subsidence(fields: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Explicit upwind large-scale subsidence update.

    f[k] -= c[k]*(f[k+1]-f[k]) for k = 1..n-2, where c = w*dt/deta (w<0 for
    subsidence so this is upstream differencing).  fields: [n, ...],
    c: [n] broadcast over trailing dims.
    """
    cb = c.reshape(c.shape + (1,) * (fields.ndim - 1))
    upd = fields[1:-1] - cb[1:-1] * (fields[2:] - fields[1:-1])
    return jnp.concatenate([fields[:1], upd, fields[-1:]], axis=0)
