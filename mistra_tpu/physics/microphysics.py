"""2-D spectral bin microphysics: Koehler equilibrium (this file also hosts
condensational growth and sedimentation as they land).

Reference parity: ``rgl`` (str.f90:2164-2255) Newton iteration for the
equilibrium radius, ``equil`` (str.f90:4801-4981) redistribution of each dry
bin's particles onto the equilibrium water bin.  The per-bin /
per-level loops become vectorized one-hot scatters over the full
(nkt, nka, n) block, masked by the level selector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import PI, RHO3, RHOW

ZRHO_FRAC = RHO3 / RHOW
Z4PI3 = 4.0e-9 * PI / 3.0
FEU_MAX = 0.99999


def rgl(r_dry, a, b, feu):
    """Equilibrium particle radius at relative humidity feu (< 1).

    Newton iteration on x = r/r_dry solving
    (x^3-1)(x ln rH - a/r_dry) + b x = 0.  Vectorized over all inputs with a
    fixed 100-iteration bound and converged-mask (matching the reference's
    loop bound and 1e-7 relative tolerance).
    """
    r_dry, a, b, feu = jnp.broadcast_arrays(r_dry, a, b, feu)
    feu_safe = jnp.minimum(feu, 1.0 - 1.0e-12)
    zlogf = jnp.log(feu_safe)
    alpha = a / r_dry
    x0 = jnp.exp(feu_safe)

    def body(carry, _):
        xalt, done = carry
        falt = (xalt ** 3 - 1.0) * (xalt * zlogf - alpha) + b * xalt
        fstralt = (4.0 * xalt ** 3 - 1.0) * zlogf - 3.0 * xalt ** 2 * alpha + b
        xneu = xalt - falt / fstralt
        new_done = done | (jnp.abs(xneu - xalt) < 1.0e-7 * xalt)
        x_next = jnp.where(done, xalt, xneu)
        return (x_next, new_done), None

    # fixed-length scan (converged lanes are frozen): no data-dependent
    # trip count
    (x, _), _ = jax.lax.scan(body, (x0, jnp.zeros_like(x0, bool)),
                             None, length=100)
    r_eq = r_dry * x
    # at/above saturation the reference returns the dry radius
    return jnp.where(feu >= 1.0, r_dry, r_eq)


def equil_redistribute(ff, t, feu, micro_grid, a0m, b0m, level_mask,
                       collapse=True):
    """Place each dry bin's particles at the Koehler equilibrium water bin.

    Args:
      ff: [nkt, nka, n] particle spectrum.
      t, feu: [n] temperature, relative humidity (feu should already be
        clamped to < 1 by the caller when required).
      micro_grid: static MicroGrid (rn, ew, e arrays).
      a0m, b0m: Koehler coefficients (scalar, [nka]).
      level_mask: [n] bool; levels where the redistribution applies.
      collapse: if True, first collect each dry bin's particles into a single
        count (sum over water bins) before redistribution (ncase>0 behavior).

    Returns (ff_new, xm2_new_contrib) where xm2_new_contrib[n] is the liquid
    water content of the redistributed levels (caller selects via mask).
    """
    rn = jnp.asarray(micro_grid.rn, ff.dtype)
    ew = jnp.asarray(micro_grid.ew, ff.dtype)
    e = jnp.asarray(micro_grid.e, ff.dtype)
    b0 = jnp.asarray(b0m, ff.dtype) * ZRHO_FRAC
    nkt, nka, n = ff.shape

    total = jnp.sum(ff, axis=0) if collapse else ff[0]  # [nka, n]

    a0 = a0m / t  # [n]
    # equilibrium radius per (ia, k)
    rg = rgl(rn[:, None], a0[None, :], b0[:, None], feu[None, :])
    eg = Z4PI3 * (rg ** 3 - rn[:, None] ** 3)  # water mass [mg]

    # first water bin with ew[jt] >= eg  (reference: while eg > ew(jt));
    # branch-free compare-and-count
    jt = jnp.sum(ew < eg[..., None], axis=-1).astype(jnp.int32)
    jt = jnp.clip(jt, 0, nkt - 1)

    one_hot = jax.nn.one_hot(jt, nkt, dtype=ff.dtype)      # [nka, n, nkt]
    ff_eq = jnp.transpose(one_hot, (2, 0, 1)) * total[None, :, :]

    mask = level_mask[None, None, :]
    ff_new = jnp.where(mask, ff_eq, ff)
    xm2_eq = jnp.einsum("tan,t->n", ff_new, e)
    return ff_new, xm2_eq


def equil(met, micro, micro_grid, a0m, b0m, ncase, nf, level=None):
    """Reference-equivalent equil(ncase[, kk]).

    ncase 0: levels 1..n-1 at initialisation (clamps feu state to 0.99999).
    ncase 1: single ``level``.
    ncase 2: levels nf..n-1.
    Returns (met', micro').
    """
    n = met.t.shape[0]
    k = jnp.arange(n)
    if ncase == 0:
        mask = k >= 1
        feu = jnp.where(mask, jnp.minimum(met.feu, FEU_MAX), met.feu)
        met = met.replace(feu=feu)
        collapse = False
    elif ncase == 1:
        mask = k == level
        collapse = True
    elif ncase == 2:
        mask = k >= nf
        collapse = True
    else:
        raise ValueError("ncase must be 0, 1 or 2")

    ff_new, xm2_eq = equil_redistribute(micro.ff, met.t, met.feu, micro_grid,
                                        a0m, b0m, mask, collapse=collapse)
    xm2 = jnp.where(mask, xm2_eq, met.xm2)
    fsum = jnp.where(mask, jnp.sum(ff_new, axis=(0, 1)), micro.fsum)
    return met.replace(xm2=xm2), micro.replace(ff=ff_new, fsum=fsum)
