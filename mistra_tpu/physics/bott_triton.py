"""Bott bin advection as two Pallas kernels for NVIDIA GPUs (Triton route).

Same algorithm as the banded XLA form in growth.py (``_walk_banded`` and
the shift-accumulate deposit), restructured so that little but inputs and
outputs touches device memory.  XLA does not fuse the banded form's chains
of rolled [rows, nkt] arrays: the float32 minute step of 128 BTZ96 columns
needs 17.0 GB of temporaries with it and 5.6 GB with these kernels, and
runs in 4.08 s against 2.06 s (H100 80GB HBM3, 700 W).

Rows (one per level x dry-aerosol bin) are staged once, zero-padded, into
a [rows, WIDTH] layout with the nkt bins at column OFF, so that the
neighbour at offset s of every bin is a plain load of the window starting
at OFF + s.  One program owns ROWS rows and the LANES = 128 bin positions.

* ``_walk_kernel``: for every source bin, the closed-form characteristic
  walk over a band of J bins in both directions, as running sums over
  shifted windows of u (no prefix-sum array, no gathers), then the Bott
  polynomial split of its content into the lower and upper destination
  bins.  Writes the lower destination bin, both fractions and the per-row
  overshoot beyond the band.
* ``_deposit_kernel``: each destination bin gathers the fractions of the
  sources within +-(J+2) bins by shifted loads, in the same order as the
  XLA form sums them, and adds the overshoot at the grid edges.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .growth import _WALK_EPS, bott_split, walk_end

LANES = 128     # bin positions per row in a program (>= nkt)
OFF = 64        # staged column of bin 0 (>= J + 2)
WIDTH = 256     # staged row width
ROWS = 16       # rows per program


def _win(ref, s):
    """Window of the staged rows: value of bin (j + s) at position j."""
    return ref[:, pl.ds(OFF + s, LANES)]


def _inv(v):
    pos = v > 0.0
    return jnp.where(pos, 1.0 / jnp.where(pos, v, 1.0), 0.0)


def _walk(dt, i_dir, vel, nkt, band):
    """Final position of each source bin moving in +i_dir direction.

    ``vel(m)`` is the velocity m bins ahead of each source (zero beyond
    the grid); mirrors ``growth._walk_rightward_banded``.
    """
    zi = jnp.zeros(i_dir.shape, jnp.int32)
    zf = jnp.zeros(i_dir.shape, vel(0).dtype)
    limit = dt - _WALK_EPS

    def pass1(d, c):
        v, cum, count, q, run = c           # v = vel(d)
        cum = cum + _inv(v)                 # time to cross bins i..i+d
        count = count + ((i_dir + d < nkt) & (cum < limit)).astype(jnp.int32)
        v = vel(d + 1)
        q = q & (v > 0.0) & (i_dir + d + 1 < nkt)
        return v, cum, count, q, run + q.astype(jnp.int32)

    _, _, count, _, run = jax.lax.fori_loop(
        0, band, pass1, (vel(0), zf, zi, jnp.ones(i_dir.shape, bool), zi))
    kstar = i_dir + count
    b = i_dir + 1 + run
    kstop = jnp.minimum(kstar, b)
    o_ks = jnp.clip(kstop, 0, nkt - 1) - i_dir
    o_bs = jnp.clip(b, 0, nkt - 1) - i_dir

    def pass2(d, c):
        before, pk, uk, pb, ub = c          # before: time to reach bin i+d
        v = vel(d)
        sk = o_ks == d
        sb = o_bs == d
        return (before + _inv(v), jnp.where(sk, before, pk),
                jnp.where(sk, v, uk), jnp.where(sb, before, pb),
                jnp.where(sb, v, ub))

    _, pk, uk, pb, ub = jax.lax.fori_loop(0, band + 2, pass2,
                                          (zf, zf, zf, zf, zf))
    return walk_end(dt, kstar, b, kstop, pk, uk, pb, ub, nkt)


def _walk_kernel(u_ref, z_ref, klo_ref, wlo_ref, whi_ref, ot_ref, ob_ref,
                 *, dt, nkt, band):
    i = jax.lax.broadcasted_iota(jnp.int32, (ROWS, LANES), 1)
    u = _win(u_ref, 0)
    dtype = u.dtype
    x_r = _walk(dt, i, lambda m: _win(u_ref, m), nkt, band)
    x_l = _walk(dt, (nkt - 1) - i, lambda m: -_win(u_ref, -m), nkt, band)
    x0 = jnp.where(u == 0.0, i.astype(dtype),
                   jnp.where(u > 0.0, x_r, (nkt - 1.0) - x_l))

    k_low = jnp.floor(x0).astype(jnp.int32)
    c0 = x0 - k_low.astype(dtype)
    k_low = jnp.clip(k_low, 0, nkt - 1)
    k_high = jnp.clip(k_low + 1, 0, nkt - 1)

    w_lo, w_hi = bott_split(c0, _win(z_ref, 0), _win(z_ref, -2),
                            _win(z_ref, -1), _win(z_ref, 1), _win(z_ref, 2),
                            i, nkt)

    reach = band + 2
    dk_lo = k_low - i
    dk_hi = k_high - i
    ot_ref[...] = jnp.sum(jnp.where(dk_lo > reach, w_lo, 0.0)
                          + jnp.where(dk_hi > reach, w_hi, 0.0), axis=1)
    ob_ref[...] = jnp.sum(jnp.where(dk_lo < -reach, w_lo, 0.0)
                          + jnp.where(dk_hi < -reach, w_hi, 0.0), axis=1)
    tail = WIDTH - OFF - LANES
    for ref, val in ((klo_ref, k_low), (wlo_ref, w_lo), (whi_ref, w_hi)):
        ref[:, pl.ds(0, OFF)] = jnp.zeros((ROWS, OFF), ref.dtype)
        ref[:, pl.ds(OFF, LANES)] = val
        ref[:, pl.ds(OFF + LANES, tail)] = jnp.zeros((ROWS, tail), ref.dtype)


def _deposit_kernel(klo_ref, wlo_ref, whi_ref, ot_ref, ob_ref, psi_ref, *,
                    nkt, band):
    j = jax.lax.broadcasted_iota(jnp.int32, (ROWS, LANES), 1)
    reach = band + 2

    def body(t, out):
        s = reach - t                       # source = j + s, d = -s
        klo = _win(klo_ref, s)
        khi = jnp.minimum(klo + 1, nkt - 1)
        return out + (jnp.where(klo == j, _win(wlo_ref, s), 0.0)
                      + jnp.where(khi == j, _win(whi_ref, s), 0.0))

    out = jax.lax.fori_loop(0, 2 * reach + 1, body,
                            jnp.zeros((ROWS, LANES), psi_ref.dtype))
    out = out + jnp.where(j == 0, ob_ref[...][:, None], 0.0)
    out = out + jnp.where(j == nkt - 1, ot_ref[...][:, None], 0.0)
    psi_ref[...] = out


@functools.partial(jax.jit, static_argnames=("dt", "band", "interpret"))
def bott_advect_gpu(u, z, dt: float, band: int, interpret: bool = False):
    """Bott advection of rows z [..., nkt] with velocities u (same shape);
    ``band`` is the walk band J of the banded XLA form."""
    shape = z.shape
    nkt = shape[-1]
    if nkt > LANES or band + 2 > OFF or nkt + band + 2 > WIDTH - OFF:
        raise ValueError(f"nkt={nkt}, band={band} exceed the kernel layout")
    dtype = z.dtype
    u2 = jnp.broadcast_to(u, shape).astype(dtype).reshape(-1, nkt)
    z2 = z.reshape(-1, nkt)
    n = z2.shape[0]
    npad = -(-n // ROWS) * ROWS
    pad = ((0, npad - n), (OFF, WIDTH - OFF - nkt))
    u_p = jnp.pad(u2, pad)
    z_p = jnp.pad(z2, pad)

    grid = (npad // ROWS,)
    wide = pl.BlockSpec((ROWS, WIDTH), lambda r: (r, 0))
    rows = pl.BlockSpec((ROWS,), lambda r: (r,))
    params = plt.CompilerParams(num_warps=4, num_stages=1)
    klo, wlo, whi, ot, ob = pl.pallas_call(
        functools.partial(_walk_kernel, dt=float(dt), nkt=nkt, band=band),
        out_shape=(jax.ShapeDtypeStruct((npad, WIDTH), jnp.int32),
                   jax.ShapeDtypeStruct((npad, WIDTH), dtype),
                   jax.ShapeDtypeStruct((npad, WIDTH), dtype),
                   jax.ShapeDtypeStruct((npad,), dtype),
                   jax.ShapeDtypeStruct((npad,), dtype)),
        grid=grid, in_specs=[wide, wide],
        out_specs=(wide, wide, wide, rows, rows),
        compiler_params=params, backend="triton", interpret=interpret,
        name="bott_walk")(u_p, z_p)
    psi = pl.pallas_call(
        functools.partial(_deposit_kernel, nkt=nkt, band=band),
        out_shape=jax.ShapeDtypeStruct((npad, LANES), dtype),
        grid=grid, in_specs=[wide, wide, wide, rows, rows],
        out_specs=pl.BlockSpec((ROWS, LANES), lambda r: (r, 0)),
        compiler_params=params, backend="triton", interpret=interpret,
        name="bott_deposit")(klo, wlo, whi, ot, ob)
    return psi[:n, :nkt].reshape(shape)
