"""Semi-implicit vertical diffusion operators.

Reference parity: ``difm`` (momentum/heat/moisture/TKE, str.f90:2944-3131),
``difp`` (4900-bin particle spectrum, str.f90:3137-3265) and ``difc``
(chemical species, str.f90:3271-3450).  All fields sharing an
exchange-coefficient set are solved in ONE Thomas sweep with a trailing
field axis; the spectrum solve treats the 4900 bins as the vector axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import FCOR, R0
from ..utils.tridiag import diffusion_coefficients, implicit_sweep, subsidence
from .thermo import p21
from .turbulence import atk1


def difm(met, turb, surf, micro, grid, dt, ug, vg):
    """Momentum/heat/moisture/TKE implicit diffusion + subsidence.

    Returns (met', turb', kinv).
    """
    dtype = met.u.dtype
    detw = jnp.asarray(grid.detw, dtype)
    deta = jnp.asarray(grid.deta, dtype)
    n = detw.shape[0]
    thet = (met.p[0] / met.p) ** 0.286
    theti = 1.0 / thet

    # prognostic updates before the solve
    tke = met.tke.at[0].set(jnp.maximum(1.0e-6, 3.2537 * surf.ustern ** 2))
    rho = met.p / (R0 * met.t * (1.0 + 0.61 * met.xm1))
    theta = met.t * thet
    tke = jnp.maximum(1.0e-5, tke + met.tkep * dt)
    c = met.w * dt / deta
    met = met.replace(rho=rho, theta=theta, tke=tke)

    # turbulence closure
    met, turb, kinv = atk1(met, turb, surf, micro, grid, None)

    # --- momentum (atkm): u and v with Coriolis source ---------------------
    xa_m, xc_m = diffusion_coefficients(turb.atkm, detw, deta, dt)
    fdt = FCOR * dt
    uv = jnp.stack([met.u, met.v], axis=-1)
    uv_rhs = jnp.stack([met.u + fdt * (met.v - vg),
                        met.v - fdt * (met.u - ug)], axis=-1)
    uv_new = implicit_sweep(xa_m, xc_m, uv, rhs=uv_rhs)
    u, v = uv_new[:, 0], uv_new[:, 1]

    # --- TKE (atke) --------------------------------------------------------
    xa_e, xc_e = diffusion_coefficients(turb.atke, detw, deta, dt)
    tke = implicit_sweep(xa_e, xc_e, met.tke)

    # --- heat/moisture (atkh): xm1 and theta ------------------------------
    xa_h, xc_h = diffusion_coefficients(turb.atkh, detw, deta, dt)
    hm = jnp.stack([met.xm1, met.theta], axis=-1)
    hm_new = implicit_sweep(xa_h, xc_h, hm)
    xm1, theta = hm_new[:, 0], hm_new[:, 1]

    # --- large-scale subsidence (explicit upwind) --------------------------
    fields = jnp.stack([theta, u, v, xm1], axis=-1)
    fields = subsidence(fields, c)
    theta, u, v, xm1 = (fields[:, i] for i in range(4))
    c_tke = 0.5 * (c + jnp.concatenate([c[1:], c[-1:]]))
    tke = subsidence(tke[:, None], c_tke)[:, 0]

    # diagnostic updates
    t = met.t
    t = t.at[1:n - 1].set(theta[1:n - 1] * theti[1:n - 1])
    feu = met.feu
    feu_int = xm1[1:n - 1] * met.p[1:n - 1] / (
        (0.62198 + 0.37802 * xm1[1:n - 1]) * p21(t[1:n - 1]))
    feu = feu.at[1:n - 1].set(feu_int)

    met = met.replace(u=u, v=v, tke=tke, xm1=xm1, theta=theta, t=t, feu=feu)
    return met, turb, kinv


def difp(micro, met, turb, grid, dt):
    """Implicit diffusion + subsidence of the 2-D particle spectrum."""
    dtype = micro.ff.dtype
    detw = jnp.asarray(grid.detw, dtype)
    deta = jnp.asarray(grid.deta, dtype)
    n = detw.shape[0]
    nkt, nka = micro.ff.shape[0], micro.ff.shape[1]

    # mass-specific conversion (levels 1..n-1; level 0 untouched)
    rho = met.rho
    scale = jnp.concatenate([jnp.ones((1,), rho.dtype), 1.0 / rho[1:]])
    ff = micro.ff * scale[None, None, :]

    fields = ff.reshape(nkt * nka, n).T  # [n, bins]
    xa, xc = diffusion_coefficients(turb.atkh, detw, deta, dt)
    fields = implicit_sweep(xa, xc, fields, bottom=fields[1])

    c = met.w * dt / deta
    fields = subsidence(fields, c)

    ff = fields.T.reshape(nkt, nka, n)
    unscale = jnp.concatenate([jnp.ones((1,), rho.dtype), rho[1:]])
    ff = ff * unscale[None, None, :]

    fsum = micro.fsum
    fsum = fsum.at[1:].set(jnp.sum(ff[:, :, 1:], axis=(0, 1)))
    return micro.replace(ff=ff, fsum=fsum)


def difc(fields_dict, met, turb, grid, dt):
    """Implicit diffusion + subsidence of chemical species.

    ``fields_dict`` maps names to [n, ...] concentration arrays; all are
    solved with the heat exchange coefficient in one batched sweep.
    Bottom boundary uses the first interior level (no surface reservoir),
    mirroring the reference's treatment of s1/s3/sl1/sion1.
    """
    dtype = met.u.dtype
    detw = jnp.asarray(grid.detw, dtype)
    deta = jnp.asarray(grid.deta, dtype)
    n = detw.shape[0]
    names = list(fields_dict)
    flats, shapes = [], {}
    for name in names:
        arr = fields_dict[name]
        shapes[name] = arr.shape
        flats.append(arr.reshape(n, -1))
    stacked = jnp.concatenate(flats, axis=1)

    xa, xc = diffusion_coefficients(turb.atkh, detw, deta, dt)
    stacked = implicit_sweep(xa, xc, stacked, bottom=stacked[1])
    c = met.w * dt / deta
    stacked = subsidence(stacked, c)

    out = {}
    offset = 0
    for name in names:
        size = 1
        for s in shapes[name][1:]:
            size *= s
        out[name] = stacked[:, offset:offset + size].reshape(shapes[name])
        offset += size
    return out
