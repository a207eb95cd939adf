"""Mellor-Yamada 2.5 turbulence closure.

Vectorized reimplementation of the reference closure (``atk1``,
str.f90:3549-3841, and the startup variant ``atk0``, str.f90:3451-3543):
all vertical loops become vectorized array ops with masks; the cloud-free /
cloudy branch and the inversion search become where-selects so the whole
closure vmaps over column ensembles.  Constants and exponential time
filters follow BTZ96 (see SURVEY.md section 7.4).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import G, KAPPA
from .thermo import p21

# Mellor & Yamada closure constants (eq. 45) and BTZ96 a1..a9 composition
MY_A1 = 0.92
MY_B1 = 16.6
MY_A2 = 0.74
MY_B2 = 10.1
MY_C1 = 0.08
A1 = MY_A2
A2 = -9.0 * MY_A1 * MY_A2 ** 2
A3 = 18.0 * MY_A1 ** 2 * MY_A2 * MY_C1
A4 = MY_A1 * (1.0 - 3.0 * MY_C1)
A5 = 3.0 * MY_A1 * MY_A2 * (3.0 * MY_A2 + MY_B2 * (3.0 * MY_C1 - 1.0)
                            + 12.0 * MY_A1 * MY_C1)
A6 = -3.0 * MY_A2 * (7.0 * MY_A1 + MY_B2)
A7 = 27.0 * MY_A1 * MY_A2 ** 2 * (4.0 * MY_A1 + MY_B2)
A8 = 6.0 * MY_A1 ** 2
A9 = 18.0 * MY_A1 ** 2 * MY_A2 * (3.0 * MY_A2 - MY_B2)
EPS_DISS = 1.0 / MY_B1

# exponential time filters (old-value fractions)
F_BUOY_OLD = 0.8
F_SH_OLD = 0.8
F_SM_OLD = 0.8
F_XL_OLD = 0.95

GH_MIN = -0.6
GH_MAX = 0.03


def atk0(met, turb, surf, grid, ug, vg, z0):
    """Initial exchange coefficients and mixing length (model start)."""
    eta, etw, deta = grid.eta, grid.etw, grid.deta
    n = eta.shape[0]
    u, v, theta = met.u, met.v, met.theta

    x1 = (ug + vg) * 2.7
    x2 = KAPPA * etw
    xl = x2 * x1 / (x2 + x1)
    xl = jnp.minimum(xl, deta)
    xl = xl.at[0].set(0.0)

    atkm0 = 0.5 * eta[1] * surf.ustern / surf.gclu
    atkh0 = 0.5 * eta[1] * surf.ustern / surf.gclt

    # interior levels k = 1..n-2
    du = u[2:] - u[1:-1]
    dv = v[2:] - v[1:-1]
    vh = (du ** 2 + dv ** 2) / deta[1:-1] ** 2
    zz = etw[1:-1] + z0
    x0 = (0.4 * zz / (1.0 + 0.4 * zz / xl[1:-1])) ** 2
    st = G * (theta[2:] - theta[1:-1]) / (deta[1:-1] * theta[1:-1])

    unstable = st <= 0.0
    atkm_u = x0 * jnp.sqrt(jnp.maximum(vh - 11.0 * st, 0.0))
    atkh_u = jnp.where(vh - 3.0 * st == 0.0, atkm_u,
                       1.35 * atkm_u * (vh - 5.5 * st) / (vh - 3.0 * st))
    atkm_s = x0 * vh / jnp.sqrt(vh + 6.0 * st)
    atkh_s = 1.35 * atkm_s * vh / (vh + 6.0 * st)

    atkm_i = jnp.maximum(1.0e-3, jnp.where(unstable, atkm_u, atkm_s))
    atkh_i = jnp.maximum(1.0e-3, jnp.where(unstable, atkh_u, atkh_s))

    atkm = jnp.concatenate([jnp.array([atkm0]), atkm_i, jnp.zeros(1)])
    atkh = jnp.concatenate([jnp.array([atkh0]), atkh_i, jnp.zeros(1)])
    return turb.replace(atkm=atkm.astype(met.u.dtype),
                        atkh=atkh.astype(met.u.dtype), xl=xl)


def atk1(met, turb, surf, micro, grid, kinv_old):
    """One closure update: returns (met', turb', kinv).

    met' carries updated buoy/thetl; turb' the new exchange coefficients,
    stability functions, mixing length and TKE production terms.
    """
    dtype = met.u.dtype
    eta = jnp.asarray(grid.eta, dtype)
    etw = jnp.asarray(grid.etw, dtype)
    deta = jnp.asarray(grid.deta, dtype)
    detw = jnp.asarray(grid.detw, dtype)
    n = eta.shape[0]
    k = jnp.arange(n)
    interior = (k >= 1) & (k <= n - 2)  # Fortran 2..nm

    theta, xm1, xm2, rho, t = met.theta, met.xm1, met.xm2, met.rho, met.t
    thet = (met.p[0] / met.p) ** 0.286
    theti = 1.0 / thet
    lcl, lct = micro.lcl, micro.lct  # 0-based layer indices

    dtheta = jnp.diff(theta, append=theta[-1:])
    dxm1 = jnp.diff(xm1, append=xm1[-1:])

    # ---------------- cloud-free buoyancy ---------------------------------
    x0_free = ((1.0 + 0.61 * xm1) * dtheta + 0.61 * theta * dxm1) / deta
    sm_free = jnp.where(interior, x0_free, turb.sm)
    sh_free = jnp.where(interior, x0_free, turb.sh)
    buoy_free = jnp.where(interior,
                          F_BUOY_OLD * met.buoy + (1 - F_BUOY_OLD) * x0_free,
                          met.buoy)
    thetl_free = jnp.where(interior, (1.0 + 0.61 * xm1) * theta, met.thetl)
    # inversion level: first k >= 9 (0-based) with buoy > 1e-5, else n-1
    cand_free = (k >= 9) & (buoy_free > 1.0e-5)
    kinv_free = jnp.where(jnp.any(cand_free),
                          jnp.argmax(cand_free), n - 1).astype(jnp.int32)

    # ---------------- cloudy buoyancy (Bott 1997 moist closure) ------------
    thetl_c = theta - 2465.1 * thet * xm2 / rho
    thetl_c = thetl_c.at[n - 1].set(thetl_c[n - 2] + 1.0)
    xmw = xm1 + xm2 / rho
    dthetl = jnp.diff(thetl_c, append=thetl_c[-1:]) / deta
    dmw = jnp.diff(xmw, append=xmw[-1:]) / deta
    x0_sh = (1.0 + 0.61 * xmw) * dthetl + 0.61 * thetl_c * dmw
    sh_cloud = jnp.where(interior,
                         F_SH_OLD * turb.sh + (1 - F_SH_OLD) * x0_sh, turb.sh)

    ql = xm2 / rho
    esat = p21(t)
    qs = 0.62198 * esat / (met.p - 0.37802 * esat)
    qslt = 5368.0 * qs / (t * t)
    xa = 1.0 / (1.0 + 2465.1 * qslt)
    xb = xa * theti * qslt
    betat = 1.0 + 0.61 * xm1 - ql
    betaw = 0.61 * (thetl_c + 2465.1 * thet * ql)
    betal = (1.0 + 0.61 * xmw - 3.22 * ql) * 2465.1 * thet - 1.61 * thetl_c
    x0_sm = (betat - xb * betal) * dthetl + (betaw + xa * betal) * dmw
    below_top = (k >= 1) & (k < lct)  # Fortran 2..lct-1
    sm_cloud = jnp.where(below_top,
                         F_SM_OLD * turb.sm + (1 - F_SM_OLD) * x0_sm, turb.sm)
    alpha = jnp.exp(60.0 * (jnp.minimum(met.feu, 1.0) - 1.0))
    betal_a = betal * alpha
    x0_b = (betat - xb * betal_a) * dthetl + (betaw + xa * betal_a) * dmw
    buoy_cloud = jnp.where(
        below_top, F_BUOY_OLD * met.buoy + (1 - F_BUOY_OLD) * x0_b, met.buoy)
    buoy_cloud = jnp.where((k >= lct) & (k <= n - 2), sh_cloud, buoy_cloud)
    # inversion level near cloud top
    in_win = (k >= lct - 4) & (k <= lct + 4) & (buoy_cloud > 1.0e-5)
    kinv_win = jnp.where(jnp.any(in_win),
                         jnp.min(jnp.where(in_win, k, n + 99)), lct + 5)
    kinv_cloud = (kinv_win - 1).astype(jnp.int32)

    # ---------------- select branch ---------------------------------------
    cloudy = lct > lcl + 2
    sm = jnp.where(cloudy, sm_cloud, sm_free)
    sh = jnp.where(cloudy, sh_cloud, sh_free)
    buoy = jnp.where(cloudy, buoy_cloud, buoy_free)
    thetl = jnp.where(cloudy, thetl_c, thetl_free)
    kinv = jnp.where(cloudy, kinv_cloud, kinv_free).astype(jnp.int32)
    kinv = jnp.clip(kinv, 2, n - 1)

    # ---------------- mixing length (eq. 50) ------------------------------
    es = jnp.sqrt(2.0 * met.tke)
    below_inv = (k >= 1) & (k < kinv)  # Fortran 2..kinv-1
    wsum = jnp.where(below_inv, es * deta, 0.0)
    x2 = jnp.sum(wsum * etw) / jnp.sum(wsum)
    zinv = etw[kinv]
    x4 = 0.1 - detw[kinv] / x2
    x0k = KAPPA * etw
    x1_below = jnp.maximum(detw, x2 * (0.1 - x4 * jnp.exp((etw - zinv) / 15.0)))
    x1k = jnp.where(below_inv, x1_below, detw)
    xl_new = x0k * x1k / (x0k + x1k)
    xl_new = xl_new.at[0].set(0.0)
    xl = jnp.where(interior, F_XL_OLD * turb.xl + (1 - F_XL_OLD) * xl_new,
                   xl_new)
    xl = xl.at[0].set(0.0)

    # ---------------- stability functions ---------------------------------
    safe_xl = jnp.where(xl > 0.0, xl, 1.0)
    x1g = safe_xl * safe_xl / (es * es)
    ghn = -G * x1g / theta * buoy
    gh = jnp.clip(ghn, GH_MIN, GH_MAX)
    du = jnp.diff(met.u, append=met.u[-1:])
    dv = jnp.diff(met.v, append=met.v[-1:])
    gmn = x1g * (du ** 2 + dv ** 2) / (deta * deta)
    gm = jnp.minimum(gmn, 25.0 * (GH_MAX - gh))
    gh = jnp.where(interior, gh, jnp.where(k == 0, 0.0, turb.gh))
    gm = jnp.where(interior, gm, jnp.where(k == 0, 0.0, turb.gm))

    denom = 1.0 / (1.0 + (A6 + A7 * gh) * gh + (A8 + A9 * gh) * gm)
    shn = (A1 + A2 * gh + A3 * gm) * denom
    smn = (A4 + A5 * gh) * denom

    x1p = es ** 3 / safe_xl
    tkeps = jnp.where(interior, x1p * smn * gm, turb.tkeps)
    tkepb = jnp.where(interior, x1p * shn * gh, turb.tkepb)
    tkepd = jnp.where(interior, -x1p * EPS_DISS, turb.tkepd)
    tkep = jnp.where(interior, tkeps + tkepb + tkepd, met.tkep)

    x2e = es * xl
    atkh0 = 0.5 * eta[1] * surf.ustern / surf.gclt
    atkm0 = 0.5 * eta[1] * surf.ustern / surf.gclu
    atkh = jnp.where(interior, x2e * shn,
                     jnp.where(k == 0, atkh0, turb.atkh))
    atkm = jnp.where(interior, x2e * smn,
                     jnp.where(k == 0, atkm0, turb.atkm))
    atke = jnp.where(interior, jnp.minimum(atkm, x2e * 0.2),
                     jnp.where(k == 0, atkm0, turb.atke))
    # face average over k = 0..n-2
    atke = jnp.concatenate([0.5 * (atke[:-1] + atke[1:]), atke[-1:]])

    met = met.replace(buoy=buoy, thetl=thetl, tkep=tkep)
    turb = turb.replace(atke=atke.astype(dtype), atkh=atkh.astype(dtype),
                        atkm=atkm.astype(dtype), gm=gm, gh=gh, sm=sm, sh=sh,
                        xl=xl, tkeps=tkeps, tkepb=tkepb, tkepd=tkepd)
    return met, turb, kinv
