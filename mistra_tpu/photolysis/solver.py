"""Photolysis: 176-interval actinic fluxes (delta-four-stream) + 47 J-rates.

Parity map: ``column`` (jrate.f:630-760) O2/O3 slant columns;
``sr_o2_km``/``chebev`` (jrate.f:1534-1640) Schumann-Runge O2 cross
sections; ``cross_atm`` (jrate.f:1230-1460) temperature-dependent cross
sections and O(1D)/NO3- quantum yields; ``four_intf``/``qfts``/``adjust``/
``qccfe``/``coeff*``/``qcfel`` (jrate.f:1845-3050) the Fu (1991)
delta-four-stream actinic flux solver.

Deviation: the reference computes actinic flux at only NW=7
wavelengths and reconstructs the spectral integrals with fitted lookup
tables (``photo_cal``, jrate.f:4495+).  Here the four-stream solve runs
for all 176 intervals at once (wavelength = batch axis) and each J-rate is
the exact spectral sum J = sum_l sigma(l,T) qy(l,T) F_act(l) — the
quantity the lookup tables approximate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import AVOGADRO, G, M_AIR
from .tables import (A_O1D, B_O1D, CT_TOP, MAXWAV, PhotolysisTables)

BOLTZ = 1.381e-23
RELO2 = 0.2095
DU_CONST = 3.767e-20  # part/cm2 -> DU conversion


# --------------------------------------------------------------------------
# columns and cross sections
# --------------------------------------------------------------------------

def column_densities(press_hpa, temp, relo3, u0, scaleo3):
    """O2/O3 vertical + slant columns (jrate.f COLUMN).

    Inputs are level arrays [L+1] (index 0 = virtual top level).
    Returns dict with v2, v2s, v3, v3s, dv2, dv3 (+ per-layer diffs).
    """
    sp = AVOGADRO / (M_AIR * G) * 1.0e-2      # part/cm2 per hPa
    const = sp * RELO2
    seca = jnp.where(u0 > 0.0, 1.0 / jnp.maximum(u0, 1e-8), 0.0)

    v2 = const * press_hpa
    v3_incr = sp * (press_hpa[1:] - press_hpa[:-1]) \
        * 0.5 * (relo3[1:] + relo3[:-1])
    v3 = jnp.concatenate([
        (0.7 * sp * press_hpa[0] * relo3[0])[None],
        0.7 * sp * press_hpa[0] * relo3[0] + jnp.cumsum(v3_incr)])
    # scale to the prescribed total ozone column [DU]
    v3 = v3 * scaleo3 / (v3[-1] * DU_CONST * 1.0e3)
    v2s = seca * v2
    v3s = seca * v3
    dv2 = v2[1:] - v2[:-1]
    dv2 = dv2.at[0].set(v2[1])
    dv3 = v3[1:] - v3[:-1]
    dv3 = dv3.at[0].set(v3[1])
    return {"v2": v2, "v2s": v2s, "v3": v3, "v3s": v3s,
            "dv2": dv2, "dv3": dv3, "seca": seca}


def chebev(a, b, coeffs, x):
    """Clenshaw evaluation of a Chebyshev series; coeffs [..., 20]."""
    y = (2.0 * x - a - b) / (b - a)
    y2 = 2.0 * y
    d = jnp.zeros_like(x)
    dd = jnp.zeros_like(x)
    for j in range(coeffs.shape[-1] - 1, 0, -1):
        sv = d
        d = y2 * d - dd + coeffs[..., j]
        dd = sv
    return y * d - dd + 0.5 * coeffs[..., 0]


def sr_o2_km(tb, v2s, temp):
    """Koppers & Murtagh Schumann-Runge O2 cross sections [13, L+1]."""
    cheb_a = jnp.asarray(tb.cheb_a.T)   # [13, 20]
    cheb_b = jnp.asarray(tb.cheb_b.T)
    dl = jnp.minimum(56.0, jnp.log(jnp.maximum(v2s, 1.0)))    # [L+1]
    a = chebev(38.0, 56.0, cheb_a[:, None, :], dl[None, :])   # [13, L+1]
    b = chebev(38.0, 56.0, cheb_b[:, None, :], dl[None, :])
    sro2 = jnp.exp(a * (temp[None, :] - 220.0) + b)
    return jnp.where(v2s[None, :] >= np.exp(38.0), sro2, 0.0)


def interp_t(cs_arr, temps, temp):
    """Linear/quadratic T-interpolation of tabulated cross sections.

    cs_arr [nT, 176]; temps [nT]; temp [L+1].  Returns [L+1, 176].
    Matches cross_atm's 3-point (quadratic) / 2-point (linear) forms.
    """
    if len(temps) == 2:
        w = (temp - temps[0]) / (temps[1] - temps[0])
        out = cs_arr[0][None, :] + w[:, None] * (cs_arr[1]
                                                 - cs_arr[0])[None, :]
    else:
        c1 = cs_arr[0]
        c2 = (cs_arr[1] - cs_arr[0]) / (temps[1] - temps[0])
        c3 = ((cs_arr[2] - cs_arr[1]) / (temps[2] - temps[1]) - c2) \
            / (temps[2] - temps[0])
        dt1 = (temp - temps[0])[:, None]
        dt2 = (temp - temps[1])[:, None]
        out = (dt2 * c3[None, :] + c2[None, :]) * dt1 + c1[None, :]
    return jnp.maximum(out, 0.0)


def qy_o1d(tb, temp):
    """Michelsen O(1D) quantum yield [L+1, 176]."""
    wave_nm = tb.wave * 1.0e7
    t = jnp.clip(temp, 185.0, 320.0)[:, None]
    L = np.arange(MAXWAV)
    qy = np.zeros(MAXWAV)
    qy87 = (L < 38).astype(float) * 0.87
    mid = (L >= 38) & (L < 51)
    hi = (L >= 51) & (L < 70)
    base = jnp.asarray(qy87)[None, :] \
        + jnp.asarray(np.where(mid, 1.98 - 301.0 / wave_nm, 0.0))[None, :]
    a = np.zeros(MAXWAV)
    b = np.zeros(MAXWAV)
    a[51:70] = A_O1D
    b[51:70] = B_O1D
    hi_term = jnp.asarray(a)[None, :] * jnp.exp(
        -1.439 * jnp.asarray(b)[None, :] / t)
    return base + jnp.where(jnp.asarray(hi)[None, :], hi_term, 0.0)


# --------------------------------------------------------------------------
# delta-four-stream actinic flux (Fu 1991), batched over wavelengths
# --------------------------------------------------------------------------

# double-Gauss quadrature points and Legendre values (jrate.f block data)
_U = np.array([-0.7886752, -0.2113247, 0.2113247, 0.7886752])
_P0D = np.array([1.0, 1.0, 1.0, 1.0])
_P1D = np.array([-0.788675, -0.211325, 0.211325, 0.788675])
_P2D = np.array([0.433013, -0.433013, -0.433013, 0.433013])
_P3D = np.array([-0.043394, 0.293394, -0.293394, 0.043394])
_P11D = 0.5 * np.outer(_P1D, _P1D)
_P22D = 0.5 * np.outer(_P2D, _P2D)
_P33D = 0.5 * np.outer(_P3D, _P3D)


def _coefficients(w, w1, w2, w3, u0):
    """coeff1/2/4 chain -> b1, c1, z, b, af2 (vectorized over leading dims)."""
    x = 0.5 * w
    w0w, w1w, w2w, w3w = x, x * w1, x * w2, x * w3
    fw = u0 * u0
    q1 = -w1w * u0
    q2 = w2w * (1.5 * fw - 0.5)
    q3 = -w3w * (2.5 * fw - 1.5) * u0
    fq = 0.5 * w0w

    c = {}
    for i in (2, 3):  # Fortran i = 3, 4 (0-based 2, 3)
        for j in range(4):
            val = fq + w1w * _P11D[i, j] + w2w * _P22D[i, j] \
                + w3w * _P33D[i, j]
            val = jnp.where(i == j, (val - 1.0) / _U[i], val / _U[i]) \
                if i == j else val / _U[i]
            c[(i, j)] = val
    c5 = []
    for i in range(4):
        val = (w0w + q1 * _P1D[i] + q2 * _P2D[i] + q3 * _P3D[i]) / _U[i]
        c5.append(val)

    b = {}
    b[(0, 0)] = c[(3, 3)] - c[(3, 0)]
    b[(0, 1)] = c[(3, 3)] + c[(3, 0)]
    b[(1, 0)] = c[(3, 2)] - c[(3, 1)]
    b[(1, 1)] = c[(3, 2)] + c[(3, 1)]
    b[(2, 0)] = c[(2, 3)] - c[(2, 0)]
    b[(2, 1)] = c[(2, 3)] + c[(2, 0)]
    b[(3, 0)] = c[(2, 2)] - c[(2, 1)]
    b[(3, 1)] = c[(2, 2)] + c[(2, 1)]
    b[(0, 2)] = c5[3] - c5[0]
    b[(1, 2)] = c5[2] - c5[1]
    b[(2, 2)] = c5[2] + c5[1]
    b[(3, 2)] = c5[3] + c5[0]

    fw1 = b[(0, 0)] * b[(0, 1)]
    fw2 = b[(1, 0)] * b[(2, 1)]
    fw3 = b[(2, 0)] * b[(1, 1)]
    fw4 = b[(3, 0)] * b[(3, 1)]
    a = {}
    a[(1, 1, 0)] = fw1 + fw2
    a[(1, 0, 0)] = b[(0, 0)] * b[(1, 1)] + b[(1, 0)] * b[(3, 1)]
    a[(0, 1, 0)] = b[(2, 0)] * b[(0, 1)] + b[(3, 0)] * b[(2, 1)]
    a[(0, 0, 0)] = fw3 + fw4
    a[(1, 1, 1)] = fw1 + fw3
    a[(1, 0, 1)] = b[(0, 1)] * b[(1, 0)] + b[(1, 1)] * b[(3, 0)]
    a[(0, 1, 1)] = b[(2, 1)] * b[(0, 0)] + b[(3, 1)] * b[(2, 0)]
    a[(0, 0, 1)] = fw2 + fw4
    d1 = b[(2, 1)] * b[(3, 2)] + b[(3, 1)] * b[(2, 2)] + b[(1, 2)] / u0
    d2 = b[(0, 1)] * b[(3, 2)] + b[(1, 1)] * b[(2, 2)] + b[(0, 2)] / u0
    d3 = b[(2, 0)] * b[(0, 2)] + b[(3, 0)] * b[(1, 2)] + b[(2, 2)] / u0
    d4 = b[(0, 0)] * b[(0, 2)] + b[(1, 0)] * b[(1, 2)] + b[(3, 2)] / u0

    x2 = u0 * u0
    b1 = a[(1, 1, 0)] + a[(0, 0, 0)]
    c1 = a[(1, 0, 0)] * a[(0, 1, 0)] - a[(0, 0, 0)] * a[(1, 1, 0)]
    z = [a[(1, 0, 0)] * d3 + d4 / x2 - a[(0, 0, 0)] * d4,
         a[(0, 1, 0)] * d4 - a[(1, 1, 0)] * d3 + d3 / x2,
         a[(1, 0, 1)] * d1 + d2 / x2 - a[(0, 0, 1)] * d2,
         a[(0, 1, 1)] * d2 - a[(1, 1, 1)] * d1 + d1 / x2]
    return b, a, b1, c1, z


def _coeffl(t0, t1, u0, f0, b, a, b1, c1, z):
    """Eigen-decomposition coefficients (coeffl); all vectorized."""
    dt = t1 - t0
    x = jnp.sqrt(jnp.maximum(b1 * b1 + 4.0 * c1, 1e-300))
    fk1 = jnp.sqrt(jnp.maximum((b1 + x) * 0.5, 1e-300))
    fk2 = jnp.sqrt(jnp.maximum((b1 - x) * 0.5, 1e-300))
    fw = u0 * u0
    xden = 1.0 / (fw * fw) - b1 / fw - c1
    fw2 = 0.5 * f0 / xden
    zz_ = [fw2 * zi for zi in z]
    z1 = [0.5 * (zz_[0] + zz_[2]), 0.5 * (zz_[1] + zz_[3]),
          0.5 * (zz_[1] - zz_[3]), 0.5 * (zz_[0] - zz_[2])]
    a2 = (fk1 * fk1 - a[(1, 1, 0)]) / a[(1, 0, 0)]
    b2 = (fk2 * fk2 - a[(1, 1, 0)]) / a[(1, 0, 0)]
    xq = b[(0, 0)] * b[(3, 0)] - b[(2, 0)] * b[(1, 0)]
    fw1 = fk1 / xq
    fw2q = fk2 / xq
    y = fw2q * (b2 * b[(1, 0)] - b[(3, 0)])
    zx = fw1 * (a2 * b[(1, 0)] - b[(3, 0)])
    a1 = {}
    a1[(0, 0)] = 0.5 * (1.0 - y)
    a1[(0, 1)] = 0.5 * (1.0 - zx)
    a1[(0, 2)] = 0.5 * (1.0 + zx)
    a1[(0, 3)] = 0.5 * (1.0 + y)
    y = fw2q * (b[(2, 0)] - b2 * b[(0, 0)])
    zx = fw1 * (b[(2, 0)] - a2 * b[(0, 0)])
    a1[(1, 0)] = 0.5 * (b2 - y)
    a1[(1, 1)] = 0.5 * (a2 - zx)
    a1[(1, 2)] = 0.5 * (a2 + zx)
    a1[(1, 3)] = 0.5 * (b2 + y)
    a1[(2, 0)] = a1[(1, 3)]
    a1[(2, 1)] = a1[(1, 2)]
    a1[(2, 2)] = a1[(1, 1)]
    a1[(2, 3)] = a1[(1, 0)]
    a1[(3, 0)] = a1[(0, 3)]
    a1[(3, 1)] = a1[(0, 2)]
    a1[(3, 2)] = a1[(0, 1)]
    a1[(3, 3)] = a1[(0, 0)]
    fq0 = jnp.exp(-t0 / u0)
    fq1 = jnp.exp(-t1 / u0)
    xe = jnp.exp(-fk1 * dt)
    ye = jnp.exp(-fk2 * dt)
    a1m = jnp.stack([jnp.stack([a1[(i, j)] for j in range(4)], axis=-1)
                     for i in range(4)], axis=-2)           # [..., 4, 4]
    z1v = jnp.stack(z1, axis=-1)                            # [..., 4]
    zz1 = z1v * fq0[..., None]
    zz2 = z1v * fq1[..., None]
    scale1 = jnp.stack([jnp.ones_like(xe), jnp.ones_like(xe), xe, ye],
                       axis=-1)
    scale2 = jnp.stack([ye, xe, jnp.ones_like(xe), jnp.ones_like(xe)],
                       axis=-1)
    aa1 = a1m * scale1[..., None, :]
    aa2 = a1m * scale2[..., None, :]
    return z1v, fk1, fk2, a1m, zz1, zz2, aa1, aa2


def _coefft0(t0, t1, shape, dtype):
    """No-scattering limit (coefft0); returns same tuple as _coeffl."""
    fk1 = jnp.full(shape, 4.7320545, dtype)
    fk2 = jnp.full(shape, 1.2679491, dtype)
    dt = t1 - t0
    xe = jnp.exp(-fk1 * dt)
    ye = jnp.exp(-fk2 * dt)
    z1v = jnp.zeros(shape + (4,), dtype)
    a1m = jnp.flip(jnp.eye(4, dtype=dtype), 0)
    a1m = jnp.broadcast_to(a1m, shape + (4, 4))
    zz1 = jnp.zeros(shape + (4,), dtype)
    zz2 = jnp.zeros(shape + (4,), dtype)
    aa1 = jnp.zeros(shape + (4, 4), dtype)
    aa1 = aa1.at[..., 0, 3].set(ye)
    aa1 = aa1.at[..., 1, 2].set(xe)
    aa1 = aa1.at[..., 2, 1].set(1.0)
    aa1 = aa1.at[..., 3, 0].set(1.0)
    aa2 = jnp.zeros(shape + (4, 4), dtype)
    aa2 = aa2.at[..., 0, 3].set(1.0)
    aa2 = aa2.at[..., 1, 2].set(1.0)
    aa2 = aa2.at[..., 2, 1].set(xe)
    aa2 = aa2.at[..., 3, 0].set(ye)
    return z1v, fk1, fk2, a1m, zz1, zz2, aa1, aa2


def four_stream(taus, taua, ww1, ww2, ww3, ww4, alb, flx, u0):
    """Actinic flux for a batch of wavelengths.

    taus/taua: [W, L] scattering/absorption optical depths per layer
    ww1..ww4: [W, L] phase function Legendre coefficients (x (2l+1))
    alb, flx: [W]; u0 scalar.  Returns FACT [W, L+1] (4 pi uav).
    """
    W, L = taus.shape
    dtype = taus.dtype
    tautot = taua + taus
    wc = jnp.where(tautot < 1.0e-20, 1.0, taus / jnp.maximum(tautot, 1e-30))

    # delta adjustment (SR adjust)
    f = ww4 / 9.0
    fw = 1.0 - f * wc
    w1 = (ww1 - 3.0 * f) / (1.0 - f)
    w2 = (ww2 - 5.0 * f) / (1.0 - f)
    w3 = (ww3 - 7.0 * f) / (1.0 - f)
    w = jnp.clip((1.0 - f) * wc / fw, 0.0, 0.99999999999)
    dt_adj = tautot * fw
    t = jnp.cumsum(dt_adj, axis=1)                  # [W, L]
    t0 = jnp.concatenate([jnp.zeros((W, 1), dtype), t[:, :-1]], axis=1)

    u0s = jnp.maximum(u0, 1e-6)
    f0 = flx[:, None] / jnp.pi

    # per-layer coefficient computation: scattering and clear branches
    b, a, b1, c1, z = _coefficients(w, w1, w2, w3, u0s)
    res_s = _coeffl(t0, t, u0s, f0 * jnp.ones_like(w), b, a, b1, c1, z)
    res_0 = _coefft0(t0, t, (W, L), dtype)
    clear = w <= 1.0e-12

    def sel(s, c):
        cl = clear.reshape(clear.shape + (1,) * (s.ndim - 2))
        return jnp.where(cl, c, s)

    z1v, fk1, fk2, a1m, zz1, zz2, aa1, aa2 = [
        sel(s, c) for s, c in zip(res_s, res_0)]

    # ---- assemble the block system A x = bx (qccfe) and solve densely ----
    n4 = 4 * L
    A = jnp.zeros((W, n4, n4), dtype)
    bx = jnp.zeros((W, n4), dtype)
    # top boundary: 2 equations on x_0
    A = A.at[:, 0:2, 0:4].set(aa1[:, 0, 2:4, :])
    bx = bx.at[:, 0:2].set(-zz1[:, 0, 2:4])
    # interfaces k = 1..L-1 (Fortran k = 2..n): 4 equations each
    if L > 1:
        rows = (jnp.arange(1, L)[:, None] * 4 - 2
                + jnp.arange(4)[None, :])              # [L-1, 4]
        colsL = (jnp.arange(0, L - 1)[:, None] * 4
                 + jnp.arange(4)[None, :])
        colsR = colsL + 4
        A = A.at[:, rows[:, :, None], colsL[:, None, :]].set(
            jnp.moveaxis(aa2[:, :-1], 0, 0))
        A = A.at[:, rows[:, :, None], colsR[:, None, :]].set(
            -aa1[:, 1:])
        bx = bx.at[:, rows].set(-zz2[:, :-1] + zz1[:, 1:])
    # bottom: 2 equations with surface albedo
    v1 = 0.2113247 * alb[:, None]
    v2 = 0.7886753 * alb[:, None]
    v3 = alb * u0s * (flx / jnp.pi) * jnp.exp(-t[:, -1] / u0s)
    wu = zz2[:, -1]                                   # [W, 4]
    fu = aa2[:, -1]                                   # [W, 4, 4]
    fw1 = v1 * wu[:, 2:3]
    fw2 = v2 * wu[:, 3:4]
    bx = bx.at[:, n4 - 2].set(-(wu[:, 0] - fw1[:, 0] - fw2[:, 0] - v3))
    bx = bx.at[:, n4 - 1].set(-(wu[:, 1] - fw1[:, 0] - fw2[:, 0] - v3))
    rowA = fu[:, 0, :] - v1 * fu[:, 2, :] - v2 * fu[:, 3, :]
    rowB = fu[:, 1, :] - v1 * fu[:, 2, :] - v2 * fu[:, 3, :]
    A = A.at[:, n4 - 2, n4 - 4:].set(rowA)
    A = A.at[:, n4 - 1, n4 - 4:].set(rowB)

    xx = jnp.linalg.solve(A, bx[..., None])[..., 0]   # [W, n4]
    g4 = xx.reshape(W, L, 4)

    # ---- flux assembly (qfts tail) ---------------------------------------
    # level i = 0 (TOA): k=0, x = [1, 1, e^-fk1 t1, e^-fk2 t1], y = 1
    # level i >= 1: k = i-1, x = [e^-fk2 dt, e^-fk1 dt, 1, 1], y = e^-t_k/u0
    dtk = t - t0
    xk = jnp.stack([jnp.exp(-fk2 * dtk), jnp.exp(-fk1 * dtk),
                    jnp.ones_like(dtk), jnp.ones_like(dtk)], axis=-1)
    yk = jnp.exp(-t / u0s)                            # [W, L]
    # fi[j] = z4[j] y + sum_ii a4[j, ii] g4[ii] x[ii]
    fi_lev = z1v * yk[..., None] + jnp.einsum(
        "wkji,wki,wki->wkj", a1m, g4, xk)
    uav_lev = 0.25 * fi_lev.sum(-1) + yk * (flx[:, None] / (4.0 * jnp.pi))

    # TOA level
    x_top = jnp.stack([jnp.ones((W,), dtype), jnp.ones((W,), dtype),
                       jnp.exp(-fk1[:, 0] * t[:, 0]),
                       jnp.exp(-fk2[:, 0] * t[:, 0])], axis=-1)
    fi_top = z1v[:, 0] + jnp.einsum("wji,wi,wi->wj", a1m[:, 0], g4[:, 0],
                                    x_top)
    uav_top = 0.25 * fi_top.sum(-1) + flx / (4.0 * jnp.pi)

    fact = 4.0 * jnp.pi * jnp.concatenate(
        [uav_top[:, None], uav_lev], axis=1)          # [W, L+1]
    return jnp.maximum(fact, 0.0)
