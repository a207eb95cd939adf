"""PIFM2 delta-two-stream radiative transfer solver.

Vectorized reimplementation of the reference solver (``nstrahl`` and its 26
subroutines, nrad.f90:55-3043): 18 spectral bands (6 solar + 12 IR) with
correlated-k gas absorption over 121 (band, quadrature) pairs.

Design (SURVEY.md section 3.4): all 121 k-quadrature pairs are batched —
the per-layer transfer coefficients a1..a6 are computed as one vectorized
block over (pair, cloud-part, layer); the top-down flux propagation
(``kurzw``), the block elimination and the bottom-up back-substitution
(``jeanfr``) are lax.scans over the 160 layers carrying the whole pair
batch, so the sequential depth is 160 regardless of spectral resolution.
All arrays here are indexed TOP-DOWN like the reference solver; the driver
rotates at the interface.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .tables import KG, MB, MBIR, MBS, Pifm2Tables

# IR band wavelength boundaries [um] for the Planck integration
WVL = np.array([2200.0, 1900.0, 1700.0, 1400.0, 1250.0, 1100.0,
                980.0, 800.0, 670.0, 540.0, 400.0, 280.0, 0.0])

# trace gas concentrations (reference nstrahl:192-195)
UMCO2 = 330.0
UMCH4 = 1.6
UMN2O = 0.28

U0MIN = 1.0e-2

STANP_S = np.array([1000., 1580., 2510., 3980., 6310., 10000., 15800.,
                    25100., 39800., 63100., 100000.])
STANP_I = np.array([25.1, 39.8, 63.1, 100., 158., 251., 398., 631., 1000.,
                    1580., 2510., 3980., 6310., 10000., 15800., 25100.,
                    39800., 63100., 100000.])


# --------------------------------------------------------------------------
# correlated-k absorption coefficient interpolation (qks/qki/qkio3)
# --------------------------------------------------------------------------

def interp_k(coef, stanp, p, t, tref):
    """Vectorized Fu (1991) k-coefficient interpolation.

    coef: [..., 3, np] ln-k polynomial coefficients at np standard pressures.
    p, t: [nrlev].  Returns fkg [..., nrlev].
    """
    stanp = jnp.asarray(stanp, p.dtype)
    npp = stanp.shape[0]
    ztf = jnp.asarray(t - tref)[..., None, :]   # [..., 1, nrlev]
    ztf2 = ztf * ztf
    # k at all standard pressures: [..., np, nrlev]
    lnk = (coef[..., 0, :, None] + coef[..., 1, :, None] * ztf
           + coef[..., 2, :, None] * ztf2)
    kk = jnp.exp(lnk)

    iph = jnp.clip(jnp.searchsorted(stanp, p), 1, npp - 1)
    x1 = jnp.take_along_axis(
        kk, jnp.broadcast_to(iph - 1, kk.shape[:-2] + p.shape)[..., None, :],
        axis=-2)[..., 0, :]
    x2 = jnp.take_along_axis(
        kk, jnp.broadcast_to(iph, kk.shape[:-2] + p.shape)[..., None, :],
        axis=-2)[..., 0, :]
    frac = (p - stanp[iph - 1]) / (stanp[iph] - stanp[iph - 1])
    fkg_mid = x1 + (x2 - x1) * frac

    # below the lowest tabulated pressure: scale linearly from zero
    low = p <= stanp[0]
    fkg_low = kk[..., 0, :] * p / stanp[0]
    # above the highest: extrapolate the last interval's slope
    high = p >= stanp[-1]
    slope = (kk[..., npp - 1, :] - kk[..., npp - 2, :]) \
        / (stanp[npp - 1] - stanp[npp - 2])
    fkg_high = kk[..., npp - 2, :] + slope * (p - stanp[npp - 2])

    return jnp.where(low, fkg_low, jnp.where(high, fkg_high, fkg_mid))


def _qop_pair(f, w, p, const):
    """Generic layer optical depth: tg[l] = (f*w)[l] + (f*w)[l+1] scaled."""
    fw = f * w
    return (fw[..., :-1] + fw[..., 1:]) * (p[1:] - p[:-1]) * const


class PairTables:
    """Per-(band, ig) packed coefficient arrays built once from the pifm2
    tables (host-side numpy)."""

    def __init__(self, tb: Pifm2Tables):
        self.kg = KG
        self.npairs = int(KG.sum())
        band_of_pair = np.concatenate(
            [np.full(KG[b], b) for b in range(MB)])  # 0-based band index
        self.band_of_pair = band_of_pair
        self.solar_pair = band_of_pair < MBS
        # quadrature weights: solar pairs scaled by band solar energy
        hk = np.concatenate([tb.hk[b + 1] for b in range(MB)])
        hk_energy = hk.copy()
        for b in range(MBS):
            sel = band_of_pair == b
            hk_energy[sel] = tb.s0b[b] * hk[sel]
        self.hk = hk_energy
        self.tb = tb

        # stacked coefficient tables
        self.fk1o3 = tb.cgas["fk1o3"]                       # [10]
        self.cs_solar = np.concatenate(
            [np.moveaxis(tb.cgas[f"c{b}h2o"], -1, 0) for b in
             range(2, 7)])                                  # [44, 3, 11]
        ir_bands = list(range(7, 19))
        self.ci_h2o = np.concatenate([
            np.moveaxis(tb.cgas[
                {12: "c12o3", 14: "c14hca", 15: "c15hca"}.get(
                    b, f"c{b}h2o")], -1, 0)
            for b in ir_bands])                             # [67, 3, 19]
        # NOTE: for band 12 the stacked per-ig table is c12o3 (O3 via qkio3);
        # for 14/15 it is the CO2-scaled hca tables; handled in gas_tau.
        self.c10ch4 = tb.cgas["c10ch4"]
        self.c10n2o = tb.cgas["c10n2o"]
        self.c11ch4 = tb.cgas["c11ch4"]
        self.c11n2o = tb.cgas["c11n2o"]
        self.c12h2o = tb.cgas["c12h2o"]
        self.c14hcb = np.moveaxis(tb.cgas["c14hcb"], -1, 0)  # [10, 3, 19]
        self.c15hcb = np.moveaxis(tb.cgas["c15hcb"], -1, 0)  # [12, 3, 19]

        # index bookkeeping
        self.n_band1 = KG[0]
        self.n_solar_k = int(KG[1:6].sum())
        ir_count = KG[6:].astype(int)
        self.ir_band_of = np.concatenate(
            [np.full(c, 6 + i) for i, c in enumerate(ir_count)])  # 0-based


def gas_tau(pt: PairTables, p, t, xm1, qmo3, dtype):
    """Optical depths tg [npairs, nrlay] and weights hk [npairs]."""
    nrlev = p.shape[0]

    # band 1: ozone, solar
    fq = 2.3808 * jnp.asarray(pt.fk1o3, dtype)              # [10]
    tg_b1 = fq[:, None] * (qmo3[:-1] + qmo3[1:])[None, :] \
        * (p[1:] - p[:-1])[None, :]

    # solar H2O bands 2-6
    fkg_s = interp_k(jnp.asarray(pt.cs_solar, dtype), STANP_S, p, t, 245.0)
    tg_s = _qop_pair(fkg_s, xm1[None, :], p, 6.349205)

    # IR pairs: base per-ig table via qki (or qkio3 for band 12)
    ci = jnp.asarray(pt.ci_h2o, dtype)
    ir_band = pt.ir_band_of                                  # [67], 0-based
    tref = jnp.asarray(np.where(ir_band == 11, 250.0, 245.0), dtype)
    fkg_i = interp_k(ci, STANP_I, p, t, tref[:, None])
    # per-pair weight for the base table: H2O bands weight xm1; band 12 O3
    # weights qmo3; bands 14/15 use the CO2/H2O combination below
    w_xm1 = jnp.broadcast_to(xm1, (len(ir_band), nrlev))
    w_o3 = jnp.broadcast_to(qmo3, (len(ir_band), nrlev))
    is_b12 = jnp.asarray(ir_band == 11)[:, None]
    is_b1415 = jnp.asarray((ir_band == 13) | (ir_band == 14))[:, None]
    const = jnp.asarray(np.where(ir_band == 11, 2.3808,
                                 np.where((ir_band == 13) | (ir_band == 14),
                                          0.005, 6.349205)), dtype)
    base_w = jnp.where(is_b12, w_o3, jnp.where(is_b1415, 1.0, w_xm1))

    # CO2/H2O overlap bands 14, 15 (approach two of Fu): fkg combination
    pq = jnp.where(p >= 6310.0, xm1, 0.0)
    fkg_b14b = interp_k(jnp.asarray(pt.c14hcb, dtype), STANP_I, p, t, 245.0)
    fkg_b15b = interp_k(jnp.asarray(pt.c15hcb, dtype), STANP_I, p, t, 245.0)
    off14 = int(np.searchsorted(pt.ir_band_of, 13))
    off15 = int(np.searchsorted(pt.ir_band_of, 14))
    n14, n15 = int(KG[13]), int(KG[14])
    fkg_i = fkg_i.at[off14:off14 + n14].set(
        fkg_i[off14:off14 + n14] / 330.0 * UMCO2 + pq[None, :] * fkg_b14b)
    fkg_i = fkg_i.at[off15:off15 + n15].set(
        fkg_i[off15:off15 + n15] / 330.0 * UMCO2 + pq[None, :] * fkg_b15b)

    tg_i = (fkg_i * base_w)
    tg_i = (tg_i[:, :-1] + tg_i[:, 1:]) * (p[1:] - p[:-1])[None, :] \
        * const[:, None]

    # band 10/11 CH4 + N2O extra terms (same for all igs of the band)
    def extra(coef_ch4, coef_n2o):
        f_ch4 = interp_k(jnp.asarray(coef_ch4, dtype), STANP_I, p, t, 245.0)
        f_n2o = interp_k(jnp.asarray(coef_n2o, dtype), STANP_I, p, t, 245.0)
        tg_ch4 = _qop_pair(f_ch4, 1.0, p, 6.3119e-6)
        tg_n2o = _qop_pair(f_n2o, 1.0, p, 1.10459e-6)
        return tg_ch4 / 1.6 * UMCH4 + tg_n2o / 0.28 * UMN2O

    ex10 = extra(pt.c10ch4, pt.c10n2o)
    ex11 = extra(pt.c11ch4, pt.c11n2o)
    off10 = int(np.searchsorted(pt.ir_band_of, 9))
    off11 = int(np.searchsorted(pt.ir_band_of, 10))
    tg_i = tg_i.at[off10:off10 + int(KG[9])].add(ex10[None, :])
    tg_i = tg_i.at[off11:off11 + int(KG[10])].add(ex11[None, :])

    # band 12 H2O extra term (same for all igs)
    f12 = interp_k(jnp.asarray(pt.c12h2o, dtype), STANP_I, p, t, 245.0)
    tg12 = _qop_pair(f12, xm1, p, 6.349205)
    off12 = int(np.searchsorted(pt.ir_band_of, 11))
    tg_i = tg_i.at[off12:off12 + int(KG[11])].add(tg12[None, :])

    tg = jnp.concatenate([tg_b1, tg_s, tg_i], axis=0)
    return tg, jnp.asarray(pt.hk, dtype)


# --------------------------------------------------------------------------
# cloud overlap, droplet optics, continuum, Planck
# --------------------------------------------------------------------------

def frr(frac):
    """Geleyn & Hollingsworth random-overlap continuity factors.

    frac: [nrlay] (top-down).  Returns bb [4, nrlay]; cc = 1 - bb.
    """
    nrlay = frac.shape[0]
    fm = jnp.concatenate([frac[:1] * 0.0, frac[:-1]])   # frac(j-1), top pad
    fp = jnp.concatenate([frac[1:], frac[-1:] * 0.0])   # frac(j+1), sfc pad
    j = jnp.arange(nrlay)

    def updown(fnb, is_edge):
        b_a = jnp.where(fnb < 1.0,
                        jnp.where(fnb < frac,
                                  (1.0 - frac) / jnp.maximum(1.0 - fnb, 1e-300),
                                  1.0),
                        1.0)
        b_b = jnp.where(fnb > 0.0,
                        jnp.where(fnb < 1.0,
                                  jnp.where(fnb < frac, 1.0,
                                            frac / jnp.maximum(fnb, 1e-300)),
                                  frac),
                        1.0)
        b1 = jnp.where(fnb > 0.0, b_a, 1.0 - frac)
        b1 = jnp.where(is_edge, 1.0, b1)
        b3 = jnp.where(is_edge, 1.0, b_b)
        return b1, b3

    b1, b3 = updown(fm, j == 0)
    b2, b4 = updown(fp, j == nrlay - 1)
    bb = jnp.stack([b1, b2, b3, b4])
    return bb, 1.0 - bb


def water_optics(tb: Pifm2Tables, frac, rew, rho2w, thk, dtype):
    """Droplet optics t2w/w2w/pl2w per band: [mb, nrlay], [mb, 2, nrlay]."""
    ret = jnp.asarray(tb.ret, dtype)  # tabulated effective radii [m]
    b2wt = jnp.asarray(tb.b2wt, dtype)  # [ncw, mb]
    w2wt = jnp.asarray(tb.w2wt, dtype)
    g2wt = jnp.asarray(tb.g2wt, dtype)
    ncw = ret.shape[0]

    k = jnp.clip(jnp.searchsorted(ret, rew) - 1, 0, ncw - 2)  # [nrlay]
    below = rew <= ret[0]
    above = rew >= ret[-1]

    bofr = b2wt / jnp.asarray(tb.r2wt, dtype)[:, None]        # [ncw, mb]
    b_lo, b_hi = bofr[k], bofr[k + 1]                         # [nrlay, mb]
    inv_interp = (b_hi - b_lo) / (1.0 / ret[k + 1] - 1.0 / ret[k])[:, None]
    b_int = b_lo + inv_interp * (1.0 / rew - 1.0 / ret[k])[:, None]
    b_val = jnp.where(below[:, None], bofr[0][None, :],
                      jnp.where(above[:, None], bofr[-1][None, :], b_int))

    lin = ((rew - ret[k]) / (ret[k + 1] - ret[k]))[:, None]
    w_val = jnp.where(below[:, None], w2wt[0][None, :],
                      jnp.where(above[:, None], w2wt[-1][None, :],
                                w2wt[k] + (w2wt[k + 1] - w2wt[k]) * lin))
    g_val = jnp.where(below[:, None], g2wt[0][None, :],
                      jnp.where(above[:, None], g2wt[-1][None, :],
                                g2wt[k] + (g2wt[k + 1] - g2wt[k]) * lin))

    cloud = rho2w >= 1.0e-5
    t2w = jnp.where(cloud[:, None], thk[:, None] * rho2w[:, None] * b_val,
                    0.0).T                                   # [mb, nrlay]
    w2w = jnp.where(cloud[:, None], w_val, 0.0).T
    g = jnp.where(cloud[:, None], g_val, 0.0).T              # [mb, nrlay]
    pl2w = jnp.stack([3.0 * g, 5.0 * g * g], axis=1)          # [mb, 2, nrlay]
    return t2w, w2w, pl2w


def qopcon(vv, t, p, xm1):
    """H2O continuum optical depth for one central wavenumber."""
    s = (418.0 + 557780.0 * jnp.exp(-0.00787 * vv)) / 101325.0
    p1 = p * xm1 / (0.622 + 0.378 * xm1)
    w = jnp.exp(1800.0 / t - 6.08108)
    ff = s * (p1 / 100.0 + 2.0e-5 * p) * w
    return (ff[:-1] * xm1[:-1] + ff[1:] * xm1[1:]) * (p[1:] - p[:-1]) \
        * 0.00509892


def plkavg(wnumlo, wnumhi, t):
    """Band-integrated Planck function [W/m2/sr * pi], vectorized.

    Matches the reference power/exponential series split (nrad.f90:
    1035-1160).
    """
    t = jnp.asarray(t)
    c2 = 1.438786
    conc = 15.0 / np.pi ** 4
    sigdpi = 5.67032e-8 / np.pi
    a = [1.0 / 3, -1.0 / 8, 1.0 / 60, -1.0 / 5040, 1.0 / 272160,
         -1.0 / 13305600]
    vcp = np.array([10.25, 5.7, 3.9, 2.9, 2.3, 1.9, 0.0])

    def band_integral(v):
        # power series branch
        vsq = v * v
        p = conc * vsq * v * (a[0] + v * (a[1] + v * (
            a[2] + vsq * (a[3] + vsq * (a[4] + vsq * a[5])))))
        # exponential series branch (mmax terms, masked):
        # mmax = 1 + number of leading vcp entries strictly above v
        mmax = jnp.searchsorted(-jnp.asarray(vcp, v.dtype),
                                -v, side="left") + 1
        ex = jnp.exp(-jnp.minimum(v, 80.0))
        d = jnp.zeros_like(v)
        exm = jnp.ones_like(v)
        for jm in range(1, 8):
            mv = jm * v
            exm = exm * ex
            term = exm * (6.0 + mv * (6.0 + mv * (3.0 + mv))) / jm ** 4
            d = d + jnp.where(jm <= mmax, term, 0.0)
        d = conc * d
        return p, d, v < 1.5

    # c2 [K cm] times wavenumber [cm^-1] over T [K] is dimensionless
    v1 = c2 * wnumlo / t
    v2 = c2 * wnumhi / t
    p1, d1, small1 = band_integral(v1)
    p2, d2, small2 = band_integral(v2)
    res = jnp.where(small1 & small2, p2 - p1,
                    jnp.where(small1 & ~small2, 1.0 - p1 - d2, d1 - d2))
    out = sigdpi * t ** 4 * res
    return jnp.where(t < 1.0e-4, 0.0, out)


# --------------------------------------------------------------------------
# total optical properties per (pair, cloud-part, layer)
# --------------------------------------------------------------------------

def total_tau(dtaur, taer, waer, plaer, tgcon, tg, t2w, w2w, pl2w):
    """Combine Rayleigh/aerosol/continuum/gas/droplet optics (SR tau).

    Shapes: dtaur/taer/waer/tgcon/t2w/w2w [P, nrlay]; plaer/pl2w
    [P, 2, nrlay]; tg [P, nrlay].
    Returns dtau/om [P, 2, nrlay], pl [P, 2, 2, nrlay] with axis 1 (pl: 2) =
    (cloud-free, cloudy).
    """
    dtau_f = dtaur + taer + tgcon + tg
    dtau_w = dtau_f + t2w
    zx1 = taer * waer
    zsum1 = dtaur + zx1
    zsum2 = zsum1 + t2w * w2w
    om_f = jnp.where(dtau_f > 1.0e-20, zsum1 / dtau_f, 0.0)
    om_w = jnp.where(dtau_f > 1.0e-20, zsum2 / dtau_w, 0.0)

    zf = dtaur[:, None, :] * jnp.stack(
        [jnp.zeros_like(dtaur), 0.5 * jnp.ones_like(dtaur)], axis=1) \
        + zx1[:, None, :] * plaer
    good = zsum1 >= 1.0e-20
    pl_f = jnp.where(good[:, None, :], zf / zsum1[:, None, :], 0.0)
    pl_w = jnp.where(good[:, None, :],
                     (zf + (t2w * w2w)[:, None, :] * pl2w)
                     / zsum2[:, None, :], 0.0)
    dtau = jnp.stack([dtau_f, dtau_w], axis=1)
    om = jnp.stack([om_f, om_w], axis=1)
    pl = jnp.stack([pl_f, pl_w], axis=2)  # [P, 2(jl), 2(jc), nrlay]
    return dtau, om, jnp.moveaxis(pl, 1, 2)  # -> [P, 2(jc), 2(jl), nrlay]


# --------------------------------------------------------------------------
# solar transfer coefficients + downward propagation (kurzw)
# --------------------------------------------------------------------------

def kurzw_coefficients(dtau, om, pl, u0):
    """Zdunkowski delta-Eddington coefficients a1..a6.

    dtau/om [P, 2, L]; pl [P, 2, 2, L]; u0 scalar.
    Returns a1..a6 each [P, 2, L].
    """
    u = 2.0
    u0s = jnp.maximum(u0, 1.0e-4)
    u0kw = 1.0 / u0s

    dtu0 = dtau * u0kw
    a6 = jnp.exp(-jnp.minimum(dtu0, 75.0))
    dtu = dtau * u

    ak = 1.0 - om
    p1 = pl[:, :, 0, :]
    f = pl[:, :, 1, :] / 5.0
    emf = 1.0 - f
    emfkw = 1.0 / emf
    ray = p1 >= 0.1
    b0 = jnp.where(ray, (3.0 - p1) / 8.0, 0.5)
    bu0 = jnp.where(ray, 0.5 - u0s / 4.0 * (p1 - 3.0 * f) * emfkw, 0.5)

    # --- case 4: absorption and scattering --------------------------------
    alph2 = u * b0 * om
    alph1 = u * ak + alph2
    alph3 = bu0 * om
    alph4 = om - alph3
    eps2 = alph1 ** 2 - alph2 ** 2
    eps = jnp.sqrt(jnp.maximum(eps2, 1e-300))
    omf = om * f
    emomf = 1.0 - omf

    # resonance correction: reduce u0 where |emomf^2 - u0^2 eps2| ~ 0
    def res_body(_, u0red):
        emu = emomf ** 2 - u0red ** 2 * eps2
        hit = jnp.abs(emu) <= 0.1e-6
        return jnp.where(hit, u0red - 0.001, u0red)

    u0red = jax.lax.fori_loop(0, 8, res_body, jnp.full_like(dtau, u0s))
    u02 = u0red ** 2
    emu = emomf ** 2 - u02 * eps2

    a1_4 = jnp.exp(-jnp.minimum(dtu0 * emomf, 75.0))
    e = jnp.exp(-jnp.minimum(dtau * eps, 75.0))
    m = alph2 / (alph1 + eps)
    e2, m2 = e * e, m * m
    ouf = 1.0 / (1.0 - e2 * m2)
    a4_4 = e * (1.0 - m2) * ouf
    a5_4 = m * (1.0 - e2) * ouf
    te = emf / emu
    u0a1 = u0red * alph1
    u0a2 = u0red * alph2
    gam1 = (alph3 * (emomf - u0a1) - u0a2 * alph4) * te
    gam2 = -(alph4 * (emomf + u0a1) + u0a2 * alph3) * te
    g1a1 = gam1 * a1_4
    da = a1_4 - a4_4
    a2_4 = gam2 * da - a5_4 * g1a1
    a3_4 = -gam2 * a5_4 - a4_4 * g1a1 + gam1

    # --- case 3: pure scattering (ak < 1e-3) ------------------------------
    alph1_3 = u * b0
    alph3_3 = bu0
    gam1_3 = alph3_3 - alph1_3 * u0s * emfkw
    a1_3 = jnp.exp(-jnp.minimum(dtu0 * emf, 75.0))
    a4_3 = 1.0 / (1.0 + alph1_3 * dtau)
    a2_3 = a4_3 * (1.0 - gam1_3 * (1.0 - a1_3)) - a1_3
    a3_3 = 1.0 - a1_3 - a2_3
    a5_3 = 1.0 - a4_3

    # --- case 2: no scattering (om < 0.03) --------------------------------
    a4_2 = jnp.exp(-jnp.minimum(dtu, 75.0))

    # --- select -----------------------------------------------------------
    no_ext = dtau <= 1.0e-7
    no_scat = om < 0.03
    no_abs = ak < 0.001

    def sel(v4, v3, v2, v1):
        out = jnp.where(no_abs, v3, v4)
        out = jnp.where(no_scat, v2, out)
        return jnp.where(no_ext, v1, out)

    one = jnp.ones_like(dtau)
    zero = jnp.zeros_like(dtau)
    a1 = sel(a1_4, a1_3, a6, one)
    a2 = sel(a2_4, a2_3, zero, zero)
    a3 = sel(a3_4, a3_3, zero, zero)
    a4 = sel(a4_4, a4_3, a4_2, one)
    a5 = sel(a5_4, a5_3, zero, zero)
    a6 = jnp.where(no_ext, one, a6)
    return a1, a2, a3, a4, a5, a6


def kurzw_propagate(a1, a2, a3, a6, bb, cc, u0, albedo_pair):
    """Top-down propagation of parallel fluxes (kurzw, nrad.f90:2638-2688).

    a-coefficients [P, 2, L]; bb/cc [4, L]; albedo_pair [P].
    Returns sf, sw, ssf, ssw [P, L+1] and initial f1f/f1w/f2f/f2w parts.
    """
    P, _, L = a1.shape

    def step(carry, inp):
        ssf, ssw, sf, sw = carry
        a1f, a1w, a2f, a2w, a3f, a3w, a6f, a6w, bb1, cc3 = inp
        ua = bb1 * ssf
        ub = ssf - ua
        uc = bb1 * sf
        ud = sf - uc
        va = cc3 * ssw
        vb = ssw - va
        vc = cc3 * sw
        vd = sw - vc
        wa, wb, wc, wd = ua + va, ub + vb, uc + vc, ud + vd
        ssf_n = a1f * wa
        ssw_n = a1w * wb
        sf_n = a6f * wc
        sw_n = a6w * wd
        f2f_n = a2f * wa
        f2w_n = a2w * wb
        f1f_j = a3f * wa
        f1w_j = a3w * wb
        return (ssf_n, ssw_n, sf_n, sw_n), \
            (ssf_n, ssw_n, sf_n, sw_n, f2f_n, f2w_n, f1f_j, f1w_j)

    dtype = a1.dtype
    init = (jnp.full((P,), u0, dtype), jnp.zeros((P,), dtype),
            jnp.full((P,), u0, dtype), jnp.zeros((P,), dtype))
    # NB first layer: the reference uses ua (from ssf) also for the direct
    # flux sf(2); since sf(1)=ssf(1)=u0 the unified formula is identical.
    inputs = (a1[:, 0].T, a1[:, 1].T, a2[:, 0].T, a2[:, 1].T,
              a3[:, 0].T, a3[:, 1].T, a6[:, 0].T, a6[:, 1].T,
              bb[0][:, None] * jnp.ones((1, P), dtype),
              cc[2][:, None] * jnp.ones((1, P), dtype))
    _, outs = jax.lax.scan(step, init, inputs)
    ssf_n, ssw_n, sf_n, sw_n, f2f_n, f2w_n, f1f_j, f1w_j = outs

    ssf = jnp.concatenate([init[0][None], ssf_n]).T   # [P, L+1]
    ssw = jnp.concatenate([init[1][None], ssw_n]).T
    sf = jnp.concatenate([init[2][None], sf_n]).T
    sw = jnp.concatenate([init[3][None], sw_n]).T
    f2f = jnp.concatenate([jnp.zeros((1, P), dtype), f2f_n]).T
    f2w = jnp.concatenate([jnp.zeros((1, P), dtype), f2w_n]).T
    f1f = jnp.concatenate([f1f_j, jnp.zeros((1, P), dtype)]).T
    f1w = jnp.concatenate([f1w_j, jnp.zeros((1, P), dtype)]).T
    f1f = f1f.at[:, L].set(albedo_pair * ssf[:, L])
    f1w = f1w.at[:, L].set(albedo_pair * ssw[:, L])
    return sf, sw, ssf, ssw, f1f, f1w, f2f, f2w


# --------------------------------------------------------------------------
# IR transfer coefficients + right-hand side (langw)
# --------------------------------------------------------------------------

def langw_coefficients(dtau, om, pl):
    """IR two-stream coefficients a4, a5, a6 [P, 2, L]."""
    u = 1.66
    dtu = dtau * u
    ak = 1.0 - om
    b0 = (3.0 - pl[:, :, 0, :]) / 8.0
    alph1 = u * (1.0 - (1.0 - b0) * om)
    alph2 = u * b0 * om

    # case 4: absorption and scattering
    eps = jnp.sqrt(jnp.maximum(alph1 ** 2 - alph2 ** 2, 1e-300))
    epstau = eps * dtau
    e = jnp.where(epstau < 87.0, jnp.exp(-jnp.minimum(epstau, 87.0)), 0.0)
    rm = alph2 / (alph1 + eps)
    eq, rmq = e * e, rm * rm
    rn = 1.0 - eq * rmq
    a4_4 = e * (1.0 - rmq) / rn
    a5_4 = rm * (1.0 - eq) / rn
    denom = (alph1 + alph2) * dtau
    a6_4 = jnp.where(jnp.abs(alph1 + alph2) >= 1e-300,
                     (1.0 - a4_4 - a5_4) / jnp.maximum(denom, 1e-300), 1.0)

    # case 3: no absorption
    at = alph1 * dtau
    a4_3 = 1.0 / (1.0 + at)
    a5_3 = a4_3 * at
    a6_3 = jnp.zeros_like(dtau)

    # case 2: no scattering
    a4_2 = jnp.exp(-jnp.minimum(dtu, 75.0))
    a6_2 = (1.0 - a4_2) / dtu

    no_ext = dtau <= 1.0e-7
    no_scat = om <= 1.0e-7
    no_abs = ak <= 1.0e-7

    a4 = jnp.where(no_abs, a4_3, a4_4)
    a5 = jnp.where(no_abs, a5_3, a5_4)
    a6 = jnp.where(no_abs, a6_3, a6_4)
    a4 = jnp.where(no_scat, a4_2, a4)
    a5 = jnp.where(no_scat, 0.0, a5)
    a6 = jnp.where(no_scat, a6_2, a6)
    one = jnp.ones_like(dtau)
    a4 = jnp.where(no_ext, one, a4)
    a5 = jnp.where(no_ext, 0.0, a5)
    a6 = jnp.where(no_ext, one, a6)
    return a4, a5, a6


def langw_rhs(a4, a5, a6, pib, pibs, frac, emis_pair, bb):
    """Right-hand side of the IR diffuse system (langw, nrad.f90:2851-2886).

    pib [P, L+1]; pibs [P]; frac [L]; emis_pair [P].
    Returns f1f, f1w, f2f, f2w [P, L+1].
    """
    P, _, L = a4.shape
    db = pib[:, :-1] - pib[:, 1:]                       # [P, L]
    f1f = (1.0 - frac)[None, :] * a6[:, 0, :] * db
    f1w = frac[None, :] * a6[:, 1, :] * db
    f2f = jnp.concatenate([pib[:, :1], -f1f], axis=1)   # [P, L+1]
    f2w = jnp.concatenate([jnp.zeros((P, 1), a4.dtype), -f1w], axis=1)

    agdb = emis_pair * (pib[:, L] - pibs) \
        + (1.0 - emis_pair) ** 2 * (pib[:, L] - pib[:, L - 1]) \
        * a6[:, 0, L - 1] * (1.0 - frac[L - 1])
    f1w_sfc = agdb * frac[L - 1]
    f1f_sfc = agdb - f1w_sfc
    f1f = jnp.concatenate([f1f, f1f_sfc[:, None]], axis=1)
    f1w = jnp.concatenate([f1w, f1w_sfc[:, None]], axis=1)

    # upper boundary condition folded into the first interior equations
    ha = bb[0, 0] * f2f[:, 0]
    hb = f2f[:, 0] - ha
    f2f = f2f.at[:, 1].add(a4[:, 0, 0] * ha)
    f1f = f1f.at[:, 0].add(a5[:, 0, 0] * ha)
    f2w = f2w.at[:, 1].add(a4[:, 1, 0] * hb)
    f1w = f1w.at[:, 0].add(a5[:, 1, 0] * hb)
    return f1f, f1w, f2f, f2w


# --------------------------------------------------------------------------
# block-tridiagonal elimination + back-substitution (jeanfr)
# --------------------------------------------------------------------------

def jeanfr(a4, a5, bb, cc, f1f, f1w, f2f, f2w, ae_pair):
    """Solve the diffuse-flux system (jeanfr, nrad.f90:2887-3043).

    a4/a5 [P, 2, L]; bb/cc [4, L]; flux right-hand sides [P, L+1];
    ae_pair [P] albedo (solar) or 1-emissivity (IR).
    Returns updated f1f, f1w, f2f, f2w.
    """
    P, _, L = a4.shape
    dtype = a4.dtype

    # first-layer upper-diagonal elements
    tu0 = jnp.stack([
        jnp.zeros((P,), dtype),
        a4[:, 0, 0] * bb[1, 0], a4[:, 0, 0] * cc[3, 0],
        a4[:, 1, 0] * cc[1, 0], a4[:, 1, 0] * bb[3, 0],
        a5[:, 0, 0] * bb[1, 0], a5[:, 0, 0] * cc[3, 0],
        a5[:, 1, 0] * cc[1, 0], a5[:, 1, 0] * bb[3, 0]], axis=0)  # [9, P]

    def fwd(carry, inp):
        tu_m, f2f_j, f2w_j = carry
        (a4f, a4w, a5f, a5w, bb1, bb2, bb4, cc1, cc3, cc4,
         f1f_j, f1w_j, f2f_jp, f2w_jp) = inp
        ga = bb1 * tu_m[5]
        gb = tu_m[5] - ga
        gc = cc3 * tu_m[7]
        gd = tu_m[7] - gc
        ha = ga + gc
        hc = gb + gd
        ga = bb1 * tu_m[6]
        gb = tu_m[6] - ga
        gc = cc3 * tu_m[8]
        gd = tu_m[8] - gc
        hb = ga + gc
        hd = gb + gd
        ga = bb1 * f2f_j
        ge = f2f_j - ga
        gc = cc3 * f2w_j
        gf = f2w_j - gc
        gb = ga + gc
        gd = ge + gf
        td1 = 1.0 / (1.0 - a5f * ha)
        f1f_o = td1 * (f1f_j + a5f * gb)
        tu1 = td1 * a5f * hb
        fa = td1 * a4f
        tu2 = fa * bb2
        tu3 = fa * cc4
        td2 = a5w * hc
        td3 = 1.0 / (1.0 - a5w * hd - td2 * tu1)
        f1w_o = td3 * (f1w_j + a5w * gd + td2 * f1f_o)
        td4 = a4f * ha
        td5 = a4f * hb + td4 * tu1
        f2f_o = f2f_jp + a4f * gb + td4 * f1f_o + td5 * f1w_o
        tu4 = td3 * (a4w * cc1 + td2 * tu2)
        tu5 = td3 * (a4w * bb4 + td2 * tu3)
        tu6 = a5f * bb2 + td4 * tu2 + td5 * tu4
        tu7 = a5f * cc4 + td4 * tu3 + td5 * tu5
        td6 = a4w * hc
        td7 = a4w * hd + td6 * tu1
        f2w_o = f2w_jp + a4w * gd + td6 * f1f_o + td7 * f1w_o
        tu8 = a5w * cc1 + td6 * tu2 + td7 * tu4
        tu9 = a5w * bb4 + td6 * tu3 + td7 * tu5
        tu = jnp.stack([tu1, tu2, tu3, tu4, tu5, tu6, tu7, tu8, tu9])
        return (tu, f2f_o, f2w_o), (tu, f1f_o, f1w_o, f2f_o, f2w_o)

    idx = jnp.arange(1, L)
    inputs = (a4[:, 0, 1:].T, a4[:, 1, 1:].T, a5[:, 0, 1:].T, a5[:, 1, 1:].T,
              bb[0, 1:][:, None] * jnp.ones((1, P), dtype),
              bb[1, 1:][:, None] * jnp.ones((1, P), dtype),
              bb[3, 1:][:, None] * jnp.ones((1, P), dtype),
              cc[1, 1:][:, None] * jnp.ones((1, P), dtype),
              cc[2, 1:][:, None] * jnp.ones((1, P), dtype),
              cc[3, 1:][:, None] * jnp.ones((1, P), dtype),
              f1f[:, 1:L].T, f1w[:, 1:L].T, f2f[:, 2:L + 1].T,
              f2w[:, 2:L + 1].T)
    (tu_last, f2f_last, f2w_last), (tus, f1f_n, f1w_n, f2f_n, f2w_n) = \
        jax.lax.scan(fwd, (tu0, f2f[:, 1], f2w[:, 1]), inputs)

    # assembled per-layer arrays (layer 0 from the initial values)
    tu_all = jnp.concatenate([tu0[None], tus], axis=0)        # [L, 9, P]
    f1f = f1f.at[:, 1:L].set(f1f_n.T)
    f1w = f1w.at[:, 1:L].set(f1w_n.T)
    f2f = f2f.at[:, 2:L + 1].set(f2f_n.T)
    f2w = f2w.at[:, 2:L + 1].set(f2w_n.T)

    # surface elimination
    tds1 = 1.0 / (1.0 - ae_pair * tu_all[L - 1, 5])
    f1f = f1f.at[:, L].set(tds1 * (f1f[:, L] + ae_pair * f2f[:, L]))
    tus1 = tds1 * ae_pair * tu_all[L - 1, 6]
    tds2 = ae_pair * tu_all[L - 1, 7]
    tds3 = 1.0 / (1.0 - ae_pair * tu_all[L - 1, 8] - tds2 * tus1)
    f1w = f1w.at[:, L].set(
        tds3 * (f1w[:, L] + ae_pair * f2w[:, L] + tds2 * f1f[:, L]))
    f1f = f1f.at[:, L].add(tus1 * f1w[:, L])

    # back-substitution bottom-up
    def bwd(carry, inp):
        f1f_jp, f1w_jp = carry
        tu, f1f_j, f1w_j, f2f_jp, f2w_jp = inp
        f2w_o = f2w_jp + tu[7] * f1f_jp + tu[8] * f1w_jp
        f2f_o = f2f_jp + tu[5] * f1f_jp + tu[6] * f1w_jp
        f1w_o = f1w_j + tu[3] * f1f_jp + tu[4] * f1w_jp
        f1f_o = f1f_j + tu[1] * f1f_jp + tu[2] * f1w_jp + tu[0] * f1w_o
        return (f1f_o, f1w_o), (f1f_o, f1w_o, f2f_o, f2w_o)

    inputs_b = (tu_all, f1f[:, :L].T, f1w[:, :L].T,
                f2f[:, 1:L + 1].T, f2w[:, 1:L + 1].T)
    (_, _), (f1f_b, f1w_b, f2f_b, f2w_b) = jax.lax.scan(
        bwd, (f1f[:, L], f1w[:, L]), inputs_b, reverse=True)

    f1f = f1f.at[:, :L].set(f1f_b.T)
    f1w = f1w.at[:, :L].set(f1w_b.T)
    f2f = f2f.at[:, 1:L + 1].set(f2f_b.T)
    f2w = f2w.at[:, 1:L + 1].set(f2w_b.T)
    return f1f, f1w, f2f, f2w
