"""Seeded generator of the physics input tables, in the reference formats.

The reference model reads eight table files from its ``input/`` directory
for a run with microphysics and radiation on (chemistry off): the Clarke
surface-layer functions, the PIFM2 correlated-k coefficient file and six
Mie tables.  Where those files are not available this module writes
stand-ins with the same shapes and file formats, so that the unchanged
loaders (``physics.surface.load_clarke_table``,
``radiation.tables.load_pifm2``, ``radiation.tables.load_mie_tables``)
read them and the model runs.  They are physically plausible, not the
reference data: results computed with them are labelled synthetic.

* ``clarke.dat``: u/u* and the heat analogue from the Louis (1979)
  bulk-Richardson-number stability functions (b = c = d = 5, neutral
  Prandtl number 0.74), tabulated on 18 stability x 7 ln(z/z0) nodes.
* ``pifm2_171115.dat``: band k-distributions with geometric k spacing,
  quadrature weights that sum to one per band, a 1361 W/m2 solar
  constant split over the 6 solar bands, non-negative gas, droplet,
  aerosol and Rayleigh coefficients, and a Gaussian stratospheric ozone
  layer of 300 DU.
* ``{urban,rural,ozean}{kw,lw}.dat``: anomalous-diffraction Mie
  efficiencies of water/aerosol mixtures, with ``qabs <= qext`` and
  ``0 < asym < 1``.

Usage (writes ``build/synthetic_inputs`` inside the checkout)::

    python -m mistra_tpu.io.synthetic_inputs [--out DIR] [--seed 0]

and then ``INPDIR=build/synthetic_inputs`` (or ``inpdir=`` in
``MistraConfig``) chooses them.  Every model built on them prints a line
saying so (``announce_if_synthetic``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..paths import BUILD_DIR
from ..radiation.tables import KG, MB, MBIR, MBS, NCW, XA0, XW0

DEFAULT_DIR = os.path.join(BUILD_DIR, "synthetic_inputs")
MARKER = "SYNTHETIC_INPUTS"
FILES = ("clarke.dat", "pifm2_171115.dat", "urbankw.dat", "urbanlw.dat",
         "ruralkw.dat", "rurallw.dat", "ozeankw.dat", "ozeanlw.dat")

KAPPA = 0.4
SOLAR_CONSTANT = 1361.0          # W/m2 (Kopp & Lean 2011)
# fraction of the solar constant in the 6 PIFM2 solar bands
# (0.2-0.7, 0.7-1.3, 1.3-1.9, 1.9-2.5, 2.5-3.5, 3.5-4.0 um)
SOLAR_FRACTION = np.array([0.476, 0.330, 0.111, 0.050, 0.024, 0.009])
# centre wavelengths [um] of the 18 bands (6 solar, 12 IR)
WAVELENGTH = np.concatenate([
    [0.45, 1.0, 1.6, 2.2, 3.0, 3.75],
    1.0e4 / np.array([2050.0, 1800.0, 1550.0, 1325.0, 1175.0, 1040.0,
                      890.0, 735.0, 605.0, 470.0, 340.0, 140.0])])

# stability (bulk Richardson number) and ln(z/z0) nodes of clarke.dat
XZPDL = np.array([-5.5, -4.0, -3.0, -2.0, -1.5, -1.0, -0.7, -0.5, -0.3,
                  -0.2, -0.1, -0.05, 0.0, 0.05, 0.1, 0.3, 1.0, 3.0])
XZPDZ0 = np.array([1.0, 3.0, 5.0, 7.0, 10.0, 13.0, 17.0])


# --------------------------------------------------------------------------
# formats
# --------------------------------------------------------------------------

def _e16(values) -> str:
    """Fortran-order values as 8 e16.8 fields per line."""
    flat = np.asarray(values, np.float64).ravel(order="F")
    lines = []
    for i in range(0, flat.size, 8):
        lines.append("".join(f"{v:16.8e}" for v in flat[i:i + 8]))
    return "\n".join(lines)


def _write(path: str, text: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# clarke.dat: Louis (1979) surface-layer similarity
# --------------------------------------------------------------------------

def clarke_functions():
    """fu, ft [18, 7] on (XZPDL, XZPDZ0).

    With a = kappa / ln(z/z0), Rib the bulk Richardson number and
    b = c = d = 5 (Louis 1979):
      unstable  F_m = 1 - 2b Rib / (1 + 3bc a^2 sqrt(-Rib z/z0))
                F_h = 1 - 3b Rib / (1 + 3bc a^2 sqrt(-Rib z/z0))
      stable    F_m = 1 / (1 + 2b Rib / sqrt(1 + d Rib))
                F_h = 1 / (1 + 3b Rib sqrt(1 + d Rib))
    C_D = a^2 F_m gives fu = u/u* = 1/sqrt(C_D); with C_H = a^2 F_h / Pr
    (Pr = 0.74) the heat function is ctq = 1/(C_H fu), tabulated as
    ft = ctq / Pr (the loader's claf divides by 1.35 = 1/Pr).
    """
    b = c = d = 5.0
    rib = XZPDL[:, None]
    lnz = XZPDZ0[None, :]
    a2 = (KAPPA / lnz) ** 2
    z_z0 = np.exp(lnz)
    root = 1.0 + 3.0 * b * c * a2 * np.sqrt(np.maximum(-rib, 0.0) * z_z0)
    ris = np.maximum(rib, 0.0)
    fm = np.where(rib < 0.0, 1.0 - 2.0 * b * rib / root,
                  1.0 / (1.0 + 2.0 * b * ris / np.sqrt(1.0 + d * ris)))
    fh = np.where(rib < 0.0, 1.0 - 3.0 * b * rib / root,
                  1.0 / (1.0 + 3.0 * b * ris * np.sqrt(1.0 + d * ris)))
    fu = 1.0 / np.sqrt(a2 * fm)
    ft = lnz * np.sqrt(fm) / (KAPPA * fh)
    return fu, ft


def clarke_text() -> str:
    fu, ft = clarke_functions()
    # the loader reads fu/ft with the stability index fastest
    vals = np.concatenate([fu.ravel(order="F"), ft.ravel(order="F"),
                           XZPDL, XZPDZ0])
    return "\n".join(" ".join(f"{v:.8e}" for v in vals[i:i + 7])
                     for i in range(0, vals.size, 7)) + "\n"


# --------------------------------------------------------------------------
# pifm2_171115.dat
# --------------------------------------------------------------------------

STANP_S = np.array([1000., 1580., 2510., 3980., 6310., 10000., 15800.,
                    25100., 39800., 63100., 100000.])
STANP_I = np.array([25.1, 39.8, 63.1, 100., 158., 251., 398., 631., 1000.,
                    1580., 2510., 3980., 6310., 10000., 15800., 25100.,
                    39800., 63100., 100000.])
# H2O column optical depth range (weakest, strongest k) per band, used to
# size the k-distributions: the solver's optical depth of a column with
# water-vapour path W is about 12.7 * g * W * k = 3114 k for W = 25 kg/m2
_H2O_TAU = {2: (1e-3, 10.), 3: (1e-2, 100.), 4: (1e-2, 100.),
            5: (0.1, 1000.), 6: (1e-2, 100.), 7: (1e-2, 3.),
            8: (0.1, 300.), 9: (1.0, 1000.), 10: (0.05, 30.),
            11: (5e-3, 3.), 12: (0.02, 0.1), 13: (1e-3, 0.1),
            14: (0.1, 10.), 15: (0.1, 10.), 16: (0.1, 30.),
            17: (0.5, 300.), 18: (1.0, 3000.)}
_H2O_TAU_PER_K = 3114.0


def _weights(rng, n):
    """Quadrature weights: most weight on the weak (window) k, a seeded
    +-10 % perturbation, normalized to sum 1."""
    w = np.exp(-0.45 * np.arange(n)) * rng.uniform(0.9, 1.1, n)
    return w / w.sum()


def _lnk_table(rng, tau_lo, tau_hi, n, stanp, tau_per_k):
    """ln-k polynomial coefficients [3, np, n]: geometric k spacing over
    the optical-depth range, pressure broadening k ~ (p/1e5)^0.5, weak
    temperature dependence."""
    k = np.geomspace(tau_lo, tau_hi, n) / tau_per_k
    k = k * rng.uniform(0.95, 1.05, n)
    out = np.zeros((3, len(stanp), n))
    out[0] = np.log(k)[None, :] + 0.5 * np.log(stanp / 1.0e5)[:, None]
    out[1] = 2.0e-3
    out[2] = -1.0e-5
    return out


def _planck_band(t, nu_lo, nu_hi, npts=400):
    """pi * band-integrated Planck radiance [W/m2] by the midpoint rule."""
    c1, c2 = 1.191042e-8, 1.4387770      # W/(m2 sr cm^-4), cm K
    edges = np.linspace(max(nu_lo, 1e-3), nu_hi, npts + 1)
    nu = 0.5 * (edges[1:] + edges[:-1])
    bnu = c1 * nu ** 3 / np.expm1(c2 * nu / t[:, None])
    return np.pi * (bnu * np.diff(edges)).sum(axis=1)


def pifm2_blocks(seed: int = 0):
    """(name, array) blocks in the order the loader reads them."""
    rng = np.random.default_rng(seed)
    blocks = []
    ttab = np.arange(35) * 5.0 + 170.0
    wvl = np.array([2200.0, 1900.0, 1700.0, 1400.0, 1250.0, 1100.0, 980.0,
                    800.0, 670.0, 540.0, 400.0, 280.0, 0.0])
    pibtab = np.stack([_planck_band(ttab, wvl[b + 1], wvl[b])
                       for b in range(MBIR)], axis=1)
    blocks += [("ttab", ttab), ("pibtab", pibtab)]

    # droplet optics: extinction per unit liquid water 3/(2 rho_w r_e),
    # single-scattering albedo and asymmetry per band
    ret = np.geomspace(4.18e-6, 3.123e-5, NCW)
    r2wt = np.ones(NCW)
    b2wt = np.repeat((1.5 / (1000.0 * ret))[:, None], MB, axis=1)
    w_band = np.concatenate([[0.99999, 0.9999, 0.995, 0.98, 0.8, 0.9],
                             np.full(MBIR, 0.5)])
    w2wt = np.repeat(w_band[None, :], NCW, axis=0) \
        - 0.002 * np.log(ret / ret[0])[:, None]
    g2wt = np.clip(0.80 + 0.03 * np.log(ret / ret[0])[:, None]
                   + np.zeros((1, MB)), 0.0, 0.95)
    blocks += [("ret", ret), ("r2wt", r2wt), ("b2wt", b2wt),
               ("w2wt", w2wt), ("g2wt", g2wt)]

    # aerosol optics per particle [m2] at 8 relative humidities, 4 types
    feux = np.array([0.0, 0.5, 0.7, 0.8, 0.9, 0.95, 0.98, 0.99])
    growth = (1.0 + 1.5 * feux ** 4 / (1.0 - 0.5 * feux))[:, None, None]
    spectral = np.concatenate([[1.0, 0.7, 0.45, 0.3, 0.2, 0.15],
                               np.full(MBIR, 0.06)])[None, :, None]
    typ = np.array([1.2, 1.0, 1.5, 0.6])[None, None, :]
    seanew = 1.0e-13 * growth * spectral * typ
    omega = np.where(np.arange(MB) < MBS, 0.95, 0.5)[None, :, None] \
        * np.ones((8, 1, 4))
    saanew = seanew * (1.0 - omega)
    ganew = np.where(np.arange(MB) < MBS, 0.7, 0.4)[None, :, None] \
        * np.ones((8, 1, 4))
    blocks += [("feux", feux), ("seanew", seanew), ("saanew", saanew),
               ("ganew", ganew)]

    s0b = SOLAR_CONSTANT * SOLAR_FRACTION / SOLAR_FRACTION.sum()
    blocks.append(("s0b", s0b))

    # band 1: ozone k [(atm-cm)^-1]; column depth ~ 2 k U, U = 0.3 atm-cm
    blocks.append(("hk1", _weights(rng, KG[0])))
    blocks.append(("fk1o3", np.geomspace(0.02, 200.0, KG[0])))

    def h2o(b, stanp):
        lo, hi = _H2O_TAU[b]
        return _lnk_table(rng, lo, hi, KG[b - 1], stanp, _H2O_TAU_PER_K)

    for b in range(2, 7):
        blocks += [(f"hk{b}", _weights(rng, KG[b - 1])),
                   (f"c{b}h2o", h2o(b, STANP_S))]
    for b in (7, 8, 9):
        blocks += [(f"hk{b}", _weights(rng, KG[b - 1])),
                   (f"c{b}h2o", h2o(b, STANP_I))]
    # bands 10, 11: H2O plus band-wide CH4 (depth ~1.26 k) and N2O
    # (~0.22 k) terms
    for b, (ch4, n2o) in ((10, (0.5, 0.3)), (11, (0.2, 0.1))):
        blocks += [(f"hk{b}", _weights(rng, KG[b - 1])),
                   (f"c{b}h2o", h2o(b, STANP_I)),
                   (f"c{b}ch4", _lnk_table(rng, ch4, ch4, 1, STANP_I,
                                           1.26)[..., 0]),
                   (f"c{b}n2o", _lnk_table(rng, n2o, n2o, 1, STANP_I,
                                           0.22)[..., 0])]
    # band 12: ozone 9.6 um (depth ~ 2 k U) plus a weak H2O term
    blocks += [("hk12", _weights(rng, KG[11])),
               ("c12o3", _lnk_table(rng, 3e-3, 3.0, KG[11], STANP_I, 0.6)),
               ("c12h2o", h2o(12, STANP_I)[..., 0])]
    blocks += [("hk13", _weights(rng, KG[12])),
               ("c13h2o", h2o(13, STANP_I))]
    # bands 14, 15: CO2 15 um (depth ~ 0.01 k * column dp = 1000 k) with
    # the H2O overlap term (depth ~ 2.45 k)
    for b, (lo, hi) in ((14, (0.1, 3000.0)), (15, (0.05, 1000.0))):
        blocks += [(f"hk{b}", _weights(rng, KG[b - 1])),
                   (f"c{b}hca", _lnk_table(rng, lo, hi, KG[b - 1], STANP_I,
                                           1000.0)),
                   (f"c{b}hcb", _lnk_table(rng, *_H2O_TAU[b], KG[b - 1],
                                           STANP_I, 2.45))]
    for b in (16, 17, 18):
        blocks += [(f"hk{b}", _weights(rng, KG[b - 1])),
                   (f"c{b}h2o", h2o(b, STANP_I))]

    # ozone column above each km, 0..51 km [0.01 atm-cm]: a Gaussian
    # layer at 22 km (sigma 6 km) holding 300 DU
    from math import erf, sqrt
    z = np.arange(52, dtype=float)
    above = np.array([0.5 * (1.0 - erf((zk - 22.0) / (6.0 * sqrt(2.0))))
                      for zk in z])
    o3un = 30.0 * above / above[0]
    # Rayleigh extinction per metre of surface-density air per band
    berayl = np.array([0.15, 0.015, 2e-3, 5e-4, 1.5e-4, 6e-5]) / 8000.0
    blocks += [("o3un", o3un), ("berayl", berayl)]
    return blocks


def pifm2_text(seed: int = 0) -> str:
    parts = []
    for name, arr in pifm2_blocks(seed):
        parts.append(f" {name} (synthetic)")
        parts.append(_e16(arr))
    return "\n".join(parts) + "\n"


# --------------------------------------------------------------------------
# Mie tables
# --------------------------------------------------------------------------

# refractive indices: water, and the dry aerosol of each file type
_N_WATER = 1.33
_K_WATER = np.array([1e-8, 1e-6, 1e-4, 5e-4, 0.1, 5e-3,
                     0.01, 0.05, 0.1, 0.03, 0.03, 0.04, 0.06, 0.15, 0.35,
                     0.4, 0.45, 0.4])
_AEROSOL = {"urban": (1.55, 0.03, 0.1), "rural": (1.53, 5e-3, 0.05),
            "ozean": (1.50, 1e-8, 0.02)}


def mie_efficiencies(n_re, n_im, x):
    """Anomalous-diffraction extinction and absorption efficiencies and
    an asymmetry parameter for size parameter x (arrays broadcast)."""
    rho = np.maximum(2.0 * x * (n_re - 1.0), 1e-6)
    qext = 2.0 - 4.0 / rho * np.sin(rho) + 4.0 / rho ** 2 * (1.0 - np.cos(
        rho))
    w = np.maximum(4.0 * x * n_im, 1e-12)
    qabs_ada = 1.0 + 2.0 * np.exp(-w) / w + 2.0 * (np.exp(-w) - 1.0) / w ** 2
    qext = np.maximum(qext, 1e-6)
    qabs = np.minimum(np.maximum(qabs_ada, 0.0), 0.999 * qext)
    asym = 0.02 + 0.83 * x ** 2 / (x ** 2 + 4.0)
    return np.broadcast_arrays(qabs, qext, asym)


def mie_text(kind: str, solar: bool, seed: int = 0) -> str:
    """One Mie file: a record (qabs qext asym 0 0) per (xa0, xw0, band),
    band fastest."""
    rng = np.random.default_rng(seed + (0 if solar else 1)
                                + 10 * sorted(_AEROSOL).index(kind))
    n_a, k_a_solar, k_a_ir = _AEROSOL[kind]
    bands = np.arange(MBS) if solar else np.arange(MBS, MB)
    lam = WAVELENGTH[bands]
    k_a = np.where(bands < MBS, k_a_solar, k_a_ir)
    xa = XA0[:, None, None]                       # water volume fraction
    r = XW0[None, :, None]                        # radius [um]
    n_re = xa * _N_WATER + (1.0 - xa) * n_a
    n_im = xa * _K_WATER[bands][None, None, :] + (1.0 - xa) * k_a
    x = 2.0 * np.pi * r / lam[None, None, :]
    qabs, qext, asym = mie_efficiencies(n_re, n_im, x)
    jitter = rng.uniform(0.98, 1.02, qext.shape)
    qext = qext * jitter
    qabs = np.minimum(qabs * jitter, 0.999 * qext)
    rows = []
    for ia in range(len(XA0)):
        for iw in range(len(XW0)):
            for ib in range(len(bands)):
                rows.append(f"{qabs[ia, iw, ib]:14.6e} {qext[ia, iw, ib]:14.6e}"
                            f" {asym[ia, iw, ib]:14.6e} {0.0:6.3f} {0.0:6.3f}")
    return "\n".join(rows) + "\n"


# --------------------------------------------------------------------------

def write_synthetic_inputs(out: str = DEFAULT_DIR, seed: int = 0) -> str:
    """Write all eight tables into ``out`` (atomically, file by file) and
    a marker file naming the seed; returns ``out``."""
    os.makedirs(out, exist_ok=True)
    _write(os.path.join(out, "clarke.dat"), clarke_text())
    _write(os.path.join(out, "pifm2_171115.dat"), pifm2_text(seed))
    for kind in ("urban", "rural", "ozean"):
        _write(os.path.join(out, f"{kind}kw.dat"), mie_text(kind, True, seed))
        _write(os.path.join(out, f"{kind}lw.dat"), mie_text(kind, False,
                                                            seed))
    _write(os.path.join(out, MARKER),
           f"synthetic input tables, seed {seed}; "
           f"python -m mistra_tpu.io.synthetic_inputs\n")
    return out


def ensure_synthetic_inputs(out: str = DEFAULT_DIR, seed: int = 0) -> str:
    """The directory of generated tables, writing them if incomplete."""
    marker = os.path.join(out, MARKER)
    if not (os.path.exists(marker) and all(
            os.path.exists(os.path.join(out, f)) for f in FILES)):
        write_synthetic_inputs(out, seed)
    return out


_ANNOUNCED = set()


def announce_if_synthetic(inpdir: str) -> bool:
    """Print one line per process and directory when ``inpdir`` holds
    generated tables; returns whether it does."""
    path = os.path.abspath(inpdir)
    if not os.path.exists(os.path.join(path, MARKER)):
        return False
    if path not in _ANNOUNCED:
        _ANNOUNCED.add(path)
        print(f"mistra_tpu: SYNTHETIC input tables from {path} "
              f"(seeded generator, not the reference data)", flush=True)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mistra_tpu.io.synthetic_inputs",
        description="write seeded stand-ins for the reference's physics "
                    "input tables")
    ap.add_argument("--out", default=DEFAULT_DIR)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(write_synthetic_inputs(args.out, args.seed))


if __name__ == "__main__":
    main()
