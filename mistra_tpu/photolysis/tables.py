"""Photolysis input tables: 176-interval cross sections, extraterrestrial
flux, quantum yields, and the Schumann-Runge Chebyshev coefficients.

Parses the reference data files (``CROSS_INIT``/jrate.f:767-1140 reads
flux.dat / sig0900.dat / cheb_coeff.dat; qyield.dat holds the CH2O, NO3
and NO2 quantum-yield channels).

Design note: the reference collapses the 176-interval spectrum
into a 7-interval band model with fitted lookup tables (lookt0900.dat,
Landgraf & Crutzen 1998) to save serial CPU time.  Here the full
176-interval actinic-flux calculation is carried out directly — the
wavelength axis is just another batch dimension — so the lookup
machinery is replaced by the exact spectral integral it approximates.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

MAXWAV = 176

# single-temperature cross-section arrays in file order (jrate.f:938-1062)
SINGLE_CS = [
    "H2O", "HNO3", "HNO4", "SO2", "HCl", "HOCl", "BrNO3", "CF3Cl",
    "CCl3F", "CCl4", "CCl2O", "F115", "F114", "F113", "CF2O", "CClFO",
    "O2", "CH3OH", "H2O2", "F22", "F13B1", "F12B1", "CH3Br", "CCl2F2",
    "CH3OOH", "Cl2", "CHBr3", "Cl2O2", "N2O5", "O4", "NO3n", "O3H2O",
    "HOI_Jen91", "HOCH2OOH", "HOBr_JPL", "HOBr", "BrCl_noT", "ClNO2",
    "BrNO2", "Br2", "IO", "INO3", "CH3I", "I2", "ICl", "IBr", "C3H7I",
    "CH2ClI", "CH2I2", "INO2", "BrO_noT", "OClO_noT", "Cl2_noT", "HONO",
    "NO2m", "dumm23", "dumm24", "dumm25", "dumm26",
]

# temperature-dependent sets: (name, number of temperatures)
TDEP_CS = [("O3", 3), ("NO3", 2), ("NO2", 2), ("OCS", 2), ("ClONO2", 3),
           ("CH3CCl3", 3), ("CO2", 3)]
TDEP_CS_TAIL = [("HOI", 3), ("CH2O", 2), ("CH3Cl", 3)]

# Michelsen O(1D) quantum yield coefficients (jrate.f block data)
A_O1D = np.array([1.01, 1.01, 1.05, 1.15, 1.39, 1.90, 2.93, 4.87, 8.21,
                  13.3, 17.6, 20.4, 18.0, 21.8, 18.1, 17.2, 7.99, 12.9,
                  11.25])
B_O1D = np.array([3.933, 11.51, 33.09, 79.39, 159.9, 272.5, 407.9, 551.4,
                  682.3, 791.6, 851.3, 903.8, 900.3, 948.4, 891.1, 1066.0,
                  969.4, 1191.5, 1293.5])

# Schumann-Runge optical depth above TOA (CT_TOP, jrate.f block data)
CT_TOP = np.array([
    [-2.5488e2, 1.5900e1, -3.4078e-1, 2.5083e-3],
    [-5.8222e2, 3.5825e1, -7.4328e-1, 5.2068e-3],
    [-5.8239e2, 3.5637e1, -7.3537e-1, 5.1210e-3],
    [-5.6359e2, 3.4235e1, -7.0220e-1, 4.8652e-3],
    [-5.5623e2, 3.3538e1, -6.8358e-1, 4.7115e-3],
    [-6.4776e2, 3.8519e1, -7.7292e-1, 5.2339e-3],
    [-5.7035e2, 3.3504e1, -6.6617e-1, 4.4825e-3],
    [-5.7514e2, 3.3451e1, -6.5964e-1, 4.4075e-3],
    [-9.3045e2, 5.3921e1, -1.0505e0, 6.8803e-3],
    [-8.9272e2, 5.1460e1, -1.0005e0, 6.5579e-3],
    [-7.1078e2, 4.0599e1, -7.8842e-1, 5.1978e-3],
    [-1.4366e2, 6.1527e0, -9.5919e-2, 5.8395e-4],
    [-1.1535e2, 4.5631e0, -6.6966e-2, 4.1305e-4]])


def wavelength_grid():
    """Wavelength centers [cm] and widths of the 176 intervals
    (jrate.f:875-915)."""
    wave = np.zeros(MAXWAV)
    L = np.arange(1, 14)
    wave[:13] = 1.0 / (56250.0 - 500.0 * L)
    L = np.arange(14, 46)
    wave[13:45] = 1.0 / (49750.0 - (L - 13) * 500.0)
    L = np.arange(46, 69)
    wave[45:68] = (266.0 + (L - 13)) * 1.0e-7
    L = np.arange(69, 72)
    wave[68:71] = (320.5 + 2.0 * (L - 68)) * 1.0e-7
    L = np.arange(72, 177)
    wave[71:176] = (325.0 + 5.0 * (L - 71)) * 1.0e-7
    dwave = np.zeros(MAXWAV)
    dwave[1:-1] = 0.5 * (wave[2:] - wave[:-2])
    dwave[0] = dwave[1]
    dwave[-1] = dwave[-2]
    return wave, dwave


def rayleigh_cs(wave):
    """Nicolet (1984) Rayleigh scattering cross sections [cm2]."""
    wl = wave * 1.0e4  # um
    x = 0.389 * wl + 0.09426 / wl - 0.3228
    return 4.02e-28 / wl ** (4.0 + x)


@dataclass
class PhotolysisTables:
    wave: np.ndarray                  # [176] cm
    dwave: np.ndarray
    flux: np.ndarray                  # [176] photons/cm2/s per interval
    cs_ray: np.ndarray                # [176]
    cs: dict                          # name -> [176]
    cs_t: dict                        # name -> ([nT, 176], [nT] temps)
    coeff_hno3: np.ndarray            # [176] T-correction coefficients
    cheb_a: np.ndarray                # [20, 13]
    cheb_b: np.ndarray                # [20, 13]
    qy: dict                          # channel name -> [176]


def _read_floats(path):
    with open(path) as f:
        return f.read()


def load_photolysis_tables(inpdir_phot: str) -> PhotolysisTables:
    wave, dwave = wavelength_grid()

    flux = np.array(_read_floats(
        os.path.join(inpdir_phot, "flux.dat")).split(), dtype=float)
    assert flux.size == MAXWAV

    # --- sig0900.dat: headers + 7-per-line float blocks ------------------
    toks = _read_floats(os.path.join(inpdir_phot, "sig0900.dat")).split("\n")
    pos = 0

    def next_block(count):
        nonlocal pos
        vals = []
        while len(vals) < count:
            line = toks[pos]
            pos += 1
            vals.extend(float(v) for v in line.split())
        return np.array(vals[:count])

    def skip_header():
        nonlocal pos
        pos += 1

    cs = {}
    for name in SINGLE_CS:
        skip_header()
        cs[name] = next_block(MAXWAV)

    cs_t = {}
    for name, nt in TDEP_CS:
        skip_header()
        temps = next_block(nt)
        arrs = [next_block(MAXWAV) for _ in range(nt)]
        cs_t[name] = (np.stack(arrs), temps)
    skip_header()
    coeff_hno3 = next_block(MAXWAV)
    for name, nt in TDEP_CS_TAIL:
        skip_header()
        temps = next_block(nt)
        arrs = [next_block(MAXWAV) for _ in range(nt)]
        cs_t[name] = (np.stack(arrs), temps)

    # --- cheb_coeff.dat: comma-separated, 2 header lines per block, then
    # 20 records x 17 values (2 leading + 13 kept + 2 trailing) ------------
    cheb_toks = []
    for line in _read_floats(os.path.join(inpdir_phot,
                                          "cheb_coeff.dat")).splitlines():
        if "Cheb" in line or "Region" in line:
            continue
        for tok in line.replace(",", " ").split():
            try:
                cheb_toks.append(float(tok))
            except ValueError:
                pass

    def cheb_block(offset):
        vals = np.array(cheb_toks[offset:offset + 20 * 17]).reshape(20, 17)
        return vals[:, 2:15]

    cheb_a = cheb_block(0)
    cheb_b = cheb_block(20 * 17)

    # --- qyield.dat -------------------------------------------------------
    qlines = _read_floats(os.path.join(inpdir_phot,
                                       "qyield.dat")).splitlines()
    qy = {}
    qi = 0
    names = {"CH2O -> H+HCO": "CHOH", "CH2O -> H2+CO": "COH2",
             "NO3 -> NO2 + O": "NO2O", "NO3 -> NO + O2": "NOO2",
             "NO2 -> NO + O": "NO2"}
    current = None
    vals = []
    for line in qlines:
        stripped = line.strip()
        is_header = any(stripped.startswith(k.split()[0]) and "->" in
                        stripped for k in names) or \
            (stripped and not stripped[0].isdigit())
        if is_header and not stripped.replace(".", "").replace("E", "") \
                .replace("+", "").replace("-", "").replace(" ", "").isdigit():
            if current is not None:
                qy[current] = np.array(vals[:MAXWAV])
            key = None
            for k, v in names.items():
                if stripped.startswith(k):
                    key = v
            current = key
            vals = []
        else:
            vals.extend(float(v) for v in stripped.split())
    if current is not None:
        qy[current] = np.array(vals[:MAXWAV])

    return PhotolysisTables(
        wave=wave, dwave=dwave, flux=flux, cs_ray=rayleigh_cs(wave),
        cs=cs, cs_t=cs_t, coeff_hno3=coeff_hno3, cheb_a=cheb_a,
        cheb_b=cheb_b, qy=qy)
