"""Radiometry: RGB radiance arithmetic and spectral utilities.

Colors are plain ``[..., 3]`` float32 arrays (linear sRGB primaries). This
replaces the reference Color/XYZ structs (reference radiometry/src/color.rs)
with array lanes. Spectral->RGB uses the exact 471-sample CIE 1931 standard
observer tables (public CIE data, the same table the reference embeds at
radiometry/src/spectrum.rs:72-75) with natural-cubic-spline SPD resampling
per the reference pipeline (spectrum.rs:57-70) — host-side only, run once at
scene-load time.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# sRGB (D65) <-> CIE XYZ. [ref: radiometry/src/color.rs:196-238]
RGB_TO_XYZ = np.array(
    [
        [0.41245330, 0.35757984, 0.18042262],
        [0.21267127, 0.71515972, 0.07216883],
        [0.01933384, 0.11919363, 0.95022693],
    ],
    dtype=np.float32,
)
XYZ_TO_RGB = np.linalg.inv(RGB_TO_XYZ.astype(np.float64)).astype(np.float32)


def luminance(c):
    """CIE Y of a linear-RGB color. [ref: radiometry/src/color.rs:116-118]"""
    w = jnp.asarray(RGB_TO_XYZ[1], dtype=c.dtype)
    return jnp.sum(c * w, axis=-1)


def xyz_to_rgb(xyz):
    return xyz @ jnp.asarray(XYZ_TO_RGB).T


def rgb_to_xyz(rgb):
    return rgb @ jnp.asarray(RGB_TO_XYZ).T


def gamma_encode(c):
    """sqrt gamma, as in the reference PNG path. [ref: radiometry/src/color.rs:54-56]"""
    return jnp.sqrt(jnp.maximum(c, 0.0))


def to_u8(c):
    """Saturating [0,1] -> u8. [ref: radiometry/src/color.rs:60-66]"""
    return np.clip(np.asarray(c) * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def from_u8(r: int, g: int, b: int):
    return np.array([r, g, b], dtype=np.float32) / 255.0


# ---------------------------------------------------------------------------
# Spectral -> RGB (host-side, NumPy). [ref: radiometry/src/spectrum.rs]
# ---------------------------------------------------------------------------

# Exact CIE 1931 2-degree standard-observer tables, 471 samples at 1 nm from
# 360-830 nm (public CIE data; identical table to reference
# spectrum.rs:72-75). Stored as an npz asset rather than a thousand-line
# literal.
def _load_cie():
    import importlib.resources as res

    with res.files("pbrs_jax.data").joinpath("cie1931.npz").open("rb") as f:
        z = np.load(f)
        return {k: z[k].astype(np.float64) for k in z.files}


_CIE = _load_cie()
_CIE_LAMBDA = _CIE["cie_lambda"]
_CIE_X_TAB, _CIE_Y_TAB, _CIE_Z_TAB = _CIE["cie_x"], _CIE["cie_y"], _CIE["cie_z"]


def cie_x(wavelength_nm):
    w = np.asarray(wavelength_nm, dtype=np.float64)
    return np.interp(w, _CIE_LAMBDA, _CIE_X_TAB, left=0.0, right=0.0)


def cie_y(wavelength_nm):
    w = np.asarray(wavelength_nm, dtype=np.float64)
    return np.interp(w, _CIE_LAMBDA, _CIE_Y_TAB, left=0.0, right=0.0)


def cie_z(wavelength_nm):
    w = np.asarray(wavelength_nm, dtype=np.float64)
    return np.interp(w, _CIE_LAMBDA, _CIE_Z_TAB, left=0.0, right=0.0)


# Normalization: plain sum over the 1 nm table, matching the reference's
# `CIE_Y.iter().sum()` (spectrum.rs:69,54) rather than a trapezoid integral.
CIE_Y_INTEGRAL = float(_CIE_Y_TAB.sum())


def blackbody(wavelength_nm, temperature_k):
    """Planck spectral radiance (W·sr⁻¹·m⁻³). [ref: radiometry/src/spectrum.rs:3-25]"""
    lam = np.asarray(wavelength_nm, dtype=np.float64) * 1e-9
    h = 6.62606957e-34
    c = 299792458.0
    kb = 1.3806488e-23
    return (2.0 * h * c * c) / (
        lam**5 * (np.expm1(h * c / (lam * kb * float(temperature_k))))
    )


def blackbody_normalized(wavelength_nm, temperature_k):
    """Planck's law scaled so the Wien-peak wavelength has value 1.
    [ref: radiometry/src/spectrum.rs:27-36]"""
    lambda_max_nm = 2.8977721e-3 / float(temperature_k) * 1e9
    peak = blackbody(lambda_max_nm, temperature_k)
    return blackbody(wavelength_nm, temperature_k) / peak


def sampled_spectrum_to_rgb(wavelengths_nm, values):
    """Integrate an SPD against the CIE observer and convert to linear RGB.

    Reference pipeline (radiometry/src/spectrum.rs:57-70): sort samples,
    build a natural cubic spline, evaluate it at every CIE table wavelength
    (extrapolating at the ends like the reference spline does), dot with the
    X/Y/Z tables, scale by 1/sum(CIE_Y).
    """
    from .core.spline import CubicSpline

    lam = np.asarray(wavelengths_nm, dtype=np.float64)
    val = np.asarray(values, dtype=np.float64)
    order = np.argsort(lam)
    lam, val = lam[order], val[order]
    if lam.size == 1:
        dense = np.full_like(_CIE_LAMBDA, val[0])
    else:
        dense = np.asarray(
            CubicSpline(lam.astype(np.float32), val.astype(np.float32))
            .evaluate(_CIE_LAMBDA.astype(np.float32)),
            dtype=np.float64,
        )
    x = float(np.sum(dense * _CIE_X_TAB)) / CIE_Y_INTEGRAL
    y = float(np.sum(dense * _CIE_Y_TAB)) / CIE_Y_INTEGRAL
    z = float(np.sum(dense * _CIE_Z_TAB)) / CIE_Y_INTEGRAL
    rgb = XYZ_TO_RGB @ np.array([x, y, z])
    return np.maximum(rgb, 0.0).astype(np.float32)


def temperature_to_rgb(temperature_k):
    """Blackbody temperature -> normalized linear RGB.
    [ref: radiometry/src/spectrum.rs:39-55]"""
    lam = _CIE_LAMBDA
    spd = blackbody_normalized(lam, temperature_k)
    return sampled_spectrum_to_rgb(lam, spd)
