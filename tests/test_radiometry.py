"""Exact-CIE-table spectral pipeline tests.

The reference embeds the 471-sample CIE 1931 observer and converts SPDs by
cubic-spline resampling onto the table grid then dotting with X/Y/Z and
normalizing by sum(CIE_Y) (reference radiometry/src/spectrum.rs:57-75).
These tests pin our pipeline to that semantics.
"""

import numpy as np

from pbrs_jax import radiometry as rad


def test_cie_tables_shape_and_anchors():
    # Table covers 360..830 at 1 nm; known anchor points of the 1931
    # standard observer.
    assert rad._CIE_LAMBDA[0] == 360.0 and rad._CIE_LAMBDA[-1] == 830.0
    assert rad._CIE_LAMBDA.size == 471
    # y-bar peaks at 555 nm with value ~1.0
    assert abs(rad.cie_y(555.0) - 1.0) < 2e-3
    i = int(np.argmax(rad._CIE_Y_TAB))
    assert rad._CIE_LAMBDA[i] == 555.0
    # x-bar has its blue-side secondary peak near 442 nm and main peak ~599 nm
    assert abs(rad._CIE_LAMBDA[int(np.argmax(rad._CIE_X_TAB))] - 599.0) < 4.0
    # tables are non-negative
    assert rad._CIE_X_TAB.min() >= 0.0
    assert rad._CIE_Y_TAB.min() >= 0.0
    assert rad._CIE_Z_TAB.min() >= 0.0


def test_constant_spd_luminance_one():
    # A constant unit SPD has Y = sum(y)/sum(y) = 1 under the reference's
    # sum normalization (spectrum.rs:69).
    rgb = rad.sampled_spectrum_to_rgb([360.0, 830.0], [1.0, 1.0])
    y = float(rad.RGB_TO_XYZ[1] @ rgb)
    assert abs(y - 1.0) < 1e-3


def test_coarse_spd_matches_dense_table_integration():
    # Smooth SPD sampled every 10 nm -> full pipeline must match direct
    # 1 nm table integration of the underlying function to <1e-3 (the
    # VERDICT acceptance bound for the .spd path).
    lam_dense = rad._CIE_LAMBDA

    def spd(l):
        return 0.5 + 0.4 * np.sin((l - 360.0) / 80.0)

    coarse = np.arange(360.0, 831.0, 10.0)
    got = rad.sampled_spectrum_to_rgb(coarse, spd(coarse))
    dense = spd(lam_dense)
    xyz = np.array([
        np.sum(dense * rad._CIE_X_TAB),
        np.sum(dense * rad._CIE_Y_TAB),
        np.sum(dense * rad._CIE_Z_TAB),
    ]) / rad.CIE_Y_INTEGRAL
    want = np.maximum(rad.XYZ_TO_RGB @ xyz, 0.0)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_partial_range_spd_clamps_like_reference():
    # The reference spline clamps to endpoint values outside the sample
    # range (math/src/spline.rs:42-45) rather than extrapolating/zeroing.
    lam = np.arange(400.0, 701.0, 10.0)
    val = np.full_like(lam, 2.0)
    rgb = rad.sampled_spectrum_to_rgb(lam, val)
    # constant 2.0 extended by clamping across the whole table -> Y = 2
    y = float(rad.RGB_TO_XYZ[1] @ rgb)
    assert abs(y - 2.0) < 1e-3


def test_blackbody_6500k_near_white():
    rgb = rad.temperature_to_rgb(6500.0)
    rgb = rgb / rgb.max()
    # D65-ish: all channels within ~25% of each other
    assert rgb.min() > 0.7
