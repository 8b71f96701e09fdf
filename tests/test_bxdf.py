"""BxDF statistical invariants, mirroring the reference's integration tests
(reference geometry/tests/bxdf_test.rs, geometry/tests/microfacet_test.rs):
Riemann pdf integrals ~= 1, Monte-Carlo reflectance ~= albedo, half-vector
consistency, Fresnel pinned values."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.bxdf import fresnel as fr
from pbrs_jax.bxdf import lobes as lb
from pbrs_jax.bxdf import microfacet as mf
from pbrs_jax.core import vecmath as vm


def tesselate_hemisphere(n_theta=64):
    """Cell centers + solid-angle weights over the +z hemisphere.
    [ref: geometry/src/bxdf.rs:159-176]"""
    n_phi = 4 * n_theta
    thetas = (np.arange(n_theta) + 0.5) * (np.pi / 2) / n_theta
    phis = (np.arange(n_phi) + 0.5) * (2 * np.pi) / n_phi
    t, p = np.meshgrid(thetas, phis, indexing="ij")
    st, ct = np.sin(t), np.cos(t)
    dirs = np.stack([st * np.cos(p), st * np.sin(p), ct], axis=-1).reshape(-1, 3)
    dw = (st * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return jnp.asarray(dirs, jnp.float32), jnp.asarray(dw, jnp.float32)


def single_lobe(n, kind, albedo=(1.0, 1.0, 1.0), specular=(0.0, 0.0, 0.0),
                alpha=(0.5, 0.5), distrib=mf.BECKMANN, fr_kind=fr.NOP,
                eta=(1.0, 1.5), eta_t=(1.0, 1.0, 1.0), k=(0.0, 0.0, 0.0)):
    tile = lambda x, d: jnp.tile(jnp.asarray(x, jnp.float32)[None, None], (n, 1, d and 1 or 1))
    f3 = lambda x: jnp.tile(jnp.asarray(x, jnp.float32)[None, None, :], (n, 1, 1))
    f2 = lambda x: jnp.tile(jnp.asarray(x, jnp.float32)[None, None, :], (n, 1, 1))
    i1 = lambda x: jnp.full((n, 1), x, jnp.int32)
    return lb.Lobes(
        kind=i1(kind), albedo=f3(albedo), specular=f3(specular),
        alpha=f2(alpha), distrib=i1(distrib), fr_kind=i1(fr_kind),
        eta=f2(eta), eta_t=f3(eta_t), k=f3(k),
    )


def lobe0(lobes):
    return lb.slot(lobes, 0)


WO = vm.normalize(jnp.asarray([[0.3, -0.2, 0.8]], jnp.float32))


def test_fresnel_dielectric_pinned_and_reciprocal():
    # Normal incidence air->glass: ((1-1.5)/(1+1.5))^2 = 0.04.
    r = fr.dielectric_refl(jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.5]))
    np.testing.assert_allclose(float(r[0]), 0.04, rtol=1e-5)
    # Reciprocity: R at cos from front == R at -cos from back-swapped etas.
    cos = jnp.asarray([0.7])
    a = fr.dielectric_refl(cos, jnp.asarray([1.0]), jnp.asarray([1.5]))
    b = fr.dielectric_refl(-cos, jnp.asarray([1.5]), jnp.asarray([1.0]))
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-6)
    # TIR from inside beyond critical angle.
    r_tir = fr.dielectric_refl(jnp.asarray([-0.5]), jnp.asarray([1.0]), jnp.asarray([1.5]))
    np.testing.assert_allclose(float(r_tir[0]), 1.0)


def test_fresnel_conductor_finite_positive():
    eta_t = jnp.asarray([[0.155, 0.116, 0.138]])
    k = jnp.asarray([[4.82, 3.12, 2.14]])
    for c in [1.0, 0.7, 0.3, 0.05]:
        r = fr.conductor_refl(jnp.asarray([c]), eta_t, k)
        arr = np.asarray(r)
        assert np.all(np.isfinite(arr)) and np.all(arr >= 0) and np.all(arr <= 1.01)


def test_lambert_pdf_integrates_to_one():
    dirs, dw = tesselate_hemisphere()
    n = dirs.shape[0]
    lobes = single_lobe(n, lb.LAMBERT)
    wo = jnp.broadcast_to(WO, (n, 3))
    pdf = lb.pdf_lobe(lobe0(lobes), wo, dirs)
    integral = float(jnp.sum(pdf * dw))
    np.testing.assert_allclose(integral, 1.0, atol=2e-3)


def test_oren_nayar_pdf_integrates_to_one():
    dirs, dw = tesselate_hemisphere()
    n = dirs.shape[0]
    sigma = np.radians(20.0)
    a = 1.0 - sigma**2 / (2 * (sigma**2 + 0.33))
    b = 0.45 * sigma**2 / (sigma**2 + 0.09)
    lobes = single_lobe(n, lb.OREN_NAYAR, alpha=(a, b))
    wo = jnp.broadcast_to(WO, (n, 3))
    pdf = lb.pdf_lobe(lobe0(lobes), wo, dirs)
    np.testing.assert_allclose(float(jnp.sum(pdf * dw)), 1.0, atol=2e-3)


def test_microfacet_d_normalization():
    # ∫ D(wh) cosθ dωh = 1 for both models. [ref: microfacet_test.rs:12-25]
    dirs, dw = tesselate_hemisphere(128)
    for distrib in (mf.BECKMANN, mf.TROWBRIDGE_REITZ):
        for alpha in (0.3, 0.6, 1.2):
            dval = mf.d(
                jnp.full(dirs.shape[0], distrib),
                jnp.full(dirs.shape[0], alpha),
                jnp.full(dirs.shape[0], alpha),
                dirs,
            )
            integral = float(jnp.sum(dval * dirs[:, 2] * dw))
            np.testing.assert_allclose(integral, 1.0, atol=2e-2, err_msg=f"{distrib} {alpha}")


def test_microfacet_pdf_integrates_to_one():
    # ∫ pdf(wh) dωh = 1 across alpha sweep. [ref: microfacet_test.rs:27-49]
    dirs, dw = tesselate_hemisphere(96)
    n = dirs.shape[0]
    wo = jnp.broadcast_to(WO, (n, 3))
    for distrib in (mf.BECKMANN, mf.TROWBRIDGE_REITZ):
        for alpha in (0.3, 0.8):
            p = mf.pdf_wh(
                jnp.full(n, distrib), jnp.full(n, alpha), jnp.full(n, alpha),
                wo, dirs,
            )
            np.testing.assert_allclose(float(jnp.sum(p * dw)), 1.0, atol=2e-2)


def test_sample_wh_matches_bisector():
    # wh sampled, wi = reflect(wh, wo) => bisector(wo, wi) == wh.
    # [ref: bxdf_test.rs:202-231]
    n = 4096
    rng = np.random.default_rng(1)
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    wo = jnp.broadcast_to(WO, (n, 3))
    for distrib in (mf.BECKMANN, mf.TROWBRIDGE_REITZ):
        wh = mf.sample_wh(
            jnp.full(n, distrib), jnp.full(n, 0.5), jnp.full(n, 0.5), wo, u2
        )
        wi = vm.reflect(wh, wo)
        mid = vm.normalize(wo + wi)
        dots = np.asarray(vm.dot(mid, wh))
        assert np.quantile(np.abs(dots), 0.05) > 0.999


def test_sample_wh_distribution_matches_pdf():
    # Histogram of sampled wh cosθ against the analytic marginal.
    n = 1 << 16
    rng = np.random.default_rng(2)
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    wo = jnp.broadcast_to(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 3))
    for distrib in (mf.BECKMANN, mf.TROWBRIDGE_REITZ):
        alpha = 0.5
        wh = mf.sample_wh(
            jnp.full(n, distrib), jnp.full(n, alpha), jnp.full(n, alpha), wo, u2
        )
        cos_h = np.asarray(wh[:, 2])
        # Analytic CDF check at median: integrate pdf_theta = D * cos * sin * 2pi.
        thetas = np.linspace(1e-4, np.pi / 2 - 1e-4, 2000)
        dirs = jnp.asarray(
            np.stack([np.sin(thetas), np.zeros_like(thetas), np.cos(thetas)], -1),
            jnp.float32,
        )
        dvals = np.asarray(
            mf.d(jnp.full(2000, distrib), jnp.full(2000, alpha), jnp.full(2000, alpha), dirs)
        )
        pdf_theta = dvals * np.cos(thetas) * np.sin(thetas) * 2 * np.pi
        cdf = np.cumsum(pdf_theta) * (thetas[1] - thetas[0])
        cdf /= cdf[-1]
        median_theta = thetas[np.searchsorted(cdf, 0.5)]
        emp_median = np.median(np.arccos(np.clip(cos_h, -1, 1)))
        np.testing.assert_allclose(emp_median, median_theta, atol=0.02)


def test_lambert_reflectance_equals_albedo():
    # MC estimate of rho = E[f |cos| / pdf] ~= albedo. [ref: bxdf_test.rs:181-200]
    n = 1 << 16
    rng = np.random.default_rng(3)
    albedo = (0.7, 0.4, 0.2)
    lobes = single_lobe(n, lb.LAMBERT, albedo=albedo)
    wo = jnp.broadcast_to(WO, (n, 3))
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    f, wi, pdf, is_delta = lb.sample_lobe(lobe0(lobes), wo, u2)
    w = np.asarray(f) * np.abs(np.asarray(wi[:, 2:3])) / np.maximum(np.asarray(pdf)[:, None], 1e-8)
    np.testing.assert_allclose(w.mean(axis=0), albedo, rtol=2e-2)


def test_mirror_sample():
    n = 4
    lobes = single_lobe(n, lb.SPEC_MIRROR, albedo=(1, 1, 1))
    wo = jnp.broadcast_to(WO, (n, 3))
    f, wi, pmf, is_delta = lb.sample_lobe(
        lobe0(lobes), wo, jnp.zeros((n, 2), jnp.float32)
    )
    assert np.all(np.asarray(is_delta))
    np.testing.assert_allclose(
        np.asarray(wi[0]), [-float(WO[0, 0]), -float(WO[0, 1]), float(WO[0, 2])],
        atol=1e-6,
    )
    # Energy: f * cos / pmf == 1 for a NOP-fresnel mirror with white albedo.
    energy = np.asarray(f[0]) * abs(float(wi[0, 2])) / float(pmf[0])
    np.testing.assert_allclose(energy, 1.0, rtol=1e-5)


def test_dielectric_energy_conservation():
    # White dielectric: E[f |cos| / pmf] per sample is exactly 1 on both
    # branches (reflect: R/R; transmit: (1-R)/(1-R)).
    n = 1 << 12
    rng = np.random.default_rng(4)
    lobes = single_lobe(n, lb.SPEC_DIELECTRIC, albedo=(1, 1, 1),
                        fr_kind=fr.DIELECTRIC, eta=(1.0, 1.5))
    wo = jnp.broadcast_to(WO, (n, 3))
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    f, wi, pmf, is_delta = lb.sample_lobe(lobe0(lobes), wo, u2)
    w = np.asarray(f) * np.abs(np.asarray(wi[:, 2:3])) / np.asarray(pmf)[:, None]
    # Reflected lanes carry R/R == depends; both branches weight ~1.
    np.testing.assert_allclose(w.mean(axis=0), 1.0, atol=5e-2)
    # Transmitted lanes go below the surface.
    transmitted = np.asarray(wi[:, 2]) < 0
    assert transmitted.mean() > 0.5  # at this angle most energy refracts


def test_microfacet_sample_pdf_consistency():
    # pdf returned by sampling equals pdf_lobe at the sampled direction.
    n = 1 << 12
    rng = np.random.default_rng(5)
    for distrib in (mf.BECKMANN, mf.TROWBRIDGE_REITZ):
        lobes = single_lobe(n, lb.MICROFACET, alpha=(0.4, 0.4), distrib=distrib)
        wo = jnp.broadcast_to(WO, (n, 3))
        u2 = jnp.asarray(rng.random((n, 2), np.float32))
        f, wi, pdf, is_delta = lb.sample_lobe(lobe0(lobes), wo, u2)
        pdf2 = lb.pdf_lobe(lobe0(lobes), wo, wi)
        mask = np.asarray(pdf) > 1e-6
        np.testing.assert_allclose(
            np.asarray(pdf)[mask], np.asarray(pdf2)[mask], rtol=1e-3
        )
        assert not np.any(np.asarray(is_delta))


def test_microfacet_white_furnace_bounded():
    # NOP fresnel, white albedo: rho = E[f cos / pdf] should be <= ~1 and
    # substantial (energy loss only from masking). [ref: microfacet_test.rs:165-194]
    n = 1 << 15
    rng = np.random.default_rng(6)
    lobes = single_lobe(n, lb.MICROFACET, alpha=(0.5, 0.5))
    wo = jnp.broadcast_to(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 3))
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    f, wi, pdf, _ = lb.sample_lobe(lobe0(lobes), wo, u2)
    w = np.asarray(f[:, 0]) * np.abs(np.asarray(wi[:, 2])) / np.maximum(np.asarray(pdf), 1e-9)
    rho = w.mean()
    assert 0.5 < rho <= 1.05, rho


def test_fresnel_blend_pdf_integrates_to_one():
    dirs, dw = tesselate_hemisphere()
    n = dirs.shape[0]
    lobes = single_lobe(n, lb.FRESNEL_BLEND, albedo=(0.5, 0.5, 0.5),
                        specular=(0.3, 0.3, 0.3), alpha=(0.4, 0.4))
    wo = jnp.broadcast_to(WO, (n, 3))
    pdf = lb.pdf_lobe(lobe0(lobes), wo, dirs)
    np.testing.assert_allclose(float(jnp.sum(pdf * dw)), 1.0, atol=2e-2)


def test_concentric_disk_is_uniform():
    """The disk map must be area-preserving: flat azimuth histogram AND
    the correct radius CDF (the reference's polar form has a ±33% azimuth
    ripple with period pi/2 — bxdf.rs:187-200, fixed here; COMPAT.md)."""
    import numpy as np
    from pbrs_jax.bxdf import lobes as lb

    rng = np.random.default_rng(0)
    u2 = jnp.asarray(rng.random((1 << 18, 2)), jnp.float32)
    px, py = lb.concentric_sample_disk(u2)
    px, py = np.asarray(px), np.asarray(py)
    r2 = px * px + py * py
    assert (r2 <= 1.0 + 1e-6).all()
    phi = np.arctan2(py, px)
    h, _ = np.histogram(phi, bins=32, range=(-np.pi, np.pi))
    ripple = h / h.mean()
    # 32 bins x ~8k samples: Poisson noise ~1%; the polar form rippled 33%
    assert np.abs(ripple - 1.0).max() < 0.05, ripple
    # radius: P(r <= s) = s^2
    for s in (0.3, 0.5, 0.8):
        frac = (r2 <= s * s).mean()
        assert abs(frac - s * s) < 0.01, (s, frac)


def test_cosine_hemisphere_energy_against_window():
    """Azimuth-dependent integrand: E[L(w)] under cosine sampling must
    match the analytic cosine-weighted integral of an off-axis 'window'
    indicator (the polar-form sampler missed this by ~20%)."""
    import numpy as np
    from pbrs_jax.bxdf import lobes as lb

    rng = np.random.default_rng(1)
    u2 = jnp.asarray(rng.random((1 << 18, 2)), jnp.float32)
    wi = np.asarray(lb.cos_sample_hemisphere(u2))
    # window: azimuth in [0, pi/8], elevation 30-60 degrees
    phi = np.arctan2(wi[:, 1], wi[:, 0])
    cost = wi[:, 2]
    inside = ((phi >= 0) & (phi <= np.pi / 8)
              & (cost >= 0.5) & (cost <= np.sqrt(3) / 2))
    est = inside.mean()  # = integral of indicator * cos/pi
    # analytic: (1/pi) * dphi * int_{0.5}^{sqrt3/2} c dc * 2pi/(2pi)...
    want = (np.pi / 8) * (3.0 / 4.0 - 1.0 / 4.0) / 2.0 / np.pi
    assert abs(est - want) / want < 0.03, (est, want)
