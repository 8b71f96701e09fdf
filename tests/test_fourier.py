"""Fourier BSDF: synthetic-table correctness (the reference's .bsdf test
assets are absent from its repo, SURVEY §4)."""

import struct

import numpy as np
import jax.numpy as jnp

from pbrs_jax.bxdf import fourier as fb
from pbrs_jax.core import vecmath as vm

WO = vm.normalize(jnp.asarray([[0.2, -0.3, 0.85]], jnp.float32))


def test_lambert_table_eval_matches_analytic():
    albedo = 0.6
    table = fb.make_lambert_table(albedo, n_mu=32)
    n = 256
    rng = np.random.default_rng(0)
    wo = jnp.broadcast_to(WO, (n, 3))
    # random upper-hemisphere wi
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.1
    wi = vm.normalize(jnp.asarray(d))
    f = np.asarray(fb.eval_fourier(table, wo, wi))
    np.testing.assert_allclose(f, albedo / np.pi, rtol=0.08)


def test_lambert_table_pdf_integrates_to_one():
    table = fb.make_lambert_table(0.5, n_mu=32)
    n_theta, n_phi = 64, 64
    thetas = (np.arange(n_theta) + 0.5) * (np.pi / 2) / n_theta
    phis = (np.arange(n_phi) + 0.5) * 2 * np.pi / n_phi
    t, p = np.meshgrid(thetas, phis, indexing="ij")
    dirs = np.stack(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1
    ).reshape(-1, 3).astype(np.float32)
    dw = (np.sin(t) * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    wo = jnp.broadcast_to(WO, (dirs.shape[0], 3))
    pdf = np.asarray(fb.pdf_fourier(table, wo, jnp.asarray(dirs)))
    integral = float((pdf * dw).sum())
    np.testing.assert_allclose(integral, 1.0, atol=0.05)


def test_lambert_table_sample_reflectance():
    albedo = 0.4
    table = fb.make_lambert_table(albedo, n_mu=32)
    n = 1 << 13
    rng = np.random.default_rng(1)
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    wo = jnp.broadcast_to(WO, (n, 3))
    f, wi, pdf = fb.sample_fourier_bsdf(table, wo, u2)
    f, wi, pdf = np.asarray(f), np.asarray(wi), np.asarray(pdf)
    assert (wi[:, 2] > 0).mean() > 0.99  # reflection side
    w = f * np.abs(wi[:, 2:3]) / np.maximum(pdf[:, None], 1e-8)
    np.testing.assert_allclose(w.mean(axis=0), albedo, rtol=0.1)
    # The MIS-weight pdf (Catmull-Rom estimate) tracks the exact sample pdf
    # up to zenith-interpolation error.
    pdf2 = np.asarray(fb.pdf_fourier(table, wo, jnp.asarray(wi)))
    mask = pdf > 1e-2
    ratio = pdf2[mask] / pdf[mask]
    assert 0.5 < np.median(ratio) < 2.0, np.median(ratio)


def test_scatfun_roundtrip(tmp_path):
    # Write a tiny SCATFUN file and load it back.
    table = fb.make_lambert_table(0.5, n_mu=8)
    n_mu = 8
    mu = np.asarray(table.mu)
    cdf = np.asarray(table.cdf).reshape(-1)
    m_lookup = np.asarray(table.m_lookup).reshape(-1)
    a_dense = np.asarray(table.a_dense)
    coeffs = []
    offsets = []
    for idx in range(n_mu * n_mu):
        offsets.append(len(coeffs))
        m = int(m_lookup[idx])
        for c in range(3):
            coeffs.extend(a_dense[idx, c, :m].tolist())
    header = b"SCATFUN" + struct.pack("<B", 1)
    header += struct.pack("<Iiiiii", 1, n_mu, len(coeffs), 1, 3, 1)
    header += struct.pack("<iiifffff", 0, 0, 0, 1.5, 0.1, 0.1, 0, 0)
    assert len(header) == 64
    path = str(tmp_path / "test.bsdf")
    with open(path, "wb") as f:
        f.write(header)
        f.write(mu.astype("<f4").tobytes())
        f.write(cdf.astype("<f4").tobytes())
        ol = np.zeros(n_mu * n_mu * 2, "<i4")
        ol[0::2] = offsets
        ol[1::2] = m_lookup
        f.write(ol.tobytes())
        f.write(np.asarray(coeffs, "<f4").tobytes())
    loaded = fb.load_scatfun(path)
    assert loaded.eta == 1.5
    np.testing.assert_allclose(np.asarray(loaded.mu), mu)
    np.testing.assert_allclose(
        np.asarray(loaded.a0), np.asarray(table.a0), atol=1e-6
    )


def test_fourier_material_in_scene_renders():
    import jax
    from pbrs_jax.scene.buffers import SceneBuilder
    from pbrs_jax.geometry import camera as cam_mod
    from pbrs_jax.integrators import wavefront
    from pbrs_jax.core import sampler as smp

    b = SceneBuilder()
    table = fb.make_lambert_table(0.5, n_mu=16)
    m = b.materials.add_fourier(table)
    light = b.materials.add_diffuse_light((8.0, 8.0, 8.0))
    b.geometry.add_quad((-2, 0, -2), (4, 0, 0), (0, 0, 4), m)
    b.geometry.add_quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), light)
    b.lights.add_area_quad((8.0, 8.0, 8.0), (-1, 3, -1), (2, 0, 0), (0, 0, 2))
    cam = cam_mod.make_camera((16, 16), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 2, -5), (0, 0.5, 0), (0, 1, 0))
    scene = b.build()
    sampler = smp.PCGSampler(0)
    pix = jnp.arange(16 * 16)
    fn = jax.jit(lambda s: wavefront.render_samples(
        scene, sampler, pix, s, max_depth=3, msaa=2))
    img = np.asarray(fn(0))
    assert not np.isnan(img).any()
    assert img.mean() > 0.005  # light reflects off the fourier floor


def test_multi_table_eval_selects_per_lane():
    """Two tables in one FourierTable: per-lane table_idx must route each
    lane to its own table (reference: one table per Fourier material,
    material/src/lib.rs:451-475)."""
    t_lo = fb.make_lambert_table(0.2, n_mu=32)
    t_hi = fb.make_lambert_table(0.8, n_mu=32)
    both = fb.concat_tables([t_lo, t_hi])
    assert both.n_tables == 2
    n = 128
    rng = np.random.default_rng(1)
    wo = jnp.broadcast_to(WO, (n, 3))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.1
    wi = vm.normalize(jnp.asarray(d))
    idx = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    f = np.asarray(fb.eval_fourier(both, wo, wi, idx))
    want = np.broadcast_to(
        np.where(np.asarray(idx)[:, None] == 0, 0.2, 0.8) / np.pi, f.shape)
    np.testing.assert_allclose(f, want, rtol=0.08)
    # idx omitted -> table 0 for everyone
    f0 = np.asarray(fb.eval_fourier(both, wo, wi))
    np.testing.assert_allclose(f0, 0.2 / np.pi, rtol=0.08)


def test_multi_table_pdf_and_sample_per_lane():
    t_lo = fb.make_lambert_table(0.3, n_mu=32)
    t_hi = fb.make_lambert_table(0.9, n_mu=32)
    both = fb.concat_tables([t_lo, t_hi])
    n = 512
    rng = np.random.default_rng(2)
    wo = jnp.broadcast_to(WO, (n, 3))
    idx = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    u2 = jnp.asarray(rng.random((n, 2)), jnp.float32)
    f, wi, pdf = fb.sample_fourier_bsdf(both, wo, u2, idx)
    f, pdf = np.asarray(f), np.asarray(pdf)
    ok = pdf > 0
    # MC reflectance rho = E[f cos / pdf] ~= per-lane albedo
    cos = np.abs(np.asarray(wi)[:, 2])
    est = f[:, 0] * cos / np.maximum(pdf, 1e-9)
    for tid, albedo in ((0, 0.3), (1, 0.9)):
        sel = ok & (np.asarray(idx) == tid)
        assert sel.sum() > 50
        np.testing.assert_allclose(est[sel].mean(), albedo, rtol=0.15)
    # pdf consistency against pdf_fourier at the sampled direction. The
    # sampler's zenith pdf is the piecewise-linear marginal while
    # pdf_fourier uses the Catmull-Rom mix, so agreement is approximate
    # (tight in the mean, looser pointwise at knot boundaries).
    pdf2 = np.asarray(fb.pdf_fourier(both, wo, jnp.asarray(wi), idx))
    ratio = pdf2[ok] / np.maximum(pdf[ok], 1e-9)
    assert abs(np.median(ratio) - 1.0) < 0.05, np.median(ratio)
    np.testing.assert_allclose(pdf[ok], pdf2[ok], rtol=0.35, atol=1e-3)


def test_two_fourier_materials_one_scene():
    """MaterialBuilder path: two .bsdf materials coexist; shading_at routes
    hits to their own tables through the packed alpha slot."""
    from pbrs_jax.materials import table as mat_mod
    from pbrs_jax.textures import textures as tex_mod
    from pbrs_jax.bxdf import bsdf as bsdf_mod

    b = mat_mod.MaterialBuilder()
    m0 = b.add_fourier(fb.make_lambert_table(0.25, n_mu=32))
    m1 = b.add_fourier(fb.make_lambert_table(0.75, n_mu=32))
    mt = b.build()
    assert mt.fourier.n_tables == 2
    tt = tex_mod.TextureBuilder().build()
    n = 64
    rng = np.random.default_rng(3)
    mat_id = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    uv = jnp.zeros((n, 2))
    pos = jnp.zeros((n, 3))
    lobes, _ = mat_mod.shading_at(mt, tt, mat_id, uv, pos)
    wo = jnp.broadcast_to(WO, (n, 3))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.1
    wi = vm.normalize(jnp.asarray(d))
    frame = bsdf_mod.Frame(
        t=jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3)),
        b=jnp.broadcast_to(jnp.asarray([0, 1.0, 0]), (n, 3)),
        n=jnp.broadcast_to(jnp.asarray([0, 0, 1.0]), (n, 3)),
    )
    f = np.asarray(bsdf_mod.eval_bsdf(lobes, frame, wo, wi))
    want = np.broadcast_to(
        np.where(np.asarray(mat_id)[:, None] == m0, 0.25, 0.75) / np.pi,
        f.shape)
    np.testing.assert_allclose(f, want, rtol=0.08)


def test_truncation_error_bounded():
    """A table whose azimuth runs exceed m_cap: the capped eval error is
    bounded by the dropped-tail energy ratio (VERDICT r2 weak #5)."""
    n_mu = 16
    mu = np.linspace(-1, 1, n_mu).astype(np.float32)
    m_full = 96
    # Gaussian-decaying coefficients: a_k = a0 * exp(-(k/20)^2) — a smooth
    # azimuth lobe with meaningful energy past k=32.
    ks = np.arange(m_full)
    prof = np.exp(-((ks / 20.0) ** 2)).astype(np.float32)
    m_lookup = np.full(n_mu * n_mu, m_full, np.int64)
    a_offset = np.arange(n_mu * n_mu, dtype=np.int64) * m_full
    coeffs = np.tile(prof, n_mu * n_mu).astype(np.float32)
    cdf = np.tile(np.linspace(0, 1, n_mu, dtype=np.float32), (n_mu, 1))
    full = fb.build_table(1, mu, cdf, a_offset, m_lookup, coeffs,
                          m_cap=m_full)
    capped = fb.build_table(1, mu, cdf, a_offset, m_lookup, coeffs, m_cap=32)
    ratio = fb.truncation_energy_ratio(m_lookup, a_offset, coeffs, 1,
                                       m_cap=32)
    assert 0.0 < ratio < 0.2, ratio
    n = 256
    rng = np.random.default_rng(4)
    wo = jnp.broadcast_to(WO, (n, 3))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.05
    wi = vm.normalize(jnp.asarray(d))
    f_full = np.asarray(fb.eval_fourier(full, wo, wi))[:, 0]
    f_cap = np.asarray(fb.eval_fourier(capped, wo, wi))[:, 0]
    scale = max(f_full.max(), 1e-6)
    # |sum tail| <= sum |a_k| tail: absolute error bounded by tail energy.
    tail_abs = prof[32:].sum() * np.abs(
        1.0 / np.maximum(np.abs(np.asarray(wi)[:, 2]), 1e-3))
    assert (np.abs(f_full - f_cap) <= tail_abs + 1e-5).all()
    # and the relative scale of the error tracks the energy ratio
    assert np.abs(f_full - f_cap).max() / scale < 5 * ratio + 1e-3
