"""Statistical quality checks for the counter-based samplers."""

import pytest
import numpy as np
import jax.numpy as jnp

from pbrs_jax.core import sampler as smp


def test_pcg_uniform_range_and_mean():
    s = smp.PCGSampler(seed=7)
    pix = jnp.arange(1 << 16)
    u = np.asarray(s.u1(pix, 3, 2, smp.DIM_SCATTER_UV))
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(), 0.5, atol=5e-3)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, atol=5e-3)


def test_pcg_streams_decorrelated():
    s = smp.PCGSampler(seed=7)
    pix = jnp.arange(1 << 14)
    a = np.asarray(s.u1(pix, 0, 0, 3))
    b = np.asarray(s.u1(pix, 0, 1, 3))  # next bounce
    c = np.asarray(s.u1(pix, 1, 0, 3))  # next sample
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.03
    assert abs(np.corrcoef(a, c)[0, 1]) < 0.03


def test_pcg_deterministic():
    s1 = smp.PCGSampler(seed=1)
    s2 = smp.PCGSampler(seed=1)
    pix = jnp.arange(128)
    np.testing.assert_array_equal(
        np.asarray(s1.u2(pix, 5, 2, 4)), np.asarray(s2.u2(pix, 5, 2, 4))
    )
    s3 = smp.PCGSampler(seed=2)
    assert not np.array_equal(
        np.asarray(s1.u1(pix, 5, 2, 4)), np.asarray(s3.u1(pix, 5, 2, 4))
    )


def test_pcg_2d_stratification_coverage():
    # u2 draws should fill the unit square reasonably: chi-square on a 8x8
    # grid over 64k samples.
    s = smp.PCGSampler(seed=3)
    pix = jnp.arange(1 << 16)
    uv = np.asarray(s.u2(pix, 0, 0, smp.DIM_LIGHT_UV))
    cells = (uv[:, 0] * 8).astype(int) * 8 + (uv[:, 1] * 8).astype(int)
    counts = np.bincount(cells, minlength=64)
    expected = len(uv) / 64
    chi2 = ((counts - expected) ** 2 / expected).sum()
    # 63 dof; mean 63, std ~11. Allow generous headroom.
    assert chi2 < 150, chi2


def test_stratified_jitter_strata():
    s = smp.PCGSampler(seed=0)
    pix = jnp.zeros(1, jnp.int32)
    msaa = 4
    for i in range(msaa * msaa):
        dx, dy = smp.stratified_jitter(s, pix, i, msaa)
        sx, sy = i // msaa, i % msaa
        assert sx / msaa <= float(dx[0]) < (sx + 1) / msaa
        assert sy / msaa <= float(dy[0]) < (sy + 1) / msaa


def test_threefry_agrees_statistically():
    s = smp.ThreefrySampler(seed=0)
    pix = jnp.arange(1 << 12)
    u = np.asarray(s.u1(pix, 0, 0, 0))
    np.testing.assert_allclose(u.mean(), 0.5, atol=2e-2)


# ----------------------------- Sobol sampler --------------------------------


def test_sobol_elementary_intervals():
    """256 Owen-scrambled Sobol points per pixel are a (0,2)-sequence: every
    dyadic 2^a x 2^b partition with a+b=8 has exactly one point per cell."""
    s = smp.SobolSampler(seed=7)
    samples = jnp.arange(256, dtype=jnp.int32)
    uv = np.asarray(s.u2(jnp.zeros(256, jnp.int32), samples, 0,
                         smp.DIM_CAMERA_JITTER))
    for a in range(9):
        b = 8 - a
        ix = (uv[:, 0] * (1 << a)).astype(int)
        iy = (uv[:, 1] * (1 << b)).astype(int)
        cells = set((ix * (1 << b) + iy).tolist())
        assert len(cells) == 256, (a, b, len(cells))


def test_sobol_1d_stratification_and_range():
    s = smp.SobolSampler(seed=1)
    samples = jnp.arange(1024, dtype=jnp.int32)
    u = np.asarray(s.u1(jnp.zeros(1024, jnp.int32), samples, 2,
                        smp.DIM_BSDF_UV))
    assert (u >= 0).all() and (u < 1).all()
    # 1-D stratification: every 1/1024 interval occupied exactly once.
    assert len(set((u * 1024).astype(int).tolist())) == 1024


def test_sobol_pixel_and_dim_decorrelation():
    s = smp.SobolSampler(seed=3)
    samples = jnp.arange(64, dtype=jnp.int32)
    a = np.asarray(s.u2(jnp.zeros(64, jnp.int32), samples, 0, 2))
    b = np.asarray(s.u2(jnp.ones(64, jnp.int32), samples, 0, 2))
    c = np.asarray(s.u2(jnp.zeros(64, jnp.int32), samples, 1, 2))
    assert not np.allclose(a, b)
    assert not np.allclose(a, c)


def test_sobol_beats_pcg_on_smooth_integrand():
    """Equal-sample-count integration error: Sobol should beat independent
    PCG by a wide margin on a smooth 2-D integrand (E[uv] = 1/4)."""
    n = 1024
    samples = jnp.arange(n, dtype=jnp.int32)
    pix = jnp.zeros(n, jnp.int32)
    errs = {}
    for name, cls in (("sobol", smp.SobolSampler), ("pcg", smp.PCGSampler)):
        tot = 0.0
        for seed in range(8):
            uv = np.asarray(cls(seed).u2(pix, samples, 0, smp.DIM_LIGHT_UV))
            tot += (np.mean(uv[:, 0] * uv[:, 1]) - 0.25) ** 2
        errs[name] = tot / 8
    assert errs["sobol"] < errs["pcg"] / 20, errs


@pytest.mark.slow
def test_sobol_renders_cornell_consistently():
    """End-to-end: a tiny Cornell render with the Sobol sampler matches the
    PCG render's mean brightness (same estimator, different sampler)."""
    from pbrs_jax.scene import presets
    from pbrs_jax.integrators import wavefront

    scene = _small_cornell(64)
    n = 64 * 64
    pix = jnp.arange(n, dtype=jnp.int32)
    outs = {}
    for name, cls in (("pcg", smp.PCGSampler), ("sobol", smp.SobolSampler)):
        sampler = cls(0)
        acc = 0.0
        imgs = []
        for s in range(4):
            rad = wavefront.render_samples(
                scene, sampler, pix, jnp.full(n, s, jnp.int32),
                max_depth=3, msaa=2)
            imgs.append(np.asarray(rad))
        outs[name] = np.mean(imgs, axis=0)
    mp, ms = outs["pcg"].mean(), outs["sobol"].mean()
    assert abs(mp - ms) / mp < 0.05, (mp, ms)


def _small_cornell(size):
    from pbrs_jax.scene import presets
    from pbrs_jax.geometry import camera as cam_mod

    scene = presets.cornell_box()
    cam = cam_mod.looking_at(
        cam_mod.make_camera((size, size), 40.0),
        (278, 278, -800), (278, 278, 0), (0, 1, 0))
    return scene.replace(camera=cam)
