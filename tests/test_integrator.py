"""End-to-end integrator tests on the Cornell box (config 1/2 of
BASELINE.md): color correctness, NEE-vs-brute-force agreement, determinism,
and the direct-lighting integrator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrs_jax.core import sampler as smp
from pbrs_jax.geometry import camera as cam_mod
from pbrs_jax.integrators import wavefront, direct
from pbrs_jax.scene import presets


@pytest.fixture(scope="module")
def cornell32():
    scene = presets.cornell_box()
    cam = cam_mod.looking_at(
        cam_mod.make_camera((32, 32), 40.0), (278, 278, -800), (278, 278, 0),
        (0, 1, 0),
    )
    return scene.replace(camera=cam)


def _render(scene, spp, max_depth=5, use_nee=True, seed=0, msaa=None):
    sampler = smp.PCGSampler(seed)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n)
    msaa = msaa or max(1, int(round(spp ** 0.5)))
    fn = jax.jit(
        lambda s: wavefront.render_samples(
            scene, sampler, pix, s, max_depth=max_depth, msaa=msaa,
            use_nee=use_nee,
        )
    )
    acc = np.zeros((n, 3), np.float32)
    total = msaa * msaa if spp is None else spp
    for s in range(total):
        acc += np.asarray(fn(s))
    img = acc / total
    return img.reshape(scene.camera.height, scene.camera.width, 3)


def test_cornell_colors_and_light(cornell32):
    img = _render(cornell32, spp=16)
    assert not np.isnan(img).any()
    # Light pixels blend emitter (15.0) and ceiling samples at 32² res.
    assert 5.0 < img.max() <= 15.01
    red = img[14:18, 1:3].mean(axis=(0, 1))
    green = img[14:18, 29:31].mean(axis=(0, 1))
    assert red[0] > 3 * red[1], red  # left wall red-dominant
    assert green[1] > 2 * green[0], green  # right wall green-dominant
    # Global energy in a sane band (empirical ~0.15 at this resolution).
    assert 0.08 < img.mean() < 0.3


@pytest.mark.slow
def test_cornell_nee_matches_brute_force(cornell32):
    """NEE+MIS and naive BSDF-only path tracing must converge to the same
    image — the strongest unbiasedness check available without the
    reference binary."""
    img_nee = _render(cornell32, spp=64, max_depth=5, use_nee=True, seed=0)
    img_brute = _render(cornell32, spp=784, max_depth=6, use_nee=False,
                        seed=1234)
    # Compare 4x4 block means (averages out brute-force variance).
    a = img_nee.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))
    b = img_brute.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))
    rel = np.abs(a - b) / np.maximum((a + b) / 2, 5e-3)
    assert np.median(rel) < 0.08, (np.median(rel), rel.max())
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)


def _mirror_light_scene():
    """A mirror quad that reflects an area-light quad into the camera, plus
    a diffuse floor (regression scene for the NEE delta double-count bug:
    light seen through a specular bounce must be counted exactly once —
    ADVICE r1 #1 / COMPAT.md #12)."""
    from pbrs_jax.scene.buffers import SceneBuilder

    b = SceneBuilder()
    mirror = b.materials.add_mirror()
    white = b.materials.add_lambertian((0.7, 0.7, 0.7))
    lmat = b.materials.add_diffuse_light((15.0, 15.0, 15.0))
    g = b.geometry
    # Mirror wall at z=2 facing the camera.
    g.add_quad((-2, -2, 2), (4, 0, 0), (0, 4, 0), mirror)
    # Area light behind the camera at z=-6, visible only via the mirror.
    g.add_quad((-1, -1, -6), (2, 0, 0), (0, 2, 0), lmat)
    # Diffuse floor to exercise the smooth NEE arms in the same render.
    g.add_quad((-4, -2, -7), (8, 0, 0), (0, 0, 10), white)
    b.lights.add_area_quad((15.0, 15.0, 15.0), (-1, -1, -6), (2, 0, 0),
                           (0, 2, 0))
    cam = cam_mod.make_camera((24, 24), 60.0)
    b.camera = cam_mod.looking_at(cam, (0, 0, -3), (0, 0, 2), (0, 1, 0))
    return b.build()


def test_mirror_area_light_nee_not_double_counted():
    """NEE and brute-force must agree on light seen through a mirror; the
    pre-fix estimator rendered it at ~2x (delta-sampled BSDF arm + the
    emission-after-specular rule both counted it)."""
    scene = _mirror_light_scene()
    img_nee = _render(scene, spp=64, max_depth=4, use_nee=True, seed=0)
    img_brute = _render(scene, spp=256, max_depth=4, use_nee=False, seed=99)
    # The mirror-reflected light occupies the image center.
    c_nee = img_nee[8:16, 8:16].mean()
    c_brute = img_brute[8:16, 8:16].mean()
    assert c_brute > 1.0  # the reflected light is actually visible
    np.testing.assert_allclose(c_nee, c_brute, rtol=0.06)
    # Whole-image energy must agree too (floor gets NEE, mirror doesn't).
    np.testing.assert_allclose(img_nee.mean(), img_brute.mean(), rtol=0.08)


def test_determinism(cornell32):
    img1 = _render(cornell32, spp=4, seed=7)
    img2 = _render(cornell32, spp=4, seed=7)
    np.testing.assert_array_equal(img1, img2)
    img3 = _render(cornell32, spp=4, seed=8)
    assert not np.array_equal(img1, img3)


def test_direct_lighting_integrator(cornell32):
    scene = cornell32
    sampler = smp.PCGSampler(0)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n)
    fn = jax.jit(
        lambda s: direct.direct_radiance(
            scene,
            wavefront.camera_rays(scene, sampler, pix, s, 4),
            sampler, pix, s, depth=2,
        )
    )
    acc = np.zeros((n, 3), np.float32)
    for s in range(16):
        acc += np.asarray(fn(s))
    img = (acc / 16).reshape(32, 32, 3)
    assert not np.isnan(img).any()
    assert 5.0 < img.max() <= 15.01
    # Direct-only is darker than full GI but nonzero everywhere lit.
    full = _render(scene, spp=16)
    assert 0.2 < img.mean() / full.mean() < 1.0


def test_visualizers(cornell32):
    scene = cornell32
    sampler = smp.PCGSampler(0)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n)
    rays = wavefront.camera_rays(scene, sampler, pix, 0, 1)
    nrm = np.asarray(direct.normal_visualizer(scene, rays))
    mat = np.asarray(direct.material_visualizer(scene, rays))
    assert nrm.shape == (n, 3) and not np.isnan(nrm).any()
    assert mat.shape == (n, 3)
    # several distinct material colors visible
    assert len(np.unique(mat.round(3), axis=0)) >= 4


def test_sphere_scene_env_light():
    """two_perlin_spheres under blue sky: no lights -> env via emission path."""
    scene = presets.two_perlin_spheres()
    cam = cam_mod.looking_at(
        cam_mod.make_camera((24, 24), 20.0), (13, 2, -3), (0, 0, 0), (0, 1, 0)
    )
    scene = scene.replace(camera=cam)
    img = _render(scene, spp=9)
    assert not np.isnan(img).any()
    # Sky visible at top; ground sphere lit below.
    assert img[0].mean() > 0.4
    assert img.mean() > 0.1
