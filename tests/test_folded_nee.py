"""Folded NEE (one shadow traversal per bounce; the BSDF-sampled MIS arm
resolves against the next bounce's closest hit) must estimate the same
image as the reference-structured two-arm NEE — same expectation,
different (standard PBRT) estimator realization."""

import jax
import jax.numpy as jnp
import numpy as np

from pbrs_jax.core import sampler as smp
from pbrs_jax.geometry import camera as cam_mod
from pbrs_jax.integrators import wavefront
from pbrs_jax.lights import lights as lt
from pbrs_jax.scene.buffers import SceneBuilder


def _scene():
    """Area lights + image env (importance-sampled) + delta light + a
    mirror + occluders: every folded-mode leg (area visibility by
    t-compare, env by escape, delta-lobe exclusion, RR resolution
    segments) is live."""
    b = SceneBuilder()
    g = b.geometry
    rng = np.random.default_rng(2)
    g.add_quad((-8, 0, -8), (16, 0, 0), (0, 0, 16),
               b.materials.add_matte((0.6, 0.55, 0.5)))
    g.add_sphere((-1.5, 1, 0), 1.0, b.materials.add_matte((0.7, 0.3, 0.3)))
    g.add_sphere((1.5, 1, 0), 1.0, b.materials.add_mirror((0.9, 0.9, 0.9)))
    # occluder slab between the lights and part of the floor
    g.add_quad((-2, 2.5, -1), (2, 0, 0), (0, 0, 2),
               b.materials.add_matte((0.4, 0.4, 0.4)))
    lc = (9.0, 8.0, 7.0)
    g.add_quad((-1, 5, -1), (2, 0, 0), (0, 0, 2),
               b.materials.add_diffuse_light(lc))
    b.lights.add_area_quad(lc, (-1, 5, -1), (2, 0, 0), (0, 0, 2))
    c2 = (6.0, 6.0, 8.0)
    g.add_sphere((4, 4, -3), 0.7, b.materials.add_diffuse_light(c2))
    b.lights.add_area_sphere(c2, (4, 4, -3), 0.7)
    b.lights.add_point((-6, 6, 4), (30, 30, 25))
    env = (rng.random((8, 16, 3)) * 0.4).astype(np.float32)
    env[2:4, 5:8] = 6.0  # a bright window patch for the env-IS arm
    b.lights.env = lt.make_env_image(env)
    cam = cam_mod.make_camera((48, 48), 50.0)
    b.camera = cam_mod.looking_at(cam, (0, 3.5, -10), (0, 1, 0), (0, 1, 0))
    return b.build()


def _render(scene, nee_mode, samples, depth=5, **kw):
    sampler = smp.PCGSampler(11)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n, dtype=jnp.int32)
    fn = jax.jit(lambda s: wavefront.render_samples(
        scene, sampler, pix, s, max_depth=depth, msaa=2,
        nee_mode=nee_mode, **kw))
    acc = np.zeros((n, 3), np.float32)
    for s in range(samples):
        acc += np.asarray(fn(s))
    return acc / samples


def test_folded_matches_twoarm_mean():
    scene = _scene()
    a = _render(scene, "twoarm", samples=24)
    b = _render(scene, "folded", samples=24)
    assert np.isfinite(b).all()
    # Same expectation: per-pixel means agree within Monte-Carlo noise;
    # compare image means tightly and pixels loosely.
    assert abs(a.mean() - b.mean()) < 0.01 * max(a.mean(), 1e-6), (
        a.mean(), b.mean())
    denom = np.maximum(a.mean(axis=-1), 0.05)
    rel = np.abs((a - b).mean(axis=-1)) / denom
    # 48x48 at 96 total spp: pixel noise ~10%; demand agreement at 5 sigma
    assert np.quantile(rel, 0.99) < 0.5, np.quantile(rel, 0.99)


def test_folded_compacted_matches_folded_masked():
    scene = _scene()
    sampler = smp.PCGSampler(4)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)
    depth = 5
    ref = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=depth, msaa=2,
        nee_mode="folded"))()
    counts = np.asarray(jax.jit(lambda: wavefront.measure_alive(
        scene, sampler, pix, sid, max_depth=depth, msaa=2))())
    sched = wavefront.auto_schedule(counts, n, min_cap=256)
    assert any(c < n for c in sched[1:]), (sched, counts)
    got = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=depth, msaa=2,
        nee_mode="folded", shrink_schedule=sched))()
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               atol=1e-5, rtol=1e-4)


def test_folded_ray_count_is_lower():
    """The point of the fold: fewer traced segments for the same image
    family — depth*(1 closest + 1 shadow) + 1 epilogue vs
    depth*(1 closest + 2 shadows)."""
    scene = _scene()
    sampler = smp.PCGSampler(0)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)
    _, c2 = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=5, msaa=2,
        nee_mode="twoarm", return_ray_count=True))()
    _, c1 = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=5, msaa=2,
        nee_mode="folded", return_ray_count=True))()
    assert float(c1) < 0.82 * float(c2), (float(c1), float(c2))
