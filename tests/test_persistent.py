"""Persistent-wavefront (task-refill) integrator tests: the estimator must
match the masked fori_loop wavefront exactly — same counter-based RNG
streams per (pixel, sample, bounce) — regardless of lane-pool size."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.core import sampler as smp
from pbrs_jax.geometry import camera as cam_mod
from pbrs_jax.integrators import persistent, wavefront
from pbrs_jax.scene import presets


def _tasks(scene, n_pix, spp):
    n = scene.camera.width * scene.camera.height
    pix = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32) % n, spp)
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), n_pix)
    return pix, samp


def _cornell_small():
    scene = presets.cornell_box()
    cam = scene.camera
    fresh = cam_mod.make_camera((16, 16), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * (cam.width // 2) / 8, b=cam.b * (cam.height // 2) / 8,
        c=cam.c))


def test_persistent_matches_masked_full_pool():
    scene = _cornell_small()
    pix, samp = _tasks(scene, 256, 2)
    sampler = smp.PCGSampler(3)
    ref = wavefront.render_samples(scene, sampler, pix, samp,
                                   max_depth=5, msaa=2)
    got = persistent.render_tasks_persistent(scene, sampler, pix, samp,
                                             max_depth=5, msaa=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_persistent_matches_masked_quarter_pool():
    scene = _cornell_small()
    pix, samp = _tasks(scene, 256, 2)
    sampler = smp.PCGSampler(3)
    ref = wavefront.render_samples(scene, sampler, pix, samp,
                                   max_depth=6, msaa=2)
    got = persistent.render_tasks_persistent(
        scene, sampler, pix, samp, n_lanes=128, max_depth=6, msaa=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_persistent_ray_count_not_higher():
    # The point of refill: traced-lane count (sum of active lanes per
    # launch) should not exceed the masked loop's, which pays all lanes
    # every bounce of every launch batch.
    scene = _cornell_small()
    pix, samp = _tasks(scene, 256, 4)
    sampler = smp.PCGSampler(0)
    _, cnt_masked = wavefront.render_samples(
        scene, sampler, pix, samp, max_depth=8, msaa=2,
        return_ray_count=True)
    _, cnt_persist = persistent.render_tasks_persistent(
        scene, sampler, pix, samp, n_lanes=256, max_depth=8, msaa=2,
        return_ray_count=True)
    assert float(cnt_persist) <= float(cnt_masked) * 1.01
