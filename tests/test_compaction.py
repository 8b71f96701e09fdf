"""Shrink-schedule compaction: with the capacity margin holding (keep
probability 1) the compacted loop computes the same estimator as the
masked fori_loop — equal up to XLA reassociation (the Python-unrolled
loop compiles each bounce separately and fuses/contracts differently, a
measured ~1e-6 drift that appears even with NO compaction in the
schedule), and stays unbiased under forced capacity roulette."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrs_jax.core import sampler as smp
from pbrs_jax.integrators import wavefront
from pbrs_jax.scene import presets


def _small_scene():
    from pbrs_jax.geometry import camera as cam_mod

    scene = presets.mesh_ball(levels=2)
    cam = scene.camera
    fresh = cam_mod.make_camera((64, 48), 35.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation, c=cam.c,
        a=cam.a * (cam.width // 2) / 32, b=cam.b * (cam.height // 2) / 24,
    ))


def _matches_masked(sort_blocks, depth=5):
    scene = _small_scene()
    sampler = smp.PCGSampler(7)
    n = 64 * 48
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)

    ref = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=depth, msaa=2))()

    counts = np.asarray(jax.jit(lambda: wavefront.measure_alive(
        scene, sampler, pix, sid, max_depth=depth, msaa=2))())
    sched = wavefront.auto_schedule(counts, n, min_cap=256)
    assert sched[0] == n
    assert any(c < n for c in sched[1:]), (sched, counts)

    got = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=depth, msaa=2,
        shrink_schedule=sched, sort_blocks=sort_blocks))()
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.slow
def test_compacted_matches_masked():
    _matches_masked(sort_blocks=False)


@pytest.mark.slow
def test_compacted_sorted_matches_masked():
    # The spatial block re-sort changes lane placement only; the banked
    # image must be identical. (Slow: argsort compiles per unrolled
    # bounce on the 1-core CPU mesh.)
    _matches_masked(sort_blocks=True)


@pytest.mark.slow
def test_capacity_roulette_unbiased():
    """Force overflow (cap far below alive count): the rouletted estimate
    must agree with the full one in expectation."""
    scene = _small_scene()
    sampler = smp.PCGSampler(3)
    n = 64 * 48
    pix = jnp.arange(n, dtype=jnp.int32)

    # Tight schedule: bounce1+ capped at 512 lanes (alive ~ 1-2k).
    sched = (n, 512, 512, 512, 512)

    def mean_rad(schedule, samples):
        acc = 0.0
        f = jax.jit(lambda s: jnp.sum(wavefront.render_samples(
            scene, sampler, pix, jnp.full(n, s, jnp.int32), max_depth=5,
            msaa=2, shrink_schedule=schedule, sort_blocks=False)))
        for s in range(samples):
            acc += float(f(s))
        return acc / samples

    full = mean_rad(None, 24)
    thin = mean_rad(sched, 24)
    # Same pixel streams, so the only difference is roulette noise on the
    # post-bounce-1 tail; 3% agreement on the frame sum is ample.
    assert abs(thin - full) / abs(full) < 0.03, (thin, full)


def test_auto_schedule_shapes():
    s = wavefront.auto_schedule([1000.0, 100.0, 10.0, 1.0], 1024,
                                min_cap=16)
    assert s[0] == 1024
    assert all(b & (b - 1) == 0 for b in s[1:])
    assert all(s[i + 1] <= s[i] for i in range(len(s) - 1))


def test_resort_matches_masked():
    """Sort-only resort (cap == n, pure permutation, keep p == 1): the
    banked image must equal the masked loop up to reassociation."""
    scene = _small_scene()
    sampler = smp.PCGSampler(5)
    n = 64 * 48
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)

    ref = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=3, msaa=2))()
    got = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=3, msaa=2, resort=True))()
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               atol=1e-5, rtol=1e-4)


def test_resort_folded_matches_masked():
    """Resort with folded NEE: pending MIS contributions ride the
    permutation and bank to the right pixels."""
    scene = _small_scene()
    sampler = smp.PCGSampler(13)
    n = 64 * 48
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)

    ref = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=3, msaa=2,
        nee_mode="folded"))()
    got = jax.jit(lambda: wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=3, msaa=2,
        nee_mode="folded", resort=True))()
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               atol=1e-5, rtol=1e-4)
