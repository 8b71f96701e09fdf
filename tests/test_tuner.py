"""Pilot-measured configuration selection (pbrs_jax.tuner)."""

import jax.numpy as jnp
import numpy as np

from pbrs_jax import tuner
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


def test_tune_selects_and_matches_reference():
    """tune() must return a runnable winner whose image agrees with the
    plain masked wavefront of the SAME NEE structure (twoarm and folded
    candidates share the expectation but not the per-sample estimate, so
    the reference follows the winner's nee_mode)."""
    scene = _small_scene()
    sampler = smp.PCGSampler(3)
    n = 64 * 48
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)

    tuned = tuner.tune(scene, sampler, pix, sid, depth=4, msaa=2)
    assert tuned.label
    rad, count = tuned(pix, sid)
    ref = wavefront.render_samples(scene, sampler, pix, sid, max_depth=4,
                                   msaa=2, nee_mode=tuned.nee_mode)
    np.testing.assert_allclose(np.asarray(rad), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)
    assert float(count) > 0

    # masked() twin runs on any lane count (tail batches).
    twin = tuned.masked()
    half = n // 2
    rad2, _ = twin(pix[:half], sid[:half])
    assert np.isfinite(np.asarray(rad2)).all()


def test_tune_env_and_explicit_overrides(monkeypatch):
    scene = _small_scene()
    sampler = smp.PCGSampler(3)
    n = 64 * 48
    pix = jnp.arange(n, dtype=jnp.int32)
    sid = jnp.zeros(n, jnp.int32)

    # Explicit pin: the masked loop only, no shrink schedule.
    t = tuner.tune(scene, sampler, pix, sid, depth=3, msaa=1,
                   compact=False)
    assert t.schedule is None and not t.resort

    # env wins over the argument (kept for profiling scripts).
    monkeypatch.setenv("PBRS_COMPACT", "0")
    monkeypatch.setenv("PBRS_TUNER_NOCACHE", "1")
    t2 = tuner.tune(scene, sampler, pix, sid, depth=3, msaa=1,
                    compact="auto")
    assert t2.schedule is None and not t2.resort
