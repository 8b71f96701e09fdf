"""--debug_checks: render-time invariant audit (debug_audit.py).

The reference's runtime assert layer (interaction.rs:45-61,
blas.rs:300-302, tlas/bvh.rs:62-71) becomes branchless violation
counters threaded through the bounce loop. Clean scenes must report
zero; a poisoned scene must be caught; the audit must not perturb the
estimate.
"""

import jax.numpy as jnp
import numpy as np

from pbrs_jax import render as render_mod
from pbrs_jax.core import sampler as smp
from pbrs_jax.integrators import debug_audit, wavefront
from pbrs_jax.scene import presets


def _small(scene, size=48):
    from pbrs_jax.geometry import camera as cam_mod

    cam = scene.camera
    fresh = cam_mod.make_camera((size, size), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (size // 2)),
        b=cam.b * ((cam.height // 2) / (size // 2)), c=cam.c))


def test_clean_render_reports_zero_and_identical_image():
    scene = _small(presets.cornell_box())
    sampler = smp.PCGSampler(0)
    pix = jnp.arange(48 * 48, dtype=jnp.int32)
    sid = jnp.zeros_like(pix)
    rad_plain = wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=4, msaa=1)
    rad_aud, counts = wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=4, msaa=1, audit=True)
    rep = debug_audit.report(counts)
    assert sum(rep.values()) == 0, rep
    # Auditing must not change the estimate (same RNG stream, same ops).
    np.testing.assert_allclose(np.asarray(rad_plain), np.asarray(rad_aud),
                               rtol=0, atol=0)


def test_poisoned_material_is_caught():
    # A NaN albedo is the classic silent corruption: lobe-selection
    # comparisons launder it into dead lanes, so the film goes black with
    # no error anywhere. Bake the NaN in like a corrupted scene file
    # would — a NaN-albedo sphere filling the view.
    from pbrs_jax.geometry import camera as cam_mod
    from pbrs_jax.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g = b.geometry
    g.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20),
               b.materials.add_lambertian((0.5, 0.5, 0.5)))
    g.add_sphere((0, 1, 0), 1.0,
                 b.materials.add_lambertian((np.nan, 0.5, 0.5)))
    light = (8.0, 8.0, 8.0)
    g.add_quad((-1, 5, -1), (2, 0, 0), (0, 0, 2),
               b.materials.add_diffuse_light(light))
    b.lights.add_area_quad(light, (-1, 5, -1), (2, 0, 0), (0, 0, 2))
    cam = cam_mod.make_camera((48, 48), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 1, -5), (0, 1, 0), (0, 1, 0))
    scene = b.build()

    sampler = smp.PCGSampler(0)
    pix = jnp.arange(48 * 48, dtype=jnp.int32)
    sid = jnp.zeros_like(pix)
    _, counts = wavefront.render_samples(
        scene, sampler, pix, sid, max_depth=4, msaa=1, audit=True)
    rep = debug_audit.report(counts)
    assert rep["nonfinite_material"] > 0, rep


def test_render_image_debug_checks_stats():
    scene = _small(presets.cornell_box())
    img, stats = render_mod.render_image(
        scene, spp=1, max_depth=3, debug_checks=True)
    assert stats.audit is not None
    assert set(stats.audit) == set(debug_audit.AUDIT_KEYS)
    assert sum(stats.audit.values()) == 0, stats.audit
    assert np.isfinite(img).all()
