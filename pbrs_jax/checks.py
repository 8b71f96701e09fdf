"""Reference checks shared by the test suite and chip_smoke.py.

* Golden checksums: every scene family gets a tiny deterministic render
  whose radiance sum is pinned (data/golden_checksums.json). The PCG
  sampler is stateless, so the values hold on every backend up to float
  reassociation (REL_TOL).
* Device-vs-reference image comparison: the same render on the
  accelerator and on the CPU backend (the plain reference: the same code,
  the same RNG streams), judged by compare_images().
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data",
                           "golden_checksums.json")
REL_TOL = 2e-3

# compare_images() limits, for f32 with "highest" matmul precision: the
# image sum within SUM_RTOL, and at most PIXEL_FRACTION of the pixels
# off by more than PIXEL_RTOL * (1 + |ref|). The pixel allowance exists
# because transcendentals and FMA contraction differ between XLA's CPU
# and GPU backends, and a last-bit difference can flip one lane's
# roulette or lobe choice.
SUM_RTOL = 2e-3
PIXEL_RTOL = 1e-3
PIXEL_FRACTION = 5e-3


def shrunk(scene, size=48, height=None):
    """The scene's camera re-made at size x height pixels, same view."""
    from .geometry import camera as cam_mod

    height = height or size
    cam = scene.camera
    fresh = cam_mod.make_camera((size, height), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (size // 2)),
        b=cam.b * ((cam.height // 2) / (height // 2)),
        c=cam.c,
    ))


def golden_families():
    """{name: (scene builder, max_depth)} for every pinned family."""
    from .scene import presets, zoo

    fams = {
        "cornell_box": (lambda: shrunk(presets.cornell_box()), 4),
        "mesh_ball_l2": (lambda: shrunk(presets.mesh_ball(levels=2)), 4),
        "plates": (lambda: shrunk(presets.plates()), 4),
        "two_perlin": (lambda: shrunk(presets.two_perlin_spheres()), 4),
        "env_mapped": (lambda: shrunk(presets.env_mapped()), 4),
        "mixed_spheres": (lambda: shrunk(presets.mixed_spheres()), 3),
        "everything": (lambda: shrunk(presets.everything(), size=32), 3),
    }
    for name, build in zoo.ZOO.items():
        fams[name] = (build, 4)
    return fams


def golden_checksum(scene, depth):
    """Radiance sum of samples 0 and 1 (PCG seed 0, msaa 2) over every
    pixel of the scene camera."""
    from .core import sampler as smp
    from .integrators import wavefront

    sampler = smp.PCGSampler(0)
    n = scene.camera.width * scene.camera.height
    pix = jnp.arange(n, dtype=jnp.int32)
    step = jax.jit(lambda s: jnp.sum(wavefront.render_samples(
        scene, sampler, pix, s, max_depth=depth, msaa=2)))
    return sum(float(step(jnp.int32(s))) for s in range(2))


def load_golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def golden_ok(got, want):
    return abs(got - want) <= REL_TOL * abs(want) + 1e-6


def center_crop_pixels(scene, size):
    """Pixel ids of the size x size block at the image center."""
    w, h = scene.camera.width, scene.camera.height
    size = min(size, w, h)
    y0, x0 = (h - size) // 2, (w - size) // 2
    ys, xs = np.mgrid[y0:y0 + size, x0:x0 + size]
    return (ys * w + xs).ravel().astype(np.int32), size


def render_crop(scene, device, size=64, spp=2, max_depth=5, seed=0):
    """Mean radiance [size, size, 3] of the center crop over samples
    0..spp-1 (PCG, msaa 2), computed on `device`."""
    from .accel import dispatch
    from .core import sampler as smp
    from .integrators import wavefront

    ids, size = center_crop_pixels(scene, size)
    scene = jax.device_put(scene, device)
    pix = jax.device_put(jnp.asarray(ids), device)
    sampler = smp.PCGSampler(seed)
    isect_fn, occl_fn = dispatch.make_trace_fns(scene)

    @jax.jit
    def step(sc, p, s):
        return wavefront.render_samples(sc, sampler, p, s,
                                        max_depth=max_depth, msaa=2,
                                        intersect_fn=isect_fn,
                                        occlude_fn=occl_fn)

    total = sum(np.asarray(step(scene, pix, s), np.float64)
                for s in range(spp))
    return (total / spp).reshape(size, size, 3)


def compare_images(img, ref):
    """Device image vs the reference. Returns max abs error, the share of
    pixels off, the relative error of the image sum, and whether all
    three limits hold (non-finite values never pass)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = bool(np.isfinite(img).all() and np.isfinite(ref).all())
    diff = np.abs(img - ref)
    off = (diff > PIXEL_RTOL * (1.0 + np.abs(ref))).reshape(
        -1, img.shape[-1]).any(axis=1)
    ref_sum = float(ref.sum())
    sum_rel = abs(float(img.sum()) - ref_sum) / max(abs(ref_sum), 1e-30)
    frac = float(off.mean())
    return {
        "max_abs": float(diff.max()) if diff.size else 0.0,
        "pixels_off": frac,
        "sum_rel": sum_rel,
        "ok": finite and sum_rel <= SUM_RTOL and frac <= PIXEL_FRACTION,
    }
