"""Every preset builds and renders a tiny finite frame (smoke coverage for
material/light/texture combinations), plus delta-light end-to-end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrs_jax.core import sampler as smp
from pbrs_jax.geometry import camera as cam_mod
from pbrs_jax.integrators import wavefront
from pbrs_jax.scene import presets


def _shrink(scene, size=16):
    cam = scene.camera
    fresh = cam_mod.make_camera((size, size), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (size // 2)),
        b=cam.b * ((cam.height // 2) / (size // 2)),
        c=cam.c,
    ))


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_preset_renders(name):
    if name == "everything":
        scene = presets.everything()  # full build exercises 3400 prims
    elif name == "mesh_ball":
        scene = presets.mesh_ball(levels=2)
    else:
        scene = presets.PRESETS[name]()
    scene = _shrink(scene)
    sampler = smp.PCGSampler(0)
    pix = jnp.arange(16 * 16)
    fn = jax.jit(lambda s: wavefront.render_samples(
        scene, sampler, pix, s, max_depth=3, msaa=1))
    img = np.asarray(fn(0))
    assert np.isfinite(img).all(), name
    assert img.min() >= 0.0, name
    assert img.mean() > 1e-4, name  # something is lit in every preset


def test_delta_lights_end_to_end(tmp_path):
    src = """
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 2 -6  0 0 0  0 1 0
WorldBegin
Material "matte" "rgb Kd" [.7 .7 .7]
Shape "trianglemesh" "point P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
      "integer indices" [0 1 2 0 2 3]
LightSource "point" "point from" [0 4 0] "rgb I" [30 30 30]
LightSource "distant" "point from" [0 1 0] "point to" [0 0 0]
            "rgb L" [0.4 0.4 0.4]
WorldEnd
"""
    path = tmp_path / "delta.pbrt"
    path.write_text(src)
    from pbrs_jax.scene.pbrt import loader as pbrt_loader

    scene = pbrt_loader.build_scene(str(path))
    assert scene.delta_lights.count == 2
    sampler = smp.PCGSampler(0)
    pix = jnp.arange(16 * 16)
    fn = jax.jit(lambda s: wavefront.render_samples(
        scene, sampler, pix, s, max_depth=2, msaa=2))
    acc = np.zeros((256, 3))
    for s in range(8):
        acc += np.asarray(fn(s))
    img = (acc / 8).reshape(16, 16, 3)
    assert np.isfinite(img).all()
    # Floor lit by both lights: brightness well above zero where visible.
    assert img.max() > 0.1
    # Point light: closer floor region brighter than the far corner.
    assert img[10:, 6:10].mean() > img[0:2, 0:2].mean()


def test_blackbody_and_spectrum_colors(tmp_path):
    src = """
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "blackbody L" [6500 1.0]
  Shape "sphere" "float radius" [1]
AttributeEnd
Material "matte" "spectrum Kd" [400 0.5 550 0.6 700 0.4]
Shape "sphere" "float radius" [0.5]
WorldEnd
"""
    path = tmp_path / "bb.pbrt"
    path.write_text(src)
    from pbrs_jax.scene.pbrt import loader as pbrt_loader

    scene = pbrt_loader.build_scene(str(path))
    emit = np.asarray(scene.area_lights.emit[0])
    assert emit.min() > 0  # blackbody 6500K has all channels
    # 6500K is near-white: channels within 2x of each other.
    assert emit.max() / emit.min() < 2.0
