"""Small material/light "zoo" scenes: each packs one family of BSDF
lobes, textures and light shapes into a frame of a few hundred pixels,
so one tiny render exercises every branch of that family. Used as
golden-checksum, chunk-invariance and launch-packing-invariance cases
(tests/test_zoo.py) and in the device-vs-CPU reference check
(chip_smoke.py)."""

from __future__ import annotations

import numpy as np

from ..geometry import camera as cam_mod
from ..lights import lights as lt
from . import presets
from .buffers import Scene, SceneBuilder


def _quad_light(b, color, origin, u, v):
    g = b.geometry
    g.add_quad(origin, u, v, b.materials.add_diffuse_light(color))
    b.lights.add_area_quad(color, origin, u, v)


def lobes() -> Scene:
    """Single-lobe kinds (microfacet metal, glossy, mirror, dielectric)
    + point/distant/quad lights + gradient env + tri/disk primitives."""
    b = SceneBuilder()
    g = b.geometry
    floor = b.materials.add_lambertian((0.6, 0.55, 0.5))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24), floor)
    g.add_sphere((-4.5, 1, 0), 1.0, b.materials.add_metal(
        presets.GOLD[0], presets.GOLD[1], 0.2))
    g.add_sphere((-1.5, 1, 0), 1.0, b.materials.add_glossy(
        (0.8, 0.8, 0.9), 0.05))
    g.add_sphere((1.5, 1, 0), 1.0, b.materials.add_mirror((0.95, 0.95, 0.95)))
    g.add_sphere((4.5, 1, 0), 1.0, b.materials.add_dielectric(1.5))
    red = b.materials.add_lambertian((0.7, 0.2, 0.2))
    g.add_triangle((-3, 0.01, -4), (0, 0.01, -2), (-1.5, 2.5, -3), red)
    g.add_disk((2.5, 1.2, -3.5), (0, 0.3, -1), (1.2, 0, 0), red)
    _quad_light(b, (6.0, 6.0, 6.0), (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    b.lights.add_point((6, 5, -6), (40, 35, 30))
    b.lights.add_distant((0.3, -1.0, 0.2), (0.5, 0.5, 0.55))
    b.lights.env = presets.BLUE_SKY
    cam = cam_mod.make_camera((24, 24), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 4, -14), (0, 1.5, 0), (0, 1, 0))
    return b.build()


def shaped_lights() -> Scene:
    """Sphere + disk + triangle area lights over glossy/lambert geometry:
    the per-shape NEE arms (cone sampling, concentric disk, triangle)."""
    b = SceneBuilder()
    g = b.geometry
    floor = b.materials.add_lambertian((0.55, 0.55, 0.6))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24), floor)
    g.add_sphere((-2, 1, 0), 1.0, b.materials.add_glossy((0.85, 0.8, 0.7),
                                                         0.03))
    g.add_sphere((2, 1, 0), 1.0, b.materials.add_lambertian((0.3, 0.5, 0.7)))
    c1 = (8.0, 7.0, 6.0)
    g.add_sphere((-4, 5, -3), 0.8, b.materials.add_diffuse_light(c1))
    b.lights.add_area_sphere(c1, (-4, 5, -3), 0.8)
    c2 = (5.0, 6.0, 8.0)
    g.add_disk((4, 6, -2), (0, -1, 0.2), (1.5, 0, 0),
               b.materials.add_diffuse_light(c2))
    b.lights.add_area_disk(c2, (4, 6, -2), (0, -1, 0.2), (1.5, 0, 0))
    c3 = (7.0, 7.0, 5.0)
    g.add_triangle((-1, 7, 2), (1, 7, 2), (0, 7, 4),
                   b.materials.add_diffuse_light(c3))
    b.lights.add_area_triangle(c3, (-1, 7, 2), (1, 7, 2), (0, 7, 4))
    cam = cam_mod.make_camera((20, 20), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 4, -12), (0, 1.5, 0), (0, 1, 0))
    return b.build()


def plastic() -> Scene:
    """Two-lobe mixtures: plastic (microfacet + lambert) and uber."""
    b = SceneBuilder()
    g = b.geometry
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               b.materials.add_lambertian((0.6, 0.6, 0.55)))
    g.add_sphere((-2, 1, 0), 1.0, b.materials.add_plastic(
        (0.5, 0.15, 0.12), (0.7, 0.7, 0.7), 0.08))
    g.add_sphere((2, 1, 0), 1.0, b.materials.add_uber(
        (0.2, 0.35, 0.55), (0.5, 0.5, 0.5), roughness=0.15))
    _quad_light(b, (9.0, 9.0, 9.0), (-2, 6, -2), (4, 0, 0), (0, 0, 4))
    b.lights.env = presets.BLUE_SKY
    cam = cam_mod.make_camera((20, 20), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 4, -10), (0, 1, 0), (0, 1, 0))
    return b.build()


def textured() -> Scene:
    """Checker floor + perlin sphere + solid-texture sphere under a quad
    light and gradient env: the procedural texture kinds."""
    b = SceneBuilder()
    g = b.geometry
    checker = b.textures.add_checker((0.8, 0.2, 0.2), (0.9, 0.9, 0.85))
    perlin = b.textures.add_perlin(2.0)
    solid = b.textures.add_solid((0.2, 0.6, 0.3))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               b.materials.add_matte(tex_id=checker))
    g.add_sphere((-1.5, 1, 0), 1.0, b.materials.add_matte(tex_id=perlin))
    g.add_sphere((1.5, 1, 0), 1.0, b.materials.add_matte(tex_id=solid))
    _quad_light(b, (6.0, 6.0, 6.0), (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    b.lights.env = presets.BLUE_SKY
    cam = cam_mod.make_camera((20, 20), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 3, -10), (0, 1, 0), (0, 1, 0))
    return b.build()


def layered() -> Scene:
    """Substrate (FresnelBlend), sigma>0 matte (Oren-Nayar), a
    delta+smooth uber mixture with opacity, image + checker textures, an
    image environment, delta lights and a sphere area light."""
    b = SceneBuilder()
    g = b.geometry
    rng = np.random.default_rng(5)
    tex_img = b.textures.add_image(rng.random((8, 8, 3)).astype(np.float32))
    tex_chk = b.textures.add_checker((0.7, 0.7, 0.2), (0.1, 0.1, 0.4))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               b.materials.add_lambertian(tex_id=tex_img))
    g.add_sphere((-4.5, 1, 0), 1.0,
                 b.materials.add_substrate((0.5, 0.3, 0.2), (0.3, 0.3, 0.3),
                                           0.08))
    g.add_sphere((-1.5, 1, 0), 1.0,
                 b.materials.add_matte((0.6, 0.5, 0.4), sigma_deg=20.0))
    g.add_sphere((1.5, 1, 0), 1.0, b.materials.add_uber(
        (0.3, 0.4, 0.5), (0.4, 0.4, 0.4), roughness=0.1, opacity=0.7))
    g.add_sphere((4.5, 1, 0), 1.0, b.materials.add_dielectric(1.5))
    g.add_sphere((0.0, 1, -3), 1.0, b.materials.add_mirror((0.9, 0.9, 0.9)))
    g.add_triangle((-3, 0.01, -5), (0, 0.01, -3), (-1.5, 2.5, -4),
                   b.materials.add_lambertian(tex_id=tex_chk))
    _quad_light(b, (6.0, 6.0, 6.0), (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    c2 = (8.0, 7.0, 6.0)
    g.add_sphere((-4, 5, -5), 0.8, b.materials.add_diffuse_light(c2))
    b.lights.add_area_sphere(c2, (-4, 5, -5), 0.8)
    b.lights.add_point((6, 5, -6), (40, 35, 30))
    b.lights.add_distant((0.3, -1.0, 0.2), (0.5, 0.5, 0.55))
    env = rng.random((8, 16, 3)).astype(np.float32)
    b.lights.env = lt.make_env_image(env, scale=(1.5, 1.5, 1.5))
    cam = cam_mod.make_camera((24, 24), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 4, -14), (0, 1.5, 0), (0, 1, 0))
    return b.build()


ZOO = {
    "zoo_lobes": lobes,
    "zoo_shaped_lights": shaped_lights,
    "zoo_plastic": plastic,
    "zoo_textured": textured,
    "zoo_layered": layered,
}
