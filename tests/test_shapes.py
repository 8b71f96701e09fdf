"""Intersection correctness, modeled on the reference's frame/shape tests
(reference shape/tests/frame_test.rs, shape/src/blas.rs:497-522)."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.core import vecmath as vm
from pbrs_jax.geometry import ray as ray_mod
from pbrs_jax.shapes import tables, intersect


def _single_ray(origin, direction, t_max=np.inf):
    return ray_mod.make_rays(
        jnp.asarray([origin], jnp.float32),
        jnp.asarray([direction], jnp.float32),
        jnp.asarray([t_max], jnp.float32),
    )


def test_sphere_hit_normal_uv():
    g = tables.GeometryBuilder()
    g.add_sphere((0, 0, 0), 1.0, mat=0)
    geom = g.build()
    rays = _single_ray((0, 0, -5), (0, 0, 1))
    hit = intersect.intersect(geom, rays)
    assert bool(hit.hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 4.0, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(hit.normal[0]), [0, 0, -1], atol=1e-5
    )


def test_sphere_from_inside():
    g = tables.GeometryBuilder()
    g.add_sphere((0, 0, 0), 1.0, mat=0)
    geom = g.build()
    rays = _single_ray((0, 0, 0), (0, 0, 1))
    hit = intersect.intersect(geom, rays)
    assert bool(hit.hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 1.0, rtol=1e-4)
    # Normal faces the viewer (inward here).
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1], atol=1e-4)


def test_sphere_scale_invariance():
    # Mirrors frame_test.rs:54-85: direction scaled over orders of magnitude
    # with compensating t_max still hits.
    g = tables.GeometryBuilder()
    g.add_sphere((0, 4, 0), 1.0, mat=0)
    geom = g.build()
    for scale in [1e-3, 1e-1, 1.0, 1e2, 1e4]:
        rays = _single_ray((0, 0, 0), (0, scale, 0))
        hit = intersect.intersect(geom, rays)
        assert bool(hit.hit[0]), scale
        np.testing.assert_allclose(float(hit.t[0]) * scale, 3.0, rtol=1e-3)


def test_quad_hit_and_signed_inside():
    g = tables.GeometryBuilder()
    # xy quad from (0,0) to (1,2) at z=3.
    g.add_quad((0, 0, 3), (1, 0, 0), (0, 2, 0), mat=5)
    geom = g.build()
    hit = intersect.intersect(geom, _single_ray((0.5, 1.0, 0), (0, 0, 1)))
    assert bool(hit.hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 3.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(hit.uv[0]), [0.5, 0.5], atol=1e-5)
    assert int(hit.mat_id[0]) == 5
    # Mirrored quadrant must MISS (the reference's norm-ratio test would
    # wrongly hit here, shape/src/simple.rs:136-137).
    hit2 = intersect.intersect(geom, _single_ray((-0.5, 1.0, 0), (0, 0, 1)))
    assert not bool(hit2.hit[0])


def test_quad_normal_faces_viewer_both_sides():
    g = tables.GeometryBuilder()
    g.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), mat=0)
    geom = g.build()
    front = intersect.intersect(geom, _single_ray((0.5, 0.5, -1), (0, 0, 1)))
    back = intersect.intersect(geom, _single_ray((0.5, 0.5, 1), (0, 0, -1)))
    assert float(front.normal[0, 2]) < 0
    assert float(back.normal[0, 2]) > 0


def test_cuboid_decomposition_slab_equivalence():
    g = tables.GeometryBuilder()
    g.add_cuboid((0, 0, 0), (1, 1, 1), mat=0)
    geom = g.build()
    hit = intersect.intersect(geom, _single_ray((0.5, 0.5, -2), (0, 0, 1)))
    assert bool(hit.hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 2.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1], atol=1e-5)
    # From inside: hits far face.
    hit2 = intersect.intersect(geom, _single_ray((0.5, 0.5, 0.5), (0, 0, 1)))
    assert bool(hit2.hit[0])
    np.testing.assert_allclose(float(hit2.t[0]), 0.5, rtol=1e-4)


def test_cuboid_transformed():
    import pbrs_jax.geometry.transform as tf

    g = tables.GeometryBuilder()
    m = tf.compose(tf.translate((5, 0, 0)), tf.rotate_y(45.0))
    g.add_cuboid((-1, -1, -1), (1, 1, 1), mat=0, transform=m)
    geom = g.build()
    # Corner now at x distance sqrt(2) from center (5,0,0) along rotated axis.
    hit = intersect.intersect(geom, _single_ray((5, 0, -5), (0, 0, 1)))
    assert bool(hit.hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 5 - np.sqrt(2), rtol=1e-4)


def test_triangle_hit_barycentric_uv():
    g = tables.GeometryBuilder()
    g.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), mat=1)
    geom = g.build()
    hit = intersect.intersect(geom, _single_ray((0.25, 0.25, 5), (0, 0, -1)))
    assert bool(hit.hit[0])
    # uv = (b1, b2) with p = p0 + b1*(p1-p0) + b2*(p2-p0)
    np.testing.assert_allclose(np.asarray(hit.uv[0]), [0.25, 0.25], atol=1e-5)
    hit2 = intersect.intersect(geom, _single_ray((0.9, 0.9, 5), (0, 0, -1)))
    assert not bool(hit2.hit[0])


def test_disk_hit():
    g = tables.GeometryBuilder()
    g.add_disk((0, 0, 2), (0, 0, 1), (0.5, 0, 0), mat=0)
    geom = g.build()
    assert bool(intersect.intersect(geom, _single_ray((0.2, 0, 0), (0, 0, 1))).hit[0])
    assert not bool(
        intersect.intersect(geom, _single_ray((0.7, 0, 0), (0, 0, 1))).hit[0]
    )


def test_closest_of_many():
    g = tables.GeometryBuilder()
    g.add_sphere((0, 0, 5), 1.0, mat=1)
    g.add_quad((-2, -2, 3), (4, 0, 0), (0, 4, 0), mat=2)
    g.add_sphere((0, 0, 10), 1.0, mat=3)
    geom = g.build()
    hit = intersect.intersect(geom, _single_ray((0, 0, 0), (0, 0, 1)))
    assert int(hit.mat_id[0]) == 2  # quad at z=3 is closest
    np.testing.assert_allclose(float(hit.t[0]), 3.0, rtol=1e-5)


def test_occlusion_respects_t_max():
    g = tables.GeometryBuilder()
    g.add_sphere((0, 0, 5), 1.0, mat=0)
    geom = g.build()
    assert bool(intersect.occluded(geom, _single_ray((0, 0, 0), (0, 0, 1)))[0])
    # t_max before the sphere: unoccluded.
    assert not bool(
        intersect.occluded(geom, _single_ray((0, 0, 0), (0, 0, 1), t_max=3.0))[0]
    )
    # Shadow-ray style: unit-parameterized to a target at t=1.
    assert not bool(
        intersect.occluded(geom, _single_ray((0, 0, 0), (0, 0, 3.0), t_max=0.999))[0]
    )


def test_occlusion_from_inside_sphere():
    # Correct any-hit: a ray starting inside a sphere IS occluded (the
    # reference required both roots valid, shape/src/simple.rs:268-288).
    g = tables.GeometryBuilder()
    g.add_sphere((0, 0, 0), 1.0, mat=0)
    geom = g.build()
    assert bool(intersect.occluded(geom, _single_ray((0, 0, 0), (0, 0, 1)))[0])


def test_batched_rays():
    g = tables.GeometryBuilder()
    g.add_sphere((0, 0, 5), 1.0, mat=0)
    geom = g.build()
    n = 256
    origins = np.zeros((n, 3), np.float32)
    dirs = np.tile(np.array([[0, 0, 1.0]], np.float32), (n, 1))
    dirs[: n // 2] = [0, 1, 0]  # half the rays miss
    rays = ray_mod.make_rays(jnp.asarray(origins), jnp.asarray(dirs))
    hit = intersect.intersect(geom, rays)
    assert not np.any(np.asarray(hit.hit[: n // 2]))
    assert np.all(np.asarray(hit.hit[n // 2 :]))
