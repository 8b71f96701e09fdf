"""Light sampling invariants, mirroring reference light tests
(reference light/tests/shape_sample_test.rs)."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.core import vecmath as vm
from pbrs_jax.lights import sample_shape as ss
from pbrs_jax.lights import lights as lt


def _params(n, p0=(0, 0, 0), p1=(1, 0, 0), p2=(0, 1, 0), scalar=1.0):
    t3 = lambda x: jnp.tile(jnp.asarray(x, jnp.float32)[None], (n, 1))
    return {
        "p0": t3(p0), "p1": t3(p1), "p2": t3(p2),
        "scalar": jnp.full(n, scalar, jnp.float32),
    }


def test_sphere_cone_pdf_integrates_to_one():
    # ∫ pdf dω over the sphere-subtended cone == 1.
    # [ref: shape_sample_test.rs:9-20,68-90]
    n_theta, n_phi = 256, 64
    center = np.array([0.0, 0.0, 5.0])
    radius = 1.0
    ref = np.zeros(3)
    sin_t_max = radius / np.linalg.norm(center - ref)
    theta_max = np.arcsin(sin_t_max)
    thetas = (np.arange(n_theta) + 0.5) * theta_max / n_theta
    phis = (np.arange(n_phi) + 0.5) * 2 * np.pi / n_phi
    t, p = np.meshgrid(thetas, phis, indexing="ij")
    dirs = np.stack(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], axis=-1
    ).reshape(-1, 3)
    dw = (np.sin(t) * (theta_max / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    n = dirs.shape[0]
    kind = jnp.full(n, ss.SPHERE, jnp.int32)
    params = _params(n, p0=center, scalar=radius)
    pdf = ss.pdf_at(kind, params, jnp.zeros((n, 3), jnp.float32),
                    jnp.asarray(dirs, jnp.float32))
    integral = float(jnp.sum(pdf * jnp.asarray(dw, jnp.float32)))
    np.testing.assert_allclose(integral, 1.0, atol=2e-2)


def test_sphere_sample_towards_on_surface():
    # Sampled points lie on the sphere; normals radial; visible side.
    # [ref: shape_sample_test.rs:22-66]
    n = 4096
    rng = np.random.default_rng(0)
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    center = np.array([1.0, 2.0, 3.0])
    radius = 0.7
    kind = jnp.full(n, ss.SPHERE, jnp.int32)
    params = _params(n, p0=center, scalar=radius)
    target = jnp.tile(jnp.asarray([[4.0, 2.0, 3.0]], jnp.float32), (n, 1))
    pt, nrm = ss.sample_towards(kind, params, target, u2)
    d = np.linalg.norm(np.asarray(pt) - center, axis=1)
    np.testing.assert_allclose(d, radius, rtol=1e-3)
    rad_dir = (np.asarray(pt) - center) / radius
    dots = np.sum(rad_dir * np.asarray(nrm), axis=1)
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)
    # Visible hemisphere: normal faces the target (dot(n, target-pt) > 0)
    to_target = np.asarray(target) - np.asarray(pt)
    frac_facing = (np.sum(np.asarray(nrm) * to_target, axis=1) > 0).mean()
    assert frac_facing > 0.99


def test_quad_pdf_distance_squared():
    # pdf at doubled distance quadruples (distance² fix vs reference).
    n = 1
    kind = jnp.full(n, ss.QUAD, jnp.int32)
    params = _params(n, p0=(-1, -1, 0), p1=(2, 0, 0), p2=(0, 2, 0))
    wi = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    p_near = float(ss.pdf_at(kind, params, jnp.asarray([[0, 0, 2.0]]), wi)[0])
    p_far = float(ss.pdf_at(kind, params, jnp.asarray([[0, 0, 4.0]]), wi)[0])
    np.testing.assert_allclose(p_far / p_near, 4.0, rtol=1e-4)
    # Absolute value: dist²/(cos·A) = 4/(1·4) = 1.
    np.testing.assert_allclose(p_near, 1.0, rtol=1e-4)


def test_quad_sample_pdf_consistency():
    # MC: E[1/pdf(wi)] over area-sampled directions equals the solid angle.
    n = 1 << 14
    rng = np.random.default_rng(1)
    u2 = jnp.asarray(rng.random((n, 2), np.float32))
    kind = jnp.full(n, ss.QUAD, jnp.int32)
    params = _params(n, p0=(-0.5, -0.5, 3.0), p1=(1, 0, 0), p2=(0, 1, 0))
    target = jnp.zeros((n, 3), jnp.float32)
    pt, nrm = ss.sample_towards(kind, params, target, u2)
    wi = vm.normalize(pt - target)
    pdf = ss.pdf_at(kind, params, target, wi)
    assert float(jnp.min(pdf)) > 0
    # Solid angle estimate vs. direct integration of the quad.
    est = float(jnp.mean(1.0 / pdf))
    # direct numeric integration over the quad surface
    xs = np.linspace(-0.5 + 1e-3, 0.5 - 1e-3, 200)
    xx, yy = np.meshgrid(xs, xs)
    d2 = xx**2 + yy**2 + 9.0
    cos = 3.0 / np.sqrt(d2)
    omega = np.mean(cos / d2) * 1.0
    np.testing.assert_allclose(est, omega, rtol=2e-2)


def test_delta_point_light_falloff():
    b = lt.LightsBuilder()
    b.add_point((0.0, 5.0, 0.0), (100.0, 100.0, 100.0))
    b.world_radius = 10.0
    dl, _, _ = b.build()
    pos = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 4.0, 0.0]], jnp.float32)
    idx = jnp.zeros(2, jnp.int32)
    rad, wi, tgt = lt.sample_delta(dl, idx, pos)
    np.testing.assert_allclose(float(rad[0, 0]), 100.0 / 25.0, rtol=1e-5)
    np.testing.assert_allclose(float(rad[1, 0]), 100.0 / 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(wi), [[0, 1, 0], [0, 1, 0]], atol=1e-6)


def test_env_gradient_eval():
    env = lt.make_env_gradient((0.5, 0.7, 1.0), (1.0, 1.0, 1.0))
    up = lt.eval_env(env, jnp.asarray([[0.0, 1.0, 0.0]]))
    down = lt.eval_env(env, jnp.asarray([[0.0, -1.0, 0.0]]))
    np.testing.assert_allclose(np.asarray(up[0]), [0.5, 0.7, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(down[0]), [1.0, 1.0, 1.0], atol=1e-6)


def test_area_radiance_one_sided():
    b = lt.LightsBuilder()
    b.add_area_quad((5.0, 5.0, 5.0), (-1.0, 2.0, -1.0), (2.0, 0.0, 0.0),
                    (0.0, 0.0, 2.0))
    _, al, _ = b.build()
    # Quad normal = u×v = (2,0,0)×(0,0,2) = (0,-4,0): faces -y (downward).
    below = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    above = jnp.asarray([[0.0, 4.0, 0.0]], jnp.float32)
    idx = jnp.zeros(1, jnp.int32)
    u2 = jnp.asarray([[0.3, 0.6]], jnp.float32)
    rad_b, _, pdf_b, _ = lt.sample_area(al, idx, below, u2)
    rad_a, _, pdf_a, _ = lt.sample_area(al, idx, above, u2)
    assert float(rad_b[0, 0]) == 5.0  # lit from below
    assert float(rad_a[0, 0]) == 0.0  # dark from above
    assert float(pdf_b[0]) > 0
