"""Math substrate tests, mirroring the reference doc-tests/unit tests
(reference math/src/hcm.rs:668-706)."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.core import vecmath as vm


def test_reflect_simple():
    # Reflecting a 45-degree incoming vector about +z.
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = vm.normalize(jnp.array([[1.0, 0.0, 1.0]]))
    r = vm.reflect(n, wi)
    np.testing.assert_allclose(
        np.asarray(r), np.asarray(vm.normalize(jnp.array([[-1.0, 0.0, 1.0]]))),
        atol=1e-6,
    )


def test_reflect_unnormalized_normal():
    n = jnp.array([[0.0, 0.0, 2.5]])
    wi = vm.normalize(jnp.array([[0.3, -0.4, 0.86]]))
    r1 = vm.reflect(n, wi)
    r2 = vm.reflect(vm.normalize(n), wi)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), atol=1e-6)


def test_refract_straight_through():
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = jnp.array([[0.0, 0.0, 1.0]])
    d, full = vm.refract(n, wi, jnp.array([1.0]))
    assert not bool(full[0])
    np.testing.assert_allclose(np.asarray(d), [[0.0, 0.0, -1.0]], atol=1e-6)


def test_refract_snell():
    # 45 deg incidence air->glass (eta ratio 1/1.5): sin_o = sin_i / 1.5.
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = vm.normalize(jnp.array([[1.0, 0.0, 1.0]]))
    eta = jnp.array([1.0 / 1.5])
    d, full = vm.refract(n, wi, eta)
    assert not bool(full[0])
    sin_o = float(jnp.abs(d[0, 0]))
    np.testing.assert_allclose(sin_o, np.sin(np.pi / 4) / 1.5, atol=1e-6)
    assert float(d[0, 2]) < 0.0  # transmitted to the other side


def test_refract_total_internal_reflection():
    # Glass->air beyond the critical angle (sin_c = 1/1.5 -> ~41.8 deg).
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = vm.normalize(jnp.array([[1.0, 0.0, 0.8]]))  # ~51 deg
    d, full = vm.refract(n, wi, jnp.array([1.5]))
    assert bool(full[0])
    np.testing.assert_allclose(
        np.asarray(d), np.asarray(vm.reflect(n, wi)), atol=1e-6
    )


def test_make_coord_system_orthonormal():
    rng = np.random.default_rng(0)
    v = vm.normalize(jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)))
    v1, v2 = vm.make_coord_system(v)
    np.testing.assert_allclose(np.asarray(vm.dot(v, v1)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(v, v2)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(v1, v2)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(v1)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(v2)), 1.0, atol=1e-5)
    # Right-handed: v x v1 = v2.
    np.testing.assert_allclose(
        np.asarray(vm.cross(v, v1)), np.asarray(v2), atol=1e-5
    )


def test_orthonormal_frame_degenerate_hint():
    n = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    hints = jnp.array([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]])  # parallel / zero
    t, b, nn = vm.orthonormal_frame(n, hints)
    det = vm.dot(vm.cross(t, b), nn)
    np.testing.assert_allclose(np.asarray(det), 1.0, atol=1e-5)


def test_weak_recip():
    x = jnp.array([0.0, 2.0, -4.0])
    np.testing.assert_allclose(np.asarray(vm.weak_recip(x)), [0.0, 0.5, -0.25])
