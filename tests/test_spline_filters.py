"""Spline and filter tests, mirroring reference math/src/spline.rs tests."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.core import filters, spline


def test_tridiagonal_known_solution():
    # [ref: spline.rs:312-340-style check]
    a = [1.0, 1.0]
    b = [4.0, 4.0, 4.0]
    c = [1.0, 1.0]
    d = [6.0, 12.0, 18.0]
    x = spline.tridiagonal_solve(a, b, c, d)
    full = np.array([[4, 1, 0], [1, 4, 1], [0, 1, 4]], float)
    np.testing.assert_allclose(full @ x, d, rtol=1e-10)


def test_cubic_spline_interpolates_nodes():
    xs = np.array([0.0, 1.0, 2.5, 4.0, 5.0])
    ys = np.array([1.0, 3.0, -2.0, 0.5, 4.0])
    sp = spline.CubicSpline(xs, ys)
    np.testing.assert_allclose(sp.evaluate(xs), ys, atol=1e-9)
    # Smooth between nodes: matches a quadratic for quadratic-ish data.
    xs2 = np.linspace(0, 5, 11)
    sp2 = spline.CubicSpline(xs2, xs2**2)
    mid = np.linspace(0.5, 4.5, 17)
    np.testing.assert_allclose(sp2.evaluate(mid), mid**2, rtol=2e-2, atol=0.05)


def test_catmull_rom_partition_of_unity():
    # [ref: spline.rs catmull_rom weight partition-of-unity test]
    grid = jnp.asarray([0.0, 0.7, 1.1, 2.0, 3.5, 4.0])
    xs = jnp.asarray(np.linspace(0.0, 4.0, 77, dtype=np.float32))
    offset, w = spline.catmull_rom_weights(grid, xs)
    np.testing.assert_allclose(np.asarray(w.sum(-1)), 1.0, atol=1e-5)
    taps = spline.catmull_rom_taps(grid, offset)
    assert int(taps.min()) >= 0 and int(taps.max()) <= 5


def test_catmull_rom_reproduces_linear():
    grid = jnp.asarray(np.linspace(0.0, 1.0, 9, dtype=np.float32))
    vals = 2.0 * np.asarray(grid) + 1.0
    xs = jnp.asarray(np.linspace(0.0, 1.0, 40, dtype=np.float32))
    offset, w = spline.catmull_rom_weights(grid, xs)
    taps = spline.catmull_rom_taps(grid, offset)
    interp = (jnp.asarray(vals)[taps] * w).sum(-1)
    np.testing.assert_allclose(np.asarray(interp), 2.0 * np.asarray(xs) + 1.0,
                               atol=1e-5)


def test_find_interval():
    grid = jnp.asarray([0.0, 1.0, 2.0, 3.0])
    xs = jnp.asarray([-1.0, 0.0, 0.5, 1.0, 2.9, 3.0, 9.0])
    i = np.asarray(spline.find_interval(grid, xs))
    np.testing.assert_array_equal(i, [0, 0, 0, 1, 2, 2, 2])


def test_gaussian_filter_fixed():
    # The reference Gaussian drops .exp() on the first term
    # (math/src/filter.rs:40-41); ours must equal the correct formula.
    x = np.array([0.0, 0.5, 1.0])
    alpha, radius = 2.0, 1.0
    want = np.exp(-alpha * x**2) - np.exp(-alpha * radius**2)
    got = filters.eval_filter_1d(filters.GAUSSIAN, radius, x, alpha=alpha)
    np.testing.assert_allclose(got, np.maximum(want, 0.0), rtol=1e-12)


def test_mitchell_partition():
    # Mitchell-Netravali (B=C=1/3) sums to ~1 over integer shifts.
    xs = np.linspace(-2, 2, 5001)
    f = filters.eval_filter_1d(filters.MITCHELL, 2.0, xs)
    integral = np.trapezoid(f, xs)
    np.testing.assert_allclose(integral, 1.0, atol=2e-2)


def test_filter_importance_sampling_matches_distribution():
    for kind, radius in [(filters.TRIANGLE, 1.5), (filters.GAUSSIAN, 2.0)]:
        table = filters.make_filter_cdf(kind, radius)
        assert not table.weighted  # non-negative filters carry weight 1
        u = jnp.asarray(np.random.default_rng(0).random(1 << 16, np.float32))
        xs, w = filters.sample_filter_offset(table, u)
        xs = np.asarray(xs)
        assert w is None
        assert np.abs(xs).max() <= radius + 1e-4
        # Histogram should match the normalized filter profile.
        hist, edges = np.histogram(xs, bins=32, range=(-radius, radius),
                                   density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        f = filters.eval_filter_1d(kind, radius, centers)
        f = f / np.trapezoid(f, centers)
        mask = f > 0.1
        np.testing.assert_allclose(hist[mask], f[mask], rtol=0.2)


def test_box_filter_sampling_uniform():
    table = filters.make_filter_cdf(filters.BOX, 0.5)
    u = jnp.asarray(np.linspace(0, 0.999999, 101, dtype=np.float32))
    xs, _ = filters.sample_filter_offset(table, u)
    xs = np.asarray(xs)
    np.testing.assert_allclose(xs[0], -0.5, atol=0.02)
    np.testing.assert_allclose(xs[-1], 0.5, atol=0.02)


def test_mitchell_weighted_fis_reconstructs_true_filter():
    # Weighted FIS must reproduce the *signed* Mitchell kernel: the weighted
    # histogram of samples converges to f/∫f (negative lobes included),
    # which the old |f|-clamped scheme cannot produce. [ADVICE r1 #3]
    radius = 2.0
    table = filters.make_filter_cdf(filters.MITCHELL, radius)
    assert table.weighted
    u = jnp.asarray(np.random.default_rng(1).random(1 << 18, np.float32))
    xs, w = filters.sample_filter_offset(table, u)
    xs, w = np.asarray(xs), np.asarray(w)
    assert (w < 0).any(), "negative lobes must yield negative weights"
    # E[w] == 1 (the film normalization invariant).
    np.testing.assert_allclose(w.mean(), 1.0, atol=5e-3)
    # Weighted density matches the signed filter, negative lobes included.
    hist, edges = np.histogram(xs, bins=40, range=(-radius, radius),
                               weights=w)
    hist = hist / (len(xs) * (edges[1] - edges[0]))
    centers = 0.5 * (edges[:-1] + edges[1:])
    f = filters.eval_filter_1d(filters.MITCHELL, radius, centers)
    xs_fine = np.linspace(-radius, radius, 4096)
    f_norm = np.trapezoid(
        filters.eval_filter_1d(filters.MITCHELL, radius, xs_fine), xs_fine
    )
    f = f / f_norm
    assert (f < 0).any()
    np.testing.assert_allclose(hist, f, atol=0.02)
