"""The jnp primitive sweep (closest hit and any hit) per primitive family:
against an independent NumPy float64 brute force, and its tiled form
against the whole [N, K] t-matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrs_jax.geometry import ray as ray_mod
from pbrs_jax.shapes import intersect as im
from pbrs_jax.shapes.tables import GeometryBuilder

FAMILIES = ("sphere", "quad", "tri", "disk", "mixed")


def _prims(family, k, rng):
    """Random primitives of one family in the [-3, 3]^3 box."""
    c = rng.uniform(-3, 3, (k, 3))
    if family == "sphere":
        return [("sphere", c[i], rng.uniform(0.1, 0.6)) for i in range(k)]
    if family == "quad":
        return [("quad", c[i], rng.normal(size=3) * 0.6,
                 rng.normal(size=3) * 0.6) for i in range(k)]
    if family == "tri":
        return [("tri", c[i], c[i] + rng.normal(size=3) * 0.6,
                 c[i] + rng.normal(size=3) * 0.6) for i in range(k)]
    if family == "disk":
        out = []
        for i in range(k):
            nrm = rng.normal(size=3)
            nrm /= np.linalg.norm(nrm)
            radial = np.cross(nrm, rng.normal(size=3))
            radial *= rng.uniform(0.1, 0.6) / np.linalg.norm(radial)
            out.append(("disk", c[i], nrm, radial))
        return out
    per = k // 4
    return sum((_prims(f, per, rng) for f in FAMILIES[:4]), [])


def _scene(family, k, seed=0):
    rng = np.random.default_rng(seed)
    prims = _prims(family, k, rng)
    g = GeometryBuilder()
    for p in prims:
        {"sphere": lambda c, r: g.add_sphere(c, r, 0),
         "quad": lambda o, u, v: g.add_quad(o, u, v, 0),
         "tri": lambda a, b, c: g.add_triangle(a, b, c, 0),
         "disk": lambda c, n, r: g.add_disk(c, n, r, 0)}[p[0]](*p[1:])
    n = 1024
    o = rng.uniform(-5, 5, (n, 3))
    d = rng.uniform(-3, 3, (n, 3)) - o
    t_max = np.where(rng.random(n) < 0.25, rng.uniform(0.2, 1.0, n), np.inf)
    rays = ray_mod.make_rays(jnp.asarray(o, jnp.float32),
                             jnp.asarray(d, jnp.float32),
                             jnp.asarray(t_max, jnp.float32))
    return g.build(), prims, rays


def _np_t(prim, o, d):
    """float64 ray-primitive t per ray [N] (+inf on miss, no extent test)."""
    kind = prim[0]
    if kind == "sphere":
        _, c, r = prim
        f = o - c
        a = (d * d).sum(1)
        b = (f * d).sum(1)
        disc = b * b - a * ((f * f).sum(1) - r * r)
        sq = np.sqrt(np.maximum(disc, 0.0))
        return np.where(disc >= 0, np.stack([(-b - sq) / a, (-b + sq) / a]),
                        np.inf)
    if kind in ("quad", "disk"):
        if kind == "quad":
            _, org, u, v = prim
            nrm = np.cross(u, v)
        else:
            _, org, nrm, radial = prim
        denom = d @ nrm
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((org - o) @ nrm) / denom
        p = o + t[:, None] * d - org
        if kind == "quad":
            n2 = nrm @ nrm
            uu = np.cross(p, v) @ nrm / n2
            vv = np.cross(u, p) @ nrm / n2
            inside = (uu >= 0) & (uu <= 1) & (vv >= 0) & (vv <= 1)
        else:
            inside = (p * p).sum(1) <= radial @ radial
        return np.where(inside & (denom != 0), t, np.inf)[None]
    _, a, b, c = prim  # Moller-Trumbore
    e1, e2 = b - a, c - a
    pv = np.cross(d, e2)
    det = pv @ e1
    tv = o - a
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (tv * pv).sum(1) / det
        qv = np.cross(tv, e1)
        v = (qv * d).sum(1) / det
        t = (qv @ e2) / det
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (det != 0)
    return np.where(ok, t, np.inf)[None]


def _np_sweep(prims, rays):
    """Closest valid t and family-local winner per ray, any-hit mask."""
    o = np.asarray(rays.origin, np.float64)
    d = np.asarray(rays.dir, np.float64)
    t_max = np.asarray(rays.t_max, np.float64)
    ts = []
    for p in prims:
        roots = _np_t(p, o, d)
        roots = np.where((roots >= ray_mod.T_MIN) & (roots < t_max), roots,
                         np.inf)
        ts.append(roots.min(axis=0))
    t_all = np.stack(ts, axis=1)
    return t_all.min(axis=1), t_all.argmin(axis=1), np.isfinite(t_all).any(1)


def _global_index(geom, prims, local):
    """Map a position in `prims` to the sweep's global index."""
    counts = im.geom_counts(geom)
    base = {"sphere": 0, "quad": counts[0], "tri": sum(counts[:2]),
            "disk": sum(counts[:3])}
    seen = {"sphere": 0, "quad": 0, "tri": 0, "disk": 0}
    out = []
    for p in prims:
        out.append(base[p[0]] + seen[p[0]])
        seen[p[0]] += 1
    return np.asarray(out)[local]


@pytest.mark.parametrize("family", FAMILIES)
def test_closest_hit_matches_numpy_brute_force(family):
    geom, prims, rays = _scene(family, 600)  # > SWEEP_TILE: scanned
    t_ref, local, _ = _np_sweep(prims, rays)
    t, idx = (np.asarray(a) for a in im.closest_t(geom, rays))
    hit_ref = np.isfinite(t_ref)
    assert hit_ref.mean() > 0.2  # non-vacuous
    assert np.mean(np.isfinite(t) == hit_ref) > 0.995
    both = np.isfinite(t) & hit_ref
    assert np.mean(np.isclose(t[both], t_ref[both], rtol=1e-3,
                              atol=1e-4)) > 0.995
    want = _global_index(geom, prims, local)
    assert np.mean(idx[both] == want[both]) > 0.99


@pytest.mark.parametrize("family", FAMILIES)
def test_any_hit_matches_numpy_brute_force(family):
    geom, prims, rays = _scene(family, 600, seed=1)
    _, _, any_ref = _np_sweep(prims, rays)
    got = np.asarray(im.occluded(geom, rays))
    assert 0.1 < any_ref.mean() < 1.0  # extents cut some rays short
    assert np.mean(got == any_ref) > 0.995


@pytest.mark.parametrize("tile", (1, 7, 64, im.SWEEP_TILE))
def test_sweep_fold_is_exact_whole_matrix_argmin(tile):
    """Given the t values, the tiled fold (families of 0..700 primitives,
    padded last tiles, ties, all-miss rows) returns exactly the min,
    lowest-index argmin and any-finite of the whole [N, K] matrix."""
    rng = np.random.default_rng(tile)
    sizes = (1, 0, 700, 65)
    n = 64
    mat = rng.choice([0.5, 1.0, 2.0, 3.0, np.inf], size=(n, sum(sizes)),
                     p=[0.05, 0.05, 0.05, 0.05, 0.8]).astype(np.float32)
    mat[:8] = np.inf  # rays that hit nothing
    cols = np.arange(sum(sizes), dtype=np.int32)
    bounds = np.cumsum((0,) + sizes)
    families = [(lambda r, c: jnp.asarray(mat)[:, c],
                 (jnp.asarray(cols[bounds[i]:bounds[i + 1]]),))
                for i in range(len(sizes))]
    rays = ray_mod.make_rays(jnp.zeros((n, 3)), jnp.ones((n, 3)))
    init = (jnp.full((n,), jnp.inf), jnp.zeros((n,), jnp.int32))
    t, idx = im._sweep(rays, families, im._closer, init, tile)
    np.testing.assert_array_equal(np.asarray(t), mat.min(axis=1))
    np.testing.assert_array_equal(np.asarray(idx), mat.argmin(axis=1))
    hit = im._sweep(rays, families,
                    lambda c, tt, _b: c | jnp.isfinite(tt).any(axis=1),
                    jnp.zeros(n, bool), tile)
    np.testing.assert_array_equal(np.asarray(hit),
                                  np.isfinite(mat).any(axis=1))


@pytest.mark.parametrize("tile", (7, 64, im.SWEEP_TILE))
@pytest.mark.parametrize("family", FAMILIES)
def test_tiled_sweep_matches_whole_matrix(family, tile):
    """The tiled sweep agrees with one argmin over the whole [N, K]
    matrix of the same t functions (up to the last bits that XLA's fusion
    of different shapes may change)."""
    geom, _, rays = _scene(family, 300, seed=2)

    @jax.jit
    def whole(r):
        t_all = jnp.concatenate([fn(r, *fields)
                                 for fn, fields in im._families(geom)],
                                axis=1)
        return (t_all.min(axis=1), t_all.argmin(axis=1),
                jnp.isfinite(t_all).any(axis=1))

    t_ref, idx_ref, any_ref = (np.asarray(a) for a in whole(rays))
    t, idx = (np.asarray(a) for a in jax.jit(
        lambda r: im.closest_t(geom, r, tile=tile))(rays))
    assert np.isfinite(t_ref).mean() > 0.2
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_ref))
    hit = np.isfinite(t_ref)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5, atol=1e-6)
    assert np.mean(idx[hit] == idx_ref[hit]) > 0.999
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda r: im.occluded(geom, r, tile))(rays)),
        any_ref)
