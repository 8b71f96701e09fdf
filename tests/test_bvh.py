"""Host BVH builder tests: soundness, native vs NumPy builds, and the
flat DFS + skip-link layout that a per-lane traversal walks."""

import numpy as np
import jax.numpy as jnp

from pbrs_jax.accel import bvh as bvh_mod
from pbrs_jax.geometry import ray as ray_mod
from pbrs_jax.scene import subdivision
from pbrs_jax.shapes import intersect as im


def _mesh(levels=2):
    pos = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    idx = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64
    )
    pos, idx = subdivision.loop_subdivide(pos, idx, levels)
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    return pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]


def test_bvh_build_sound():
    p0, p1, p2 = _mesh(3)
    lo, hi = bvh_mod.triangle_bboxes(p0, p1, p2)
    bvh = bvh_mod.build_bvh(lo, hi)
    assert bvh_mod.validate_bvh(bvh, lo, hi)
    # Every primitive appears exactly once across leaves.
    assert sorted(bvh.prim_order.tolist()) == list(range(p0.shape[0]))
    leaf_total = bvh.count[bvh.is_leaf > 0].sum()
    assert leaf_total == p0.shape[0]
    assert bvh.depth < 40


def test_native_builder_matches_numpy_validity():
    from pbrs_jax.accel import native

    p0, p1, p2 = _mesh(3)
    lo, hi = bvh_mod.triangle_bboxes(p0, p1, p2)
    nat = native.build_bvh_native(lo, hi, max_leaf=8)
    assert nat is not None, "native build failed to compile"
    assert bvh_mod.validate_bvh(nat, lo, hi)
    assert sorted(nat.prim_order.tolist()) == list(range(p0.shape[0]))
    assert nat.count[nat.is_leaf > 0].sum() == p0.shape[0]
    # Skip links form a valid DFS threading: every interior node's right
    # child is within bounds and skip targets are monotone.
    nn = nat.bbox_min.shape[0]
    assert (nat.skip > np.arange(nn)).all() and (nat.skip <= nn).all()
    # A stackless walk over each tree's DFS + skip layout finds the same
    # closest hits as the brute-force sweep.
    rng = np.random.default_rng(0)
    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = -o + rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    rays = ray_mod.make_rays(jnp.asarray(o), jnp.asarray(d))
    t_ref = np.asarray(im.closest_t(_tri_geom(p0, p1, p2), rays)[0])
    assert np.isfinite(t_ref).mean() > 0.5
    py = bvh_mod.build_bvh(lo, hi, max_leaf=8, use_native=False)
    for tree in (nat, py):
        t_walk = _walk(tree, p0, p1, p2, o, d)
        both_inf = np.isinf(t_walk) & np.isinf(t_ref)
        close = np.isclose(t_walk, t_ref, rtol=1e-4, atol=1e-5)
        assert np.mean(both_inf | close) > 0.999


def _tri_geom(p0, p1, p2):
    from pbrs_jax.shapes.tables import GeometryBuilder

    g = GeometryBuilder()
    for a, b, c in zip(p0, p1, p2):
        g.add_triangle(a, b, c, mat=0)
    return g.build()


def _walk(bvh, p0, p1, p2, origins, dirs):
    """Closest-hit t per ray by threaded (stackless) traversal: visit
    nodes in DFS order, descend to node + 1 on a box hit, jump to
    skip[node] after a leaf or on a box miss."""
    out = np.full(len(origins), np.inf)
    for r, (o, d) in enumerate(zip(origins.astype(np.float64),
                                   dirs.astype(np.float64))):
        inv = 1.0 / np.where(d == 0.0, 1e-30, d)
        best, node = np.inf, 0
        while node < bvh.bbox_min.shape[0]:
            t0 = (bvh.bbox_min[node] - o) * inv
            t1 = (bvh.bbox_max[node] - o) * inv
            t_in = np.minimum(t0, t1).max()
            t_out = np.maximum(t0, t1).min()
            if t_in > t_out or t_out < 0.0 or t_in > best:
                node = bvh.skip[node]
                continue
            if not bvh.is_leaf[node]:
                node += 1
                continue
            first, count = bvh.first[node], bvh.count[node]
            for k in bvh.prim_order[first:first + count]:
                best = min(best, _moller_trumbore(o, d, p0[k], p1[k], p2[k]))
            node = bvh.skip[node]
        out[r] = best
    return out


def _moller_trumbore(o, d, a, b, c):
    e1, e2 = b - a, c - a
    pv = np.cross(d, e2)
    det = e1 @ pv
    if abs(det) < 1e-12:
        return np.inf
    tv = o - a
    u = (tv @ pv) / det
    qv = np.cross(tv, e1)
    v = (d @ qv) / det
    t = (e2 @ qv) / det
    if u < 0.0 or v < 0.0 or u + v > 1.0 or t < ray_mod.T_MIN:
        return np.inf
    return t
