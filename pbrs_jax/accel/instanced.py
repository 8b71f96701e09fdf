"""Trace-time instancing: shared master geometry behind per-instance
affine transforms.

The reference intersects an instance by transforming the ray into shape
space with the inverse transform and mapping the hit back with the forward
one (reference tlas/src/instance.rs:50-67), so any affine instance
transform is exact and instanced geometry is stored once. The first build
of this renderer instead baked transforms into world-space tables at scene compile —
exact for quads/triangles, but a silent cbrt(|det|) approximation for
non-uniformly-scaled spheres, and ObjectInstance *replayed* geometry per
instance (O(N x geometry) device memory).

This module is the batched equivalent of the reference's trace-time
path: a master `GeometryTables` (object space, stored once) plus stacked
instance transforms [I, 3, 4]. Closest-hit runs a `lax.scan` over
instances — each step transforms the whole ray batch into object space
(rays keep an *unnormalized* direction so t is identical in both spaces)
and runs the master tracer, guarded by a `lax.cond` on a whole-batch slab
test of the instance's world bounds, so off-screen instances cost one
AABB test per ray at runtime. The detail pass gathers the winning
instance's transform per lane (an XLA gather over [I, 12] — tiny) and maps
position/normal/tangent back to world space with the forward /
inverse-transpose matrices, exactly like instance.rs:50-67 but over SoA
batches.

Device memory is O(master geometry + I), and ellipsoids (non-uniformly
scaled spheres) are exact.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from ..core import struct

from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from ..shapes import intersect as isect_mod
from ..shapes.tables import GeometryTables


@struct.dataclass
class InstanceGroup:
    """Master geometry + stacked instance transforms.

    fwd/inv are [I, 3, 4] object->world / world->object affine matrices;
    inv_t is the [I, 3, 3] inverse-transpose linear part (normal
    transform, reference geometry/src/transform.rs:314). bbox_lo/hi are
    per-instance world-space bounds of the master's transformed AABB.
    """

    geom: GeometryTables
    fwd: jnp.ndarray  # [I, 3, 4]
    inv: jnp.ndarray  # [I, 3, 4]
    inv_t: jnp.ndarray  # [I, 3, 3]
    bbox_lo: jnp.ndarray  # [I, 3]
    bbox_hi: jnp.ndarray  # [I, 3]


def make_group(master: GeometryTables, transforms,
               master_bound) -> InstanceGroup:
    """Host build. transforms: [I, 4, 4] object->world; master_bound:
    (lo, hi) object-space AABB of the master geometry."""
    tf = np.asarray(transforms, np.float64)
    assert tf.ndim == 3 and tf.shape[1:] == (4, 4), tf.shape
    fwd = tf[:, :3, :]
    inv = np.stack([np.linalg.inv(m)[:3, :] for m in tf])
    inv_t = np.stack([np.linalg.inv(m[:3, :3]).T for m in tf])
    lo, hi = (np.asarray(x, np.float64) for x in master_bound)
    corners = np.stack(
        [np.array([[lo, hi][ix][0], [lo, hi][iy][1], [lo, hi][iz][2]])
         for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)])  # [8,3]
    wc = np.einsum("iab,cb->ica", fwd[:, :, :3], corners) + fwd[:, None, :, 3]
    return InstanceGroup(
        geom=master,
        fwd=jnp.asarray(fwd, jnp.float32),
        inv=jnp.asarray(inv, jnp.float32),
        inv_t=jnp.asarray(inv_t, jnp.float32),
        bbox_lo=jnp.asarray(wc.min(axis=1), jnp.float32),
        bbox_hi=jnp.asarray(wc.max(axis=1), jnp.float32),
    )


def _apply_affine(m34, p):
    """[3,4] affine on points [N,3]."""
    return p @ m34[:, :3].T + m34[:, 3]


def _apply_linear(m, v):
    return v @ m[:, :3].T if m.shape[-1] == 4 else v @ m.T


def _transform_rays(rays, inv34):
    """World rays -> object space; direction left unnormalized so the hit
    parameter t is the same in both spaces (reference instance.rs:54-58
    renormalizes and rescales t; skipping normalization avoids both)."""
    return rays.replace(
        origin=_apply_affine(inv34, rays.origin),
        dir=_apply_linear(inv34, rays.dir),
    )


def _batch_hits_bbox(rays, lo, hi):
    """True when any ray's slab test hits the [3] world AABB."""
    inv = 1.0 / jnp.where(rays.dir == 0.0, 1e-30, rays.dir)
    t0 = (lo[None] - rays.origin) * inv
    t1 = (hi[None] - rays.origin) * inv
    t_in = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_out = jnp.min(jnp.maximum(t0, t1), axis=-1)
    ok = (t_in <= t_out) & (t_out >= ray_mod.T_MIN) & (t_in < rays.t_max)
    return jnp.any(ok)


def intersect_t_group(grp: InstanceGroup, rays, trace_t_fn):
    """Closest hit over all instances: returns (t [N], inst [N], win [N])
    with t=inf / inst=-1 on miss. trace_t_fn(geom, rays) -> (t, win) is the
    master t-only tracer (isect_mod.closest_t)."""
    n = rays.origin.shape[0]

    def body(carry, xs):
        t_best, inst_best, win_best, i = carry
        inv34, lo, hi = xs

        def do_trace(_):
            r_obj = _transform_rays(rays, inv34)
            return trace_t_fn(grp.geom, r_obj)

        def skip(_):
            return jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32)

        t_i, win_i = jax.lax.cond(
            _batch_hits_bbox(rays, lo, hi), do_trace, skip, operand=None)
        closer = t_i < t_best
        carry = (
            jnp.where(closer, t_i, t_best),
            jnp.where(closer, i, inst_best),
            jnp.where(closer, win_i, win_best),
            i + 1,
        )
        return carry, None

    init = (jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32),
            jnp.full((n,), -1, jnp.int32), jnp.int32(0))
    (t, inst, win, _), _ = jax.lax.scan(
        body, init, (grp.inv, grp.bbox_lo, grp.bbox_hi))
    return t, inst, win


def occluded_group(grp: InstanceGroup, rays, occlude_fn):
    """Any-hit over all instances. occlude_fn(geom, rays) -> bool [N]."""
    n = rays.origin.shape[0]

    def body(blocked, xs):
        inv34, lo, hi = xs

        def do_trace(_):
            # Already-blocked lanes keep their result; tracing them again
            # is harmless (pure OR).
            return occlude_fn(grp.geom, _transform_rays(rays, inv34))

        def skip(_):
            return jnp.zeros((n,), bool)

        hit_i = jax.lax.cond(
            _batch_hits_bbox(rays, lo, hi), do_trace, skip, operand=None)
        return blocked | hit_i, None

    blocked, _ = jax.lax.scan(
        body, jnp.zeros((n,), bool), (grp.inv, grp.bbox_lo, grp.bbox_hi))
    return blocked


def hit_from_group(grp: InstanceGroup, rays, t, inst, win) -> isect_mod.Hit:
    """Detail pass: object-space interaction for each lane's winning
    (instance, prim), mapped back to world space per instance.rs:50-67."""
    safe_inst = jnp.maximum(inst, 0)
    inv34 = grp.inv[safe_inst]  # [N, 3, 4] XLA gather
    fwd34 = grp.fwd[safe_inst]
    invt = grp.inv_t[safe_inst]  # [N, 3, 3]
    r_obj = rays.replace(
        origin=jnp.einsum("nab,nb->na", inv34[:, :, :3], rays.origin)
        + inv34[:, :, 3],
        dir=jnp.einsum("nab,nb->na", inv34[:, :, :3], rays.dir),
    )
    h = isect_mod.hit_from_t_idx(grp.geom, r_obj, t, win)
    pos_w = (jnp.einsum("nab,nb->na", fwd34[:, :, :3], h.pos)
             + fwd34[:, :, 3])
    n_w = vm.normalize(jnp.einsum("nab,nb->na", invt, h.normal))
    dpdu_w = jnp.einsum("nab,nb->na", fwd34[:, :, :3], h.dpdu)
    hit = h.hit & (inst >= 0)
    return h.replace(
        hit=hit,
        pos=jnp.where(hit[:, None], pos_w, h.pos),
        normal=jnp.where(hit[:, None], n_w, h.normal),
        dpdu=jnp.where(hit[:, None], dpdu_w, h.dpdu),
        wo=vm.normalize(-rays.dir),
        mat_id=jnp.where(hit, h.mat_id, -1),
    )


def merge_hits(a: isect_mod.Hit, b: isect_mod.Hit) -> isect_mod.Hit:
    """Per-lane closest of two Hit batches."""
    bw = b.hit & (b.t < a.t)

    def pick(x, y):
        s = bw[:, None] if x.ndim > 1 else bw
        return jnp.where(s, y, x)

    return isect_mod.Hit(
        t=pick(a.t, b.t), hit=a.hit | b.hit, pos=pick(a.pos, b.pos),
        normal=pick(a.normal, b.normal), uv=pick(a.uv, b.uv),
        dpdu=pick(a.dpdu, b.dpdu), mat_id=pick(a.mat_id, b.mat_id),
        wo=a.wo,
    )


FLATTEN_MAX = 16384  # instances x prims below this bake into the tracer


def flattenable(grp: InstanceGroup) -> bool:
    """True when the tracer may bake this group into world-space tables:
    small enough, and every primitive kind is exact under the group's
    transforms (tris/quads under any affine; spheres/disks only under
    similarities). This is a TRACER-side optimization — the Scene keeps
    the group (O(1) geometry memory is about HBM scene storage; a few
    thousand baked prims is the cheap case)."""
    g = grp.geom
    counts = isect_mod.geom_counts(g)
    n_inst = int(grp.fwd.shape[0])
    if n_inst * sum(counts) > FLATTEN_MAX:
        return False
    # Masters pad every prim kind to >= 1 row with never-hit dummies
    # (far-origin / zero-radius). Only REAL spheres/disks force the
    # similarity requirement — a dummy row must not pin a 4x72-triangle
    # group (the interior's chairs) to the trace-time path.
    sph_real = bool(np.any(
        (np.abs(np.asarray(g.sph_center)).max(axis=1) < 1e30)
        & (np.asarray(g.sph_radius) > 0.0)))
    disk_real = bool(np.any(
        np.abs(np.asarray(g.disk_center)).max(axis=1) < 1e30))
    if sph_real or disk_real:  # spheres / disks: need similarity
        fwd = np.asarray(grp.fwd)
        for m in fwd:
            m3 = np.asarray(m[:, :3], np.float64)
            mtm = m3.T @ m3
            s2 = np.trace(mtm) / 3.0
            if not np.allclose(mtm, s2 * np.eye(3),
                               atol=1e-4 * max(s2, 1.0)):
                return False
    return True


def flatten_groups(geom: GeometryTables, groups):
    """Bake `groups` into world-space copies appended to `geom`'s tables.
    Returns the combined GeometryTables. Dummy never-hit padding rows in
    the masters (far-origin primitives) are harmless to copy."""
    from ..shapes.tables import GeometryBuilder

    b = GeometryBuilder()

    def copy_tables(g, tf=None):
        mat3 = None if tf is None else np.asarray(tf[:, :3], np.float64)
        off = None if tf is None else np.asarray(tf[:, 3], np.float64)
        it = (None if tf is None
              else np.linalg.inv(mat3).T)

        def pt(p):
            p = np.asarray(p, np.float64)
            return p if tf is None else p @ mat3.T + off

        def vec(v):
            v = np.asarray(v, np.float64)
            return v if tf is None else v @ mat3.T

        def nrm(nv):
            nv = np.asarray(nv, np.float64)
            if tf is not None:
                nv = nv @ it.T
                ln = np.linalg.norm(nv, axis=-1, keepdims=True)
                nv = nv / np.maximum(ln, 1e-20)
            return nv

        scale = 1.0 if tf is None else float(
            np.cbrt(abs(np.linalg.det(mat3))))
        for c, r, m in zip(np.asarray(g.sph_center),
                           np.asarray(g.sph_radius),
                           np.asarray(g.sph_mat)):
            b.add_sphere(pt(c), float(r) * scale, int(m))
        for o, u, v, m in zip(np.asarray(g.quad_origin),
                              np.asarray(g.quad_u), np.asarray(g.quad_v),
                              np.asarray(g.quad_mat)):
            b.add_quad(pt(o), vec(u), vec(v), int(m))
        tris = (np.asarray(g.tri_p0), np.asarray(g.tri_p1),
                np.asarray(g.tri_p2))
        tn = (np.asarray(g.tri_n0), np.asarray(g.tri_n1),
              np.asarray(g.tri_n2))
        tuv = (np.asarray(g.tri_uv0), np.asarray(g.tri_uv1),
               np.asarray(g.tri_uv2))
        tp = [pt(p) for p in tris]
        tnn = [nrm(nv) for nv in tn]
        for i, m in enumerate(np.asarray(g.tri_mat)):
            b.add_triangle(
                tp[0][i], tp[1][i], tp[2][i], int(m),
                normals=(tnn[0][i], tnn[1][i], tnn[2][i]),
                uvs=(tuv[0][i], tuv[1][i], tuv[2][i]))
        for c, nv, r, m in zip(np.asarray(g.disk_center),
                               np.asarray(g.disk_normal),
                               np.asarray(g.disk_radial),
                               np.asarray(g.disk_mat)):
            b.add_disk(pt(c), nrm(nv[None])[0], vec(r), int(m))

    copy_tables(geom)
    for grp in groups:
        for m in np.asarray(grp.fwd):
            copy_tables(grp.geom, m)
    return b.build()
