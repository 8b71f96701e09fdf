"""Vectorized ray-primitive intersection over typed tables.

Two-phase closest-hit: (1) a t-only sweep of every ray against every
primitive, tiled over primitives so that no [N, K] matrix is ever live
(`closest_t` / `occluded`), (2) a detail pass that reconstructs
position/normal/uv/dpdu only for each ray's winning primitive. Replaces the reference's virtual-dispatch
`Shape::intersect` walk (reference shape/src/simple.rs).

Intentional fixes vs the reference (documented in COMPAT.md):
* quad inside-test uses *signed* parallelogram coordinates — the reference
  uses norm ratios (shape/src/simple.rs:136-137) which mirror the quad into
  all four uv sign quadrants;
* `occluded` uses any-valid-root semantics — the reference's sphere
  `occludes` requires both roots valid (simple.rs:268-288), its quad
  `occludes` inverts the t formula (simple.rs:153), and its disk `occludes`
  never truncates t (simple.rs:328-332).

Normals follow the reference convention: geometric normal flipped to face
the incoming ray (normal · wo >= 0, geometry/src/interaction.rs:24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import gather as gth
from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from .tables import GeometryTables, SPHERE, QUAD, TRIANGLE, DISK

INF = jnp.inf


@struct.dataclass
class Hit:
    t: jnp.ndarray  # [N]
    hit: jnp.ndarray  # [N] bool
    pos: jnp.ndarray  # [N,3]
    normal: jnp.ndarray  # [N,3] geometric/shading normal facing wo
    uv: jnp.ndarray  # [N,2]
    dpdu: jnp.ndarray  # [N,3] tangent hint
    mat_id: jnp.ndarray  # [N] int32
    wo: jnp.ndarray  # [N,3] unit, towards the ray origin


# ----------------------------- t-only kernels -----------------------------
# Each returns t [N,K] with +inf on miss (before t_max truncation), plus any
# cheap auxiliaries needed by the detail pass.


def _sphere_roots(rays, center, radius):
    """Robust quadratic per reference (shape/src/simple.rs:207-237).
    rays broadcast [N,1], prims [1,K] -> [N,K]."""
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    f = o - center[None, :, :]
    a = vm.dot(d, d)
    b_prime = -vm.dot(f, d)
    mid = f + (b_prime / a)[..., None] * d
    delta = radius[None, :] ** 2 - vm.dot(mid, mid)
    has_root = delta >= 0.0
    c = vm.dot(f, f) - radius[None, :] ** 2
    sign_b = jnp.where(b_prime >= 0.0, 1.0, -1.0)
    q = b_prime + sign_b * vm.safe_sqrt(delta * a)
    q_safe = jnp.where(q == 0.0, 1.0, q)
    t0 = c / q_safe
    t1 = q / a
    t_low = jnp.minimum(t0, t1)
    t_high = jnp.maximum(t0, t1)
    t_low = jnp.where(has_root & (q != 0.0), t_low, INF)
    t_high = jnp.where(has_root & (q != 0.0), t_high, INF)
    return t_low, t_high


def sphere_t(rays, center, radius):
    t_low, t_high = _sphere_roots(rays, center, radius)
    ok_low = (t_low >= ray_mod.T_MIN) & (t_low < rays.t_max[:, None])
    ok_high = (t_high >= ray_mod.T_MIN) & (t_high < rays.t_max[:, None])
    t = jnp.where(ok_low, t_low, jnp.where(ok_high, t_high, INF))
    return t


def _quad_uv_t(rays, origin, edge_u, edge_v):
    """Plane hit + signed parallelogram coordinates.
    [ref: shape/src/simple.rs:120-150, corrected sign handling]"""
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    n = vm.cross(edge_u, edge_v)[None, :, :]
    denom = vm.dot(d, n)
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    t = vm.dot(origin[None, :, :] - o, n) / denom_safe
    t = jnp.where(denom != 0.0, t, INF)
    p = o + t[..., None] * d
    dvec = p - origin[None, :, :]
    n2 = jnp.maximum(vm.dot(n, n), 1e-30)
    u = vm.dot(vm.cross(dvec, edge_v[None, :, :]), n) / n2
    v = vm.dot(vm.cross(edge_u[None, :, :], dvec), n) / n2
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return t, u, v, inside


def quad_t(rays, origin, edge_u, edge_v):
    t, _, _, inside = _quad_uv_t(rays, origin, edge_u, edge_v)
    valid = inside & (t >= ray_mod.T_MIN) & (t < rays.t_max[:, None])
    return jnp.where(valid, t, INF)


def _tri_bary_t(rays, p0, p1, p2):
    """Plane + signed-area barycentrics. [ref: shape/src/simple.rs:435-475]"""
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    n = vm.cross(p0 - p1, p2 - p1)[None, :, :]
    n = vm.normalize(n)
    denom = vm.dot(d, n)
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    t = vm.dot(p0[None, :, :] - o, n) / denom_safe
    t = jnp.where(denom != 0.0, t, INF)
    p = o + t[..., None] * d
    b2 = vm.dot(vm.cross(p - p0[None], p - p1[None]), n)
    b0 = vm.dot(vm.cross(p - p1[None], p - p2[None]), n)
    b1 = vm.dot(vm.cross(p - p2[None], p - p0[None]), n)
    pos_all = (b0 > 0) & (b1 > 0) & (b2 > 0)
    neg_all = (b0 < 0) & (b1 < 0) & (b2 < 0)
    inside = pos_all | neg_all
    total = b0 + b1 + b2
    total = jnp.where(total == 0.0, 1.0, total)
    return t, b0 / total, b1 / total, b2 / total, inside


def tri_t(rays, p0, p1, p2):
    t, _, _, _, inside = _tri_bary_t(rays, p0, p1, p2)
    valid = inside & (t >= ray_mod.T_MIN) & (t < rays.t_max[:, None])
    return jnp.where(valid, t, INF)


def _disk_t_raw(rays, center, normal, radial):
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    n = normal[None, :, :]
    denom = vm.dot(d, n)
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    t = vm.dot(center[None, :, :] - o, n) / denom_safe
    t = jnp.where(denom != 0.0, t, INF)
    p = o + t[..., None] * d
    inside = vm.dot(p - center[None], p - center[None]) <= vm.dot(radial, radial)[
        None, :
    ]
    return t, inside


def disk_t(rays, center, normal, radial):
    t, inside = _disk_t_raw(rays, center, normal, radial)
    valid = inside & (t >= ray_mod.T_MIN) & (t < rays.t_max[:, None])
    return jnp.where(valid, t, INF)


# ----------------------------- detail kernels -----------------------------
# Given per-ray winner primitive index (into the type's own table), rebuild
# the full interaction. Each works on [N] rays against [N] gathered prims.


def _sphere_detail(rays, t, params):
    c, r, mat = params
    p_raw = ray_mod.position_at(rays, t)
    n = vm.normalize(p_raw - c)
    # Push the hit point slightly outside the sphere surface.
    # [ref: shape/src/simple.rs:244]
    pos = c + n * (r * 1.00001)[..., None]
    theta = jnp.arccos(jnp.clip(n[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(n[..., 2], n[..., 0]) + jnp.pi
    uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)
    dpdu = vm.vec3(-n[..., 1], n[..., 0], jnp.zeros_like(t))
    degenerate = vm.dot(dpdu, dpdu) < 1e-12
    dpdu = jnp.where(
        degenerate[..., None],
        jnp.array([1.0, 0.0, 0.0], dtype=dpdu.dtype),
        vm.normalize(dpdu),
    )
    n = vm.face_forward(n, -rays.dir)
    # Keep dpdu perpendicular to the (possibly flipped) normal: it already is.
    return pos, n, uv, dpdu, mat


def _quad_detail(rays, t, params):
    origin, eu, ev, mat = params
    n_raw = vm.cross(eu, ev)
    p = ray_mod.position_at(rays, t)
    d = p - origin
    n2 = jnp.maximum(vm.dot(n_raw, n_raw), 1e-30)
    u = vm.dot(vm.cross(d, ev), n_raw) / n2
    v = vm.dot(vm.cross(eu, d), n_raw) / n2
    pos = origin + u[..., None] * eu + v[..., None] * ev
    n = vm.face_forward(vm.normalize(n_raw), -rays.dir)
    uv = jnp.stack([u, v], axis=-1)
    return pos, n, uv, eu, mat


def _tri_detail(rays, t, params):
    p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, mat = params
    n_geo = vm.normalize(vm.cross(p0 - p1, p2 - p1))
    p = ray_mod.position_at(rays, t)
    nrm = n_geo
    b2 = vm.dot(vm.cross(p - p0, p - p1), nrm)
    b0 = vm.dot(vm.cross(p - p1, p - p2), nrm)
    b1 = vm.dot(vm.cross(p - p2, p - p0), nrm)
    total = b0 + b1 + b2
    total = jnp.where(total == 0.0, 1.0, total)
    b0, b1, b2 = b0 / total, b1 / total, b2 / total
    pos = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    # Interpolate shading normal / uv from vertex attributes.
    ns = b0[..., None] * n0 + b1[..., None] * n1 + b2[..., None] * n2
    ns = vm.normalize(ns)
    degenerate = vm.dot(ns, ns) < 0.5
    ns = jnp.where(degenerate[..., None], n_geo, ns)
    uv = b0[..., None] * uv0 + b1[..., None] * uv1 + b2[..., None] * uv2
    n = vm.face_forward(ns, -rays.dir)
    dpdu = p1 - p0
    return pos, n, uv, dpdu, mat


def _disk_detail(rays, t, params):
    c, nd, radial, mat = params
    p = ray_mod.position_at(rays, t)
    cp = p - c
    cp = cp - vm.dot(cp, nd)[..., None] * nd
    n = vm.face_forward(nd, -rays.dir)
    tangent = vm.normalize(vm.cross(n, cp))
    u_angle = jnp.arctan2(
        vm.dot(vm.cross(radial, cp), n), vm.dot(radial, cp)
    )
    u = jnp.mod(u_angle / jnp.pi * 0.5 + 1.0, 1.0)
    v = vm.length(cp) / jnp.maximum(vm.length(radial), 1e-20)
    uv = jnp.stack([u, v], axis=-1)
    return c + cp, n, uv, tangent, mat


# ------------------------------- dispatch ---------------------------------


def geom_counts(geom: GeometryTables):
    return (
        geom.sph_center.shape[0], geom.quad_origin.shape[0],
        geom.tri_p0.shape[0], geom.disk_center.shape[0],
    )


# Primitives per sweep step. Each step holds an [N, SWEEP_TILE] block of
# candidate t values; a family with more primitives than this runs as a
# lax.scan over tiles, so live memory is O(N x SWEEP_TILE) whatever K is.
SWEEP_TILE = 256


def _families(geom: GeometryTables):
    """(t_fn, fields) per primitive family, in global-index order."""
    return (
        (sphere_t, (geom.sph_center, geom.sph_radius)),
        (quad_t, (geom.quad_origin, geom.quad_u, geom.quad_v)),
        (tri_t, (geom.tri_p0, geom.tri_p1, geom.tri_p2)),
        (disk_t, (geom.disk_center, geom.disk_normal, geom.disk_radial)),
    )


def _sweep(rays, families, step, carry, tile):
    """Fold step(carry, t [N, T], base) over every primitive tile of every
    (t_fn, fields) family. Families with more than `tile` primitives are padded to whole
    tiles by repeating their last primitive and scanned. A repeat has the
    same t as the primitive it copies and a higher index, so it can never
    win a lowest-index closest hit, and it cannot change an any-hit."""
    base = 0
    for t_fn, fields in families:
        k = int(fields[0].shape[0])
        if k == 0:
            continue
        if k <= tile:
            carry = step(carry, t_fn(rays, *fields), base)
        else:
            n_tiles = -(-k // tile)
            pad = n_tiles * tile - k

            def split(a):
                a = jnp.concatenate(
                    [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])])
                return a.reshape((n_tiles, tile) + a.shape[1:])

            def body(c, xs, t_fn=t_fn, base=base):
                i, tiled = xs
                return step(c, t_fn(rays, *tiled), base + i * tile), None

            carry, _ = jax.lax.scan(
                body, carry,
                (jnp.arange(n_tiles, dtype=jnp.int32),
                 tuple(split(a) for a in fields)))
        base += k
    return carry


def _closer(carry, t, base):
    t_best, idx = carry
    t_min = jnp.min(t, axis=1)
    closer = t_min < t_best  # strict: ties keep the lower global index
    win = base + jnp.argmin(t, axis=1).astype(jnp.int32)
    return jnp.where(closer, t_min, t_best), jnp.where(closer, win, idx)


def closest_t(geom: GeometryTables, rays: ray_mod.RayBatch,
              tile: int = SWEEP_TILE):
    """Closest hit t [N] (+inf on miss) and the winner's global index [N]
    over the sphere/quad/tri/disk concatenation (0 on miss). Ties go to
    the lowest index, as an argmin over the whole [N, K] matrix would."""
    n = rays.origin.shape[0]
    init = (jnp.full((n,), INF, jnp.float32), jnp.zeros((n,), jnp.int32))
    return _sweep(rays, _families(geom), _closer, init, tile)


def intersect(geom: GeometryTables, rays: ray_mod.RayBatch) -> Hit:
    """Closest-hit over all typed tables (jnp sweep path)."""
    t_best, win = closest_t(geom, rays)
    return hit_from_t_idx(geom, rays, t_best, win)


def hit_from_t_idx(geom: GeometryTables, rays, t_best, win) -> Hit:
    """Detail pass: rebuild the interaction for winner prim indices (global
    index over the sphere/quad/tri/disk concatenation; -1 or t=inf = miss)."""
    counts = geom_counts(geom)
    hit = jnp.isfinite(t_best) & (win >= 0)
    t_safe = jnp.where(hit, t_best, 1.0)
    win = jnp.maximum(win, 0)

    # Winner's (type, local index) — static counts, pure arithmetic.
    s_, q_, tr_ = counts[0], counts[0] + counts[1], sum(counts[:3])
    ptype = jnp.where(
        win < s_, SPHERE,
        jnp.where(win < q_, QUAD, jnp.where(win < tr_, TRIANGLE, DISK)),
    )
    local = win - jnp.where(
        win < s_, 0, jnp.where(win < q_, s_, jnp.where(win < tr_, q_, tr_))
    )

    packed = {
        SPHERE: (geom.sph_packed, geom.sph_layout, counts[0]),
        QUAD: (geom.quad_packed, geom.quad_layout, counts[1]),
        TRIANGLE: (geom.tri_packed, geom.tri_layout, counts[2]),
        DISK: (geom.disk_packed, geom.disk_layout, counts[3]),
    }
    details = []
    for kind, fn in (
        (SPHERE, _sphere_detail),
        (QUAD, _quad_detail),
        (TRIANGLE, _tri_detail),
        (DISK, _disk_detail),
    ):
        mat, layout, count = packed[kind]
        idx = jnp.clip(jnp.where(ptype == kind, local, 0), 0, count - 1)
        rows = gth.lookup_rows(mat, idx, count)
        details.append(fn(rays, t_safe, gth.unpack_fields(rows, layout)))

    def select(field_i):
        out = details[0][field_i]
        for kind in (QUAD, TRIANGLE, DISK):
            sel = (ptype == kind)
            val = details[kind][field_i]
            if val.ndim > sel.ndim:
                sel = sel[..., None]
            out = jnp.where(sel, val, out)
        return out

    pos, normal, uv, dpdu, mat_id = (select(i) for i in range(5))
    zero = jnp.zeros_like(pos)
    return Hit(
        t=jnp.where(hit, t_best, INF),
        hit=hit,
        pos=jnp.where(hit[:, None], pos, zero),
        normal=jnp.where(hit[:, None], normal, zero.at[..., 2].set(1.0)),
        uv=jnp.where(hit[:, None], uv, jnp.zeros_like(uv)),
        dpdu=jnp.where(hit[:, None], dpdu, zero.at[..., 0].set(1.0)),
        mat_id=jnp.where(hit, mat_id, -1).astype(jnp.int32),
        wo=vm.normalize(-rays.dir),
    )


def occluded(geom: GeometryTables, rays: ray_mod.RayBatch,
             tile: int = SWEEP_TILE) -> jnp.ndarray:
    """Any-hit within the ray extent (correct semantics; see module doc)."""
    def step(blocked, t, _base):
        return blocked | jnp.any(jnp.isfinite(t), axis=1)

    return _sweep(rays, _families(geom), step,
                  jnp.zeros(rays.origin.shape[0], bool), tile)
