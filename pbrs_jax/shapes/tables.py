"""Typed primitive tables: the device-resident scene geometry.

Design departure from the reference: the reference intersects rays against a
tree of `Arc<dyn Shape>` trait objects behind per-instance affine transforms
(reference tlas/src/instance.rs:50-67). Batched lanes cannot take virtual
dispatch, and per-ray matrix multiplies cost a full pass per instance, so
the scene compiler *bakes* instance
transforms into world-space primitives grouped by type:

* spheres   — center/radius       (rigid + uniform scale baked exactly)
* quads     — origin/edge_u/edge_v (any affine baked exactly; cuboids are
              decomposed into 6 quads, reference shape/src/simple.rs:343-411)
* triangles — p0/p1/p2            (any affine baked exactly)
* disks     — center/normal/radial

Each table also carries a per-primitive material id. Triangle meshes with
BVHs live in `pbrs_jax.accel`, not here.
"""

from __future__ import annotations

import logging

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core import gather as gth

SPHERE, QUAD, TRIANGLE, DISK = 0, 1, 2, 3

log = logging.getLogger(__name__)


def _is_similarity(m3, tol=1e-4):
    """True when the linear part is rotation × uniform scale (MᵀM ≈ s²·I) —
    the only transforms that keep spheres spherical and disks circular."""
    mtm = m3.T @ m3
    s2 = np.trace(mtm) / 3.0
    return bool(np.allclose(mtm, s2 * np.eye(3), atol=tol * max(s2, 1.0)))


@struct.dataclass
class GeometryTables:
    sph_center: jnp.ndarray  # [S,3]
    sph_radius: jnp.ndarray  # [S]
    sph_mat: jnp.ndarray  # [S] int32
    quad_origin: jnp.ndarray  # [Q,3]
    quad_u: jnp.ndarray  # [Q,3]
    quad_v: jnp.ndarray  # [Q,3]
    quad_mat: jnp.ndarray  # [Q] int32
    tri_p0: jnp.ndarray  # [T,3]
    tri_p1: jnp.ndarray  # [T,3]
    tri_p2: jnp.ndarray  # [T,3]
    tri_n0: jnp.ndarray  # [T,3] shading normals (area normal if not provided)
    tri_n1: jnp.ndarray  # [T,3]
    tri_n2: jnp.ndarray  # [T,3]
    tri_uv0: jnp.ndarray  # [T,2]
    tri_uv1: jnp.ndarray  # [T,2]
    tri_uv2: jnp.ndarray  # [T,2]
    tri_mat: jnp.ndarray  # [T] int32
    disk_center: jnp.ndarray  # [D,3]
    disk_normal: jnp.ndarray  # [D,3]
    disk_radial: jnp.ndarray  # [D,3]
    disk_mat: jnp.ndarray  # [D] int32
    # Per-type packed parameter matrices (one-shot row lookup in the
    # intersection detail pass; see core/gather.py).
    sph_packed: jnp.ndarray = None
    quad_packed: jnp.ndarray = None
    tri_packed: jnp.ndarray = None
    disk_packed: jnp.ndarray = None
    sph_layout: tuple = struct.field(pytree_node=False, default=())
    quad_layout: tuple = struct.field(pytree_node=False, default=())
    tri_layout: tuple = struct.field(pytree_node=False, default=())
    disk_layout: tuple = struct.field(pytree_node=False, default=())


class GeometryBuilder:
    """Host-side accumulator; `build()` pads each table to at least one
    never-hit dummy primitive so device shapes are non-empty and static."""

    def __init__(self):
        self.spheres = []  # (center, radius, mat)
        self.quads = []  # (origin, u, v, mat)
        self.tris = []  # (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, mat)
        self.disks = []  # (center, normal, radial, mat)

    # -- adders ------------------------------------------------------------
    def add_sphere(self, center, radius, mat: int, transform=None):
        center = np.asarray(center, np.float32)
        radius = float(radius)
        if transform is not None:
            m = np.asarray(transform, np.float64)
            if not _is_similarity(m[:3, :3]):
                # The baked sphere table can only hold true spheres; a
                # non-uniform scale / shear turns this one into an ellipsoid
                # that the cbrt(|det|) radius cannot represent. Use an
                # instanced scene (accel TLAS with trace-time transforms)
                # for exact ellipsoids. [ADVICE r1 #2]
                log.warning(
                    "add_sphere: non-similarity transform approximated by "
                    "uniform cbrt(|det|) scale; ellipsoids render as "
                    "spheres on the baked path (see COMPAT.md)"
                )
            scale = np.cbrt(abs(np.linalg.det(m[:3, :3])))
            center = (m[:3, :3] @ center + m[:3, 3]).astype(np.float32)
            radius *= float(scale)
        self.spheres.append((center, radius, mat))

    def add_quad(self, origin, edge_u, edge_v, mat: int, transform=None):
        origin = np.asarray(origin, np.float32)
        edge_u = np.asarray(edge_u, np.float32)
        edge_v = np.asarray(edge_v, np.float32)
        if transform is not None:
            m = np.asarray(transform, np.float32)
            origin = m[:3, :3] @ origin + m[:3, 3]
            edge_u = m[:3, :3] @ edge_u
            edge_v = m[:3, :3] @ edge_v
        self.quads.append((origin, edge_u, edge_v, mat))

    def add_cuboid(self, pmin, pmax, mat: int, transform=None):
        """Decompose an AABB into 6 outward-facing quads, then bake the
        transform. [ref cuboid slab-test equivalent: shape/src/simple.rs:343-411]"""
        lo = np.minimum(np.asarray(pmin, np.float32), np.asarray(pmax, np.float32))
        hi = np.maximum(np.asarray(pmin, np.float32), np.asarray(pmax, np.float32))
        d = hi - lo
        ex = np.array([d[0], 0, 0], np.float32)
        ey = np.array([0, d[1], 0], np.float32)
        ez = np.array([0, 0, d[2]], np.float32)
        faces = [
            (lo, ez, ey),  # x = lo: normal -x (u×v = ez×ey = -x)
            (lo + ex, ey, ez),  # x = hi: normal +x
            (lo, ex, ez),  # y = lo: normal -y
            (lo + ey, ez, ex),  # y = hi: normal +y
            (lo, ey, ex),  # z = lo: normal -z
            (lo + ez, ex, ey),  # z = hi: normal +z
        ]
        for origin, u, v in faces:
            self.add_quad(origin, u, v, mat, transform)

    def add_triangle(
        self, p0, p1, p2, mat: int, normals=None, uvs=None, transform=None
    ):
        p = [np.asarray(x, np.float32) for x in (p0, p1, p2)]
        if transform is not None:
            m = np.asarray(transform, np.float32)
            p = [m[:3, :3] @ x + m[:3, 3] for x in p]
        geo_n = np.cross(p[0] - p[1], p[2] - p[1])
        nrm = np.linalg.norm(geo_n)
        geo_n = geo_n / nrm if nrm > 0 else np.array([0, 0, 1], np.float32)
        if normals is None:
            n = [geo_n] * 3
        else:
            n = [np.asarray(x, np.float32) for x in normals]
            if transform is not None:
                it = np.linalg.inv(np.asarray(transform, np.float64)[:3, :3]).T
                n = [
                    (it @ x / max(np.linalg.norm(it @ x), 1e-20)).astype(np.float32)
                    for x in n
                ]
        if uvs is None:
            uvs = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)]
        uv = [np.asarray(x, np.float32) for x in uvs]
        self.tris.append((*p, *n, *uv, mat))

    def add_mesh(self, positions, indices, mat: int, normals=None, uvs=None,
                 transform=None):
        """Add an indexed triangle soup (brute-force path; BVH meshes go
        through pbrs_jax.accel)."""
        positions = np.asarray(positions, np.float32)
        for (i, j, k) in np.asarray(indices, np.int64):
            tri_n = None
            tri_uv = None
            if normals is not None:
                normals_arr = np.asarray(normals, np.float32)
                tri_n = (normals_arr[i], normals_arr[j], normals_arr[k])
            if uvs is not None:
                uvs_arr = np.asarray(uvs, np.float32)
                tri_uv = (uvs_arr[i], uvs_arr[j], uvs_arr[k])
            self.add_triangle(
                positions[i], positions[j], positions[k], mat,
                normals=tri_n, uvs=tri_uv, transform=transform,
            )

    def add_disk(self, center, normal, radial, mat: int, transform=None):
        center = np.asarray(center, np.float32)
        normal = np.asarray(normal, np.float32)
        radial = np.asarray(radial, np.float32)
        if transform is not None:
            m = np.asarray(transform, np.float64)
            if not _is_similarity(m[:3, :3]):
                log.warning(
                    "add_disk: non-similarity transform — the circular disk "
                    "table cannot hold the resulting ellipse; radius uses "
                    "|M·radial| (see COMPAT.md)"
                )
            center = (m[:3, :3] @ center + m[:3, 3]).astype(np.float32)
            # Normals transform by the inverse-transpose (correct under any
            # affine; equals rotation for similarities). [ADVICE r1 #2;
            # ref: geometry/src/transform.rs:314]
            it = np.linalg.inv(m[:3, :3]).T
            normal = (it @ normal).astype(np.float32)
            radial = (m[:3, :3] @ radial).astype(np.float32)
        normal = normal / max(np.linalg.norm(normal), 1e-20)
        self.disks.append((center, normal, radial, mat))

    # -- build -------------------------------------------------------------
    def build(self) -> GeometryTables:
        far = 3.0e37

        def stack(rows, cols, dummies):
            if rows:
                out = [np.stack([np.asarray(r[i], np.float32) for r in rows])
                       for i in cols]
            else:
                out = [np.asarray(d, np.float32)[None] for d in dummies]
            return out

        sph = stack(
            self.spheres, range(2), [np.array([far] * 3), 0.0]
        )
        sph_mat = (
            np.array([r[2] for r in self.spheres], np.int32)
            if self.spheres else np.zeros(1, np.int32)
        )
        quad = stack(
            self.quads,
            range(3),
            [np.array([far] * 3), np.zeros(3), np.zeros(3)],
        )
        quad_mat = (
            np.array([r[3] for r in self.quads], np.int32)
            if self.quads else np.zeros(1, np.int32)
        )
        tri = stack(
            self.tris,
            range(9),
            [np.array([far] * 3)] * 3
            + [np.array([0, 0, 1.0])] * 3
            + [np.zeros(2)] * 3,
        )
        tri_mat = (
            np.array([r[9] for r in self.tris], np.int32)
            if self.tris else np.zeros(1, np.int32)
        )
        disk = stack(
            self.disks,
            range(3),
            [np.array([far] * 3), np.array([0, 0, 1.0]), np.zeros(3)],
        )
        disk_mat = (
            np.array([r[3] for r in self.disks], np.int32)
            if self.disks else np.zeros(1, np.int32)
        )
        def pack(arrays):
            packed, layout = gth.pack_fields(arrays)
            layout = tuple(
                (off, tuple(shp), np.dtype(dt).name)
                for off, shp, dt in layout
            )
            return jnp.asarray(packed), layout

        sph_packed, sph_layout = pack([sph[0], sph[1], sph_mat])
        quad_packed, quad_layout = pack([quad[0], quad[1], quad[2], quad_mat])
        tri_packed, tri_layout = pack(tri + [tri_mat])
        disk_packed, disk_layout = pack([disk[0], disk[1], disk[2], disk_mat])
        as_j = lambda xs: [jnp.asarray(x) for x in xs]
        sph, quad, tri, disk = as_j(sph), as_j(quad), as_j(tri), as_j(disk)
        return GeometryTables(
            sph_center=sph[0], sph_radius=sph[1], sph_mat=jnp.asarray(sph_mat),
            quad_origin=quad[0], quad_u=quad[1], quad_v=quad[2],
            quad_mat=jnp.asarray(quad_mat),
            tri_p0=tri[0], tri_p1=tri[1], tri_p2=tri[2],
            tri_n0=tri[3], tri_n1=tri[4], tri_n2=tri[5],
            tri_uv0=tri[6], tri_uv1=tri[7], tri_uv2=tri[8],
            tri_mat=jnp.asarray(tri_mat),
            disk_center=disk[0], disk_normal=disk[1], disk_radial=disk[2],
            disk_mat=jnp.asarray(disk_mat),
            sph_packed=sph_packed, quad_packed=quad_packed,
            tri_packed=tri_packed, disk_packed=disk_packed,
            sph_layout=sph_layout, quad_layout=quad_layout,
            tri_layout=tri_layout, disk_layout=disk_layout,
        )
