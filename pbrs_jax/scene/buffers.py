"""Scene buffers: the full device-resident scene as one pytree.

Replaces the reference `Scene` aggregate (reference scene/src/lib.rs:19-33);
`SceneBuilder` plays the role of `SceneLoader`/`from_loader`
(scene/src/lib.rs:46-63) including the distant-light world-radius patch.
"""

from __future__ import annotations

import numpy as np
from ..core import struct

from ..geometry.camera import Camera
from ..materials.table import MaterialTable, MaterialBuilder
from ..textures.textures import TextureTable, TextureBuilder
from ..shapes.tables import GeometryTables, GeometryBuilder
from ..lights.lights import (
    DeltaLights, AreaLights, EnvLight, LightsBuilder, make_env_none,
)


@struct.dataclass
class Scene:
    geom: GeometryTables
    materials: MaterialTable
    textures: TextureTable
    delta_lights: DeltaLights
    area_lights: AreaLights
    env: EnvLight
    camera: Camera
    # Trace-time instance groups (accel/instanced.py): master geometry
    # stored once + per-instance transforms, the batched equivalent of the
    # reference's Instance transform-at-intersect (tlas/src/instance.rs:50-67).
    instanced: tuple = ()

    @property
    def num_lights(self) -> int:
        """Uniform-light-pick denominator.
        [ref: src/directlighting.rs:61-62]"""
        return (
            self.delta_lights.count
            + self.area_lights.count
            + (1 if self.env.kind != 0 else 0)
        )


class SceneBuilder:
    """Aggregates the host-side builders and finalizes a Scene."""

    def __init__(self):
        self.geometry = GeometryBuilder()
        self.materials = MaterialBuilder()
        self.textures = TextureBuilder()
        self.lights = LightsBuilder()
        self.camera: Camera | None = None
        # (GeometryBuilder master, [4x4 object->world transforms])
        self.instanced: list[tuple[GeometryBuilder, list]] = []

    def add_instance_group(self, master: GeometryBuilder, transforms):
        """Register a trace-time instance group: `master` holds object-space
        geometry stored once; `transforms` are 4x4 object->world matrices,
        one per instance (any affine — exact at trace time)."""
        self.instanced.append((master, [np.asarray(t, np.float64)
                                        for t in transforms]))

    @staticmethod
    def _builder_bound(geometry: GeometryBuilder):
        """Conservative AABB of one GeometryBuilder's primitives."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)

        def grow(points):
            nonlocal lo, hi
            pts = np.atleast_2d(np.asarray(points, np.float64))
            lo = np.minimum(lo, pts.min(axis=0))
            hi = np.maximum(hi, pts.max(axis=0))

        for c, r, _ in geometry.spheres:
            grow([np.asarray(c) - r, np.asarray(c) + r])
        for o, u, v, _ in geometry.quads:
            grow([o, o + u, o + v, o + u + v])
        for t in geometry.tris:
            grow([t[0], t[1], t[2]])
        for c, n, r, _ in geometry.disks:
            rad = np.linalg.norm(r)
            grow([np.asarray(c) - rad, np.asarray(c) + rad])
        return lo, hi

    def world_bound(self):
        """Conservative scene AABB from the accumulated primitives,
        including transformed instance-group bounds."""
        lo, hi = self._builder_bound(self.geometry)
        for master, tfs in self.instanced:
            mlo, mhi = self._builder_bound(master)
            if not np.all(np.isfinite(mlo)):
                continue
            corners = np.stack(
                [np.array([[mlo, mhi][ix][0], [mlo, mhi][iy][1],
                           [mlo, mhi][iz][2]])
                 for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)])
            for t in tfs:
                wc = corners @ np.asarray(t)[:3, :3].T + np.asarray(t)[:3, 3]
                lo = np.minimum(lo, wc.min(axis=0))
                hi = np.maximum(hi, wc.max(axis=0))
        if not np.all(np.isfinite(lo)):
            lo, hi = -np.ones(3), np.ones(3)
        return lo, hi

    def build(self) -> Scene:
        lo, hi = self.world_bound()
        # Patch distant-light world radius from the scene bound.
        # [ref: scene/src/lib.rs:55-59]
        self.lights.world_radius = float(np.linalg.norm(hi - lo) * 0.5 + 1e-3)
        delta, area, env = self.lights.build()
        groups = []
        for master, tfs in self.instanced:
            from ..accel import instanced as inst_mod

            groups.append(inst_mod.make_group(
                master.build(), np.stack(tfs),
                self._builder_bound(master)))
        return Scene(
            geom=self.geometry.build(),
            materials=self.materials.build(),
            textures=self.textures.build(),
            delta_lights=delta,
            area_lights=area,
            env=env,
            camera=self.camera,
            instanced=tuple(groups),
        )
