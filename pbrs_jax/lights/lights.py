"""Light tables: delta lights, diffuse area lights, environment light.

[ref: light/src/lib.rs, scene/src/lib.rs:12-17,105-117]
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import gather as gth
from ..core import vecmath as vm
from . import sample_shape as ss

# Delta light kinds
POINT = 0
DISTANT = 1

# Env light kinds (static ints; jit specializes per scene)
ENV_NONE = 0
ENV_CONST = 1
ENV_GRADIENT = 2  # lerp(bottom, top, (y+1)/2): the blue_sky family
ENV_DUSK = 3
ENV_IMAGE = 4


@struct.dataclass
class DeltaLights:
    kind: jnp.ndarray  # [D] int32
    position: jnp.ndarray  # [D,3] point position / distant casting_dir
    color: jnp.ndarray  # [D,3] intensity / radiance
    world_radius: jnp.ndarray  # [] scalar (distant light visibility range)
    packed: jnp.ndarray = None  # [D,C]
    count: int = struct.field(pytree_node=False, default=0)
    layout: tuple = struct.field(pytree_node=False, default=())


@struct.dataclass
class AreaLights:
    shape_kind: jnp.ndarray  # [A] int32 (sample_shape kinds)
    emit: jnp.ndarray  # [A,3]
    p0: jnp.ndarray  # [A,3]
    p1: jnp.ndarray  # [A,3]
    p2: jnp.ndarray  # [A,3]
    scalar: jnp.ndarray  # [A]
    packed: jnp.ndarray = None  # [A,C]
    count: int = struct.field(pytree_node=False, default=0)
    layout: tuple = struct.field(pytree_node=False, default=())
    present_shapes: tuple = struct.field(
        pytree_node=False, default=(0, 1, 2, 3)
    )


@struct.dataclass
class EnvLight:
    kind: int = struct.field(pytree_node=False, default=ENV_NONE)
    color_a: jnp.ndarray = None  # top / constant
    color_b: jnp.ndarray = None  # bottom / horizon
    image: jnp.ndarray = None  # [H,W,3] equirect
    scale: jnp.ndarray = None  # [3]
    # Importance-sampling distribution (env_sampling.EnvDistribution) for
    # image environments; None = BSDF-sampled only (reference behavior,
    # src/directlighting.rs:93-99).
    dist: object = None


def _pack(arrays):
    packed, layout = gth.pack_fields(arrays)
    layout = tuple(
        (off, tuple(shp), np.dtype(dt).name) for off, shp, dt in layout
    )
    return jnp.asarray(packed), layout


def _make_delta(kind, position, color, world_radius, count) -> DeltaLights:
    packed, layout = _pack([kind, position, color])
    return DeltaLights(
        kind=jnp.asarray(kind), position=jnp.asarray(position),
        color=jnp.asarray(color), world_radius=jnp.asarray(world_radius),
        packed=packed, count=count, layout=layout,
    )


def _make_area(shape_kind, emit, p0, p1, p2, scalar, count) -> AreaLights:
    packed, layout = _pack([shape_kind, emit, p0, p1, p2, scalar])
    present = tuple(sorted({int(k) for k in np.asarray(shape_kind)[:count]}))
    return AreaLights(
        shape_kind=jnp.asarray(shape_kind), emit=jnp.asarray(emit),
        p0=jnp.asarray(p0), p1=jnp.asarray(p1), p2=jnp.asarray(p2),
        scalar=jnp.asarray(scalar), packed=packed, count=count, layout=layout,
        present_shapes=present or (ss.QUAD,),
    )


def empty_delta() -> DeltaLights:
    return _make_delta(
        np.zeros(1, np.int32), np.zeros((1, 3), np.float32),
        np.zeros((1, 3), np.float32), 1.0, 0,
    )


def empty_area() -> AreaLights:
    return _make_area(
        np.zeros(1, np.int32), np.zeros((1, 3), np.float32),
        np.zeros((1, 3), np.float32), np.asarray([[1.0, 0, 0]], np.float32),
        np.asarray([[0, 1.0, 0]], np.float32), np.ones(1, np.float32), 0,
    )


def make_env_gradient(top, bottom) -> EnvLight:
    return EnvLight(
        kind=ENV_GRADIENT,
        color_a=jnp.asarray(top, jnp.float32),
        color_b=jnp.asarray(bottom, jnp.float32),
        image=jnp.zeros((1, 1, 3), jnp.float32),
        scale=jnp.ones(3, jnp.float32),
    )


def make_env_const(color) -> EnvLight:
    return EnvLight(
        kind=ENV_CONST,
        color_a=jnp.asarray(color, jnp.float32),
        color_b=jnp.zeros(3, jnp.float32),
        image=jnp.zeros((1, 1, 3), jnp.float32),
        scale=jnp.ones(3, jnp.float32),
    )


def make_env_none() -> EnvLight:
    return EnvLight(
        kind=ENV_NONE,
        color_a=jnp.zeros(3, jnp.float32),
        color_b=jnp.zeros(3, jnp.float32),
        image=jnp.zeros((1, 1, 3), jnp.float32),
        scale=jnp.ones(3, jnp.float32),
    )


def make_env_dusk() -> EnvLight:
    """[ref: scene/src/preset.rs:39-51]"""
    horizon = jnp.asarray([245, 174, 82], jnp.float32) / 255.0
    dome = jnp.asarray([109, 150, 204], jnp.float32) / 255.0
    return EnvLight(
        kind=ENV_DUSK, color_a=dome, color_b=horizon,
        image=jnp.zeros((1, 1, 3), jnp.float32), scale=jnp.ones(3, jnp.float32),
    )


def make_env_image(image_hw3, scale=(1.0, 1.0, 1.0),
                   importance: bool = True) -> EnvLight:
    dist = None
    if importance:
        from . import env_sampling as es

        dist = es.build_distribution(image_hw3, scale)
    return EnvLight(
        kind=ENV_IMAGE,
        color_a=jnp.zeros(3, jnp.float32),
        color_b=jnp.zeros(3, jnp.float32),
        image=jnp.asarray(image_hw3, jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
        dist=dist,
    )


def eval_env(env: EnvLight, directions):
    """Environment radiance along ray directions [N,3] -> [N,3].
    [ref: scene/src/lib.rs:105-117, scene/src/preset.rs:25-51]"""
    if env.kind == ENV_NONE:
        return jnp.zeros_like(directions)
    if env.kind == ENV_CONST:
        return jnp.broadcast_to(env.color_a, directions.shape)
    d = vm.normalize(directions)
    if env.kind == ENV_GRADIENT:
        y = (d[..., 1:2] + 1.0) * 0.5
        return env.color_a * y + env.color_b * (1.0 - y)
    if env.kind == ENV_DUSK:
        tilt = jnp.arccos(jnp.clip(d[..., 1:2], -1.0, 1.0))
        t = tilt / (jnp.pi * 0.25)
        mid = env.color_a * t + env.color_b * (1.0 - t)
        out = jnp.where(tilt > jnp.pi * 0.25, env.color_a, mid)
        return jnp.where(tilt <= 0.0, jnp.full_like(out, 0.2), out)
    # ENV_IMAGE: equirect lookup. [ref: scene/src/lib.rs:105-114]
    h, w = env.image.shape[0], env.image.shape[1]
    phi = jnp.arctan2(d[..., 2], d[..., 0])  # azimuth
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))  # from +y
    u = (phi / (2.0 * jnp.pi) + 0.5) % 1.0
    v = theta / jnp.pi
    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return env.image[yi, xi] * env.scale


def area_rows(lights: AreaLights, idx):
    """One packed lookup -> (shape_kind, emit, params-dict) for chosen
    area-light indices."""
    rows = gth.lookup_rows(lights.packed, idx, max(lights.count, 1))
    kind, emit, p0, p1, p2, scalar = gth.unpack_fields(rows, lights.layout)
    return kind, emit, {"p0": p0, "p1": p1, "p2": p2, "scalar": scalar}


def sample_delta(lights: DeltaLights, idx, hit_pos):
    """Incident radiance from a chosen delta light.
    Returns (radiance [N,3], wi unit [N,3], vis_target [N,3]).
    The visibility segment is hit_pos -> vis_target.
    [ref: light/src/lib.rs:66-92]"""
    rows = gth.lookup_rows(lights.packed, idx, max(lights.count, 1))
    kind, p, c = gth.unpack_fields(rows, lights.layout)
    # Point light.
    to_l = p - hit_pos
    d2 = jnp.maximum(vm.dot(to_l, to_l), 1e-30)
    rad_point = c / d2[..., None]
    wi_point = vm.normalize(to_l)
    # Distant light: p holds the casting direction (light -> scene).
    wi_dist = vm.normalize(-p)
    outside = hit_pos - 2.0 * lights.world_radius * p
    k3 = kind[..., None]
    radiance = jnp.where(k3 == POINT, rad_point, c)
    wi = jnp.where(k3 == POINT, wi_point, wi_dist)
    vis_target = jnp.where(k3 == POINT, p, outside)
    return radiance, wi, vis_target


def sample_area(lights: AreaLights, idx, hit_pos, u2):
    """Sample incident radiance from a chosen area light.
    Returns (radiance [N,3], wi unit [N,3], pdf [N], point_on_light [N,3]).
    [ref: light/src/lib.rs:154-172]"""
    kind, emit, params = area_rows(lights, idx)
    pt, n_l = ss.sample_towards(kind, params, hit_pos, u2,
                                present=lights.present_shapes)
    wi = vm.normalize(pt - hit_pos)
    # One-sided emission: radiance only if the light front side faces us.
    # [ref: light/src/lib.rs:127-133]
    facing = vm.dot(n_l, -wi) > 0.0
    radiance = jnp.where(facing[..., None], emit, 0.0)
    pdf = ss.pdf_at(kind, params, hit_pos, wi,
                    present=lights.present_shapes)
    return radiance, wi, pdf, pt


def area_radiance_to(lights: AreaLights, idx, hit_pos, wi):
    """BSDF-sampled MIS arm: does direction wi hit the chosen light, and at
    what pdf? Returns (radiance [N,3], pdf [N], hit_mask [N], point [N,3]).
    [ref: light/src/lib.rs:141-152]"""
    kind, emit, params = area_rows(lights, idx)
    wi_n = vm.normalize(wi)
    ok, t, n_l = ss.intersect_shape(kind, params, hit_pos, wi_n,
                                    present=lights.present_shapes)
    pdf = ss.pdf_at(kind, params, hit_pos, wi_n,
                    present=lights.present_shapes)
    pt = hit_pos + t[..., None] * wi_n
    radiance = jnp.where(ok[..., None], emit, 0.0)
    return radiance, pdf, ok, pt


class LightsBuilder:
    """Host-side accumulator for scene lights."""

    def __init__(self):
        self.delta = []  # (kind, position/dir, color)
        self.area = []  # (shape_kind, emit, p0, p1, p2, scalar)
        self.env = make_env_none()
        self.world_radius = 1.0

    def add_point(self, position, intensity):
        self.delta.append((POINT, np.asarray(position, np.float32),
                           np.asarray(intensity, np.float32)))

    def add_distant(self, casting_dir, radiance):
        self.delta.append((DISTANT, np.asarray(casting_dir, np.float32),
                           np.asarray(radiance, np.float32)))

    def add_area_quad(self, emit, origin, edge_u, edge_v):
        self.area.append((ss.QUAD, emit, origin, edge_u, edge_v, 0.0))

    def add_area_sphere(self, emit, center, radius):
        self.area.append((ss.SPHERE, emit, center, (0, 0, 1), (0, 0, 0),
                          float(radius)))

    def add_area_disk(self, emit, center, normal, radial):
        self.area.append((ss.DISK, emit, center, normal, radial, 0.0))

    def add_area_triangle(self, emit, p0, p1, p2):
        self.area.append((ss.TRIANGLE, emit, p0, p1, p2, 0.0))

    def build(self):
        if self.delta:
            delta = _make_delta(
                np.asarray([d[0] for d in self.delta], np.int32),
                np.stack([np.asarray(d[1], np.float32) for d in self.delta]),
                np.stack([np.asarray(d[2], np.float32) for d in self.delta]),
                self.world_radius, len(self.delta),
            )
        else:
            delta = empty_delta()
        if self.area:
            f3 = lambda i: np.stack(
                [np.asarray(a[i], np.float32).reshape(3) for a in self.area]
            )
            area = _make_area(
                np.asarray([a[0] for a in self.area], np.int32),
                f3(1), f3(2), f3(3), f3(4),
                np.asarray([float(a[5]) for a in self.area], np.float32),
                len(self.area),
            )
        else:
            area = empty_area()
        return delta, area, self.env
