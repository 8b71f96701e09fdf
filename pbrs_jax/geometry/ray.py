"""SoA ray batches.

Replaces the reference's scalar `Ray {origin, dir, t_max}`
(reference geometry/src/ray.rs:17-21) with a batch-of-arrays pytree. All
integrator stages operate on whole batches; a "dead" lane is simply masked.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

# t below this is rejected as a self-intersection; t >= t_max is out of
# extent. [ref: geometry/src/ray.rs:40-46 — t < f32::EPSILON || t >= t_max]
T_MIN = 1.19209290e-07
# Offset along the normal when spawning secondary rays.
# [ref: geometry/src/interaction.rs:63-66]
SPAWN_EPS = 1e-3


@struct.dataclass
class RayBatch:
    origin: jnp.ndarray  # [N, 3]
    dir: jnp.ndarray  # [N, 3]
    t_max: jnp.ndarray  # [N]

    @property
    def n(self):
        return self.origin.shape[0]


def make_rays(origin, dir, t_max=None):
    origin = jnp.asarray(origin, jnp.float32)
    dir = jnp.asarray(dir, jnp.float32)
    if t_max is None:
        t_max = jnp.full(origin.shape[:-1], jnp.inf, jnp.float32)
    return RayBatch(origin=origin, dir=dir, t_max=jnp.asarray(t_max, jnp.float32))


def position_at(rays: RayBatch, t):
    """origin + t * dir. [ref: geometry/src/ray.rs:48-50]"""
    return rays.origin + t[..., None] * rays.dir


def valid_t(rays: RayBatch, t):
    """Mask of t within the ray extent [T_MIN, t_max)."""
    return (t >= T_MIN) & (t < rays.t_max)


def spawn(pos, normal, dir):
    """Secondary ray offset SPAWN_EPS along the side of `normal` that `dir`
    points to. [ref: geometry/src/interaction.rs:63-66]"""
    side = jnp.sign(jnp.sum(dir * normal, axis=-1, keepdims=True))
    side = jnp.where(side == 0.0, 1.0, side)
    return make_rays(pos + side * normal * SPAWN_EPS, dir)


def spawn_limited_to(pos, normal, target):
    """Shadow ray from pos to target with t_max = 1 - 1e-3 (dir unnormalized
    so t=1 is the target). [ref: geometry/src/interaction.rs:68-70]"""
    d = target - pos
    r = spawn(pos, normal, d)
    return r.replace(t_max=jnp.full(r.t_max.shape, 1.0 - 1e-3, jnp.float32))
