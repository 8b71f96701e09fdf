"""Perspective pinhole camera.

Pure-function ray generation: pixel ids + jitter -> a RayBatch, replacing the
reference's per-pixel `Camera::shoot_ray` loop
(reference geometry/src/camera.rs:65-77). Left-handed basis: x right,
y up, z forward, film y flipped (reference geometry/src/camera.rs:18-34).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from ..core import struct

from . import ray as ray_mod
from ..core import vecmath as vm


@struct.dataclass
class Camera:
    center: jnp.ndarray  # [3]
    a: jnp.ndarray  # [3]  per-column film step (pre-orientation)
    b: jnp.ndarray  # [3]  per-row film step (pre-orientation, y flipped)
    c: jnp.ndarray  # [3]  top-left film corner direction (pre-orientation)
    orientation: jnp.ndarray  # [3,3] columns = (right, up, forward)
    width: int = struct.field(pytree_node=False, default=800)
    height: int = struct.field(pytree_node=False, default=800)


def make_camera(resolution, fov_y_deg: float) -> Camera:
    """[ref: geometry/src/camera.rs:19-34]"""
    width, height = resolution
    aspect = width / height
    half_v = math.tan(math.radians(fov_y_deg) * 0.5)
    half_h = half_v * aspect
    return Camera(
        center=jnp.zeros(3, jnp.float32),
        a=jnp.array([half_h / (width // 2), 0.0, 0.0], jnp.float32),
        b=jnp.array([0.0, -half_v / (height // 2), 0.0], jnp.float32),
        c=jnp.array([-half_h, half_v, 1.0], jnp.float32),
        orientation=jnp.eye(3, dtype=jnp.float32),
        width=width,
        height=height,
    )


def looking_at(cam: Camera, from_pos, target, up) -> Camera:
    """[ref: geometry/src/camera.rs:46-56]"""
    from_pos = np.asarray(from_pos, np.float32)
    forward = np.asarray(target, np.float32) - from_pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(np.asarray(up, np.float32), forward)
    right = right / np.linalg.norm(right)
    up_adj = np.cross(forward, right)
    orient = np.stack([right, up_adj, forward], axis=1)  # columns
    return cam.replace(
        center=jnp.asarray(from_pos), orientation=jnp.asarray(orient)
    )


def shoot_rays(cam: Camera, row, col, jitter_xy) -> ray_mod.RayBatch:
    """Generate one ray per (row, col, jitter) element.

    dir = R @ (c + a*(col+dx) + b*(row+dy)), unnormalized like the reference
    [ref: geometry/src/camera.rs:65-77]. All downstream geometry treats t as
    the parameter along this unnormalized direction.
    """
    x = col.astype(jnp.float32) + jitter_xy[..., 0]
    y = row.astype(jnp.float32) + jitter_xy[..., 1]
    d_local = (
        cam.c[None, :]
        + cam.a[None, :] * x[..., None]
        + cam.b[None, :] * y[..., None]
    )
    d_world = d_local @ cam.orientation.T
    origin = jnp.broadcast_to(cam.center, d_world.shape)
    return ray_mod.make_rays(origin, d_world)


def pixel_coords(cam: Camera, pixel_idx):
    """Flat pixel index -> (row, col)."""
    row = pixel_idx // cam.width
    col = pixel_idx % cam.width
    return row, col
