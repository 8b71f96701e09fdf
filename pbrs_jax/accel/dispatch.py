"""Trace functions for a scene: the jnp primitive sweep plus any
trace-time instance groups. One path on every backend; XLA compiles it."""

from __future__ import annotations

from ..shapes import intersect as isect_mod
from . import instanced as inst_mod


def make_trace_fns(scene):
    """Returns (intersect_fn, occlude_fn) for the scene geometry,
    including any trace-time instance groups (accel/instanced.py)."""
    geom = scene.geom
    groups = getattr(scene, "instanced", ())
    # Tracer-side flattening: small all-affine-exact groups bake into the
    # base tables (one sweep instead of a per-instance scan); big or
    # non-similarity-sphere groups stay trace-time.
    bake = [g for g in groups if inst_mod.flattenable(g)]
    groups = tuple(g for g in groups if not inst_mod.flattenable(g))
    if bake:
        geom = inst_mod.flatten_groups(geom, bake)

    def base_isect(rays):
        return isect_mod.intersect(geom, rays)

    def base_occl(rays):
        return isect_mod.occluded(geom, rays)

    if not groups:
        return base_isect, base_occl

    def intersect_fn(rays):
        hit = base_isect(rays)
        for grp in groups:
            t, inst, win = inst_mod.intersect_t_group(grp, rays,
                                                      isect_mod.closest_t)
            gh = inst_mod.hit_from_group(grp, rays, t, inst, win)
            hit = inst_mod.merge_hits(hit, gh)
        return hit

    def occlude_fn(rays):
        blocked = base_occl(rays)
        for grp in groups:
            blocked = blocked | inst_mod.occluded_group(grp, rays,
                                                        isect_mod.occluded)
        return blocked

    return intersect_fn, occlude_fn
