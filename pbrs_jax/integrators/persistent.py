"""Persistent wavefront: dead lanes refill with fresh (pixel, sample) tasks.

This is the static-shape realization of the reference architecture's "stream
compaction" stage (SURVEY §7 "compact"; the reference itself terminates
scalar recursion per ray, src/pathintegrator.rs:65-71). Classic compaction
— shuffling live rays to a shrinking prefix — buys nothing under XLA's
static shapes: the array stays the same size and masked lanes already
cost one select, not one trace. What masked execution *does* waste is
whole-wavefront occupancy: a lane that dies at bounce 2 idles for the
remaining max_depth-2 bounces of its launch.

The persistent form keeps a fixed pool of L lanes and a queue of N
(pixel, sample) tasks. Each while-loop iteration advances every lane one
bounce; lanes whose path terminated (miss / absorb / Russian roulette /
depth) flush their radiance into the output at their task slot via
scatter-add, then claim the next unissued task (prefix-sum slot
assignment) and restart as that task's camera ray — so every trace/shade
launch runs at (near-)full occupancy regardless of path-length variance.
Per-lane bounce counters replace the uniform fori_loop bounce.

The estimator is unchanged: same counter-based RNG streams keyed by
(pixel, sample, bounce, dim), same NEE/MIS/RR rules, so
persistent == masked images per task up to float addition order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import radiometry
from ..bxdf import bsdf as bsdf_mod
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from ..lights import lights as lt
from ..materials import table as mat_mod
from ..shapes import intersect as isect_mod
from . import nee
from .wavefront import camera_rays


def render_tasks_persistent(scene, sampler, pixel_idx, sample_idx,
                            n_lanes=None, max_depth=5, rr_start=3, msaa=2,
                            intersect_fn=None, occlude_fn=None,
                            return_ray_count=False):
    """Integrate N (pixel, sample) tasks on a pool of `n_lanes` lanes.

    Returns radiance [N, 3] per task (same layout as
    wavefront.render_samples). n_lanes defaults to N (full pool — then the
    only difference from the masked loop is refill, which is a no-op);
    pick n_lanes < N to keep occupancy high on deep-depth workloads.
    """
    if intersect_fn is None:
        intersect_fn = lambda r: isect_mod.intersect(scene.geom, r)
    if occlude_fn is None:
        occlude_fn = lambda r: isect_mod.occluded(scene.geom, r)
    n_tasks = pixel_idx.shape[0]
    if n_lanes is None:
        n_lanes = n_tasks
    n_lanes = min(n_lanes, n_tasks)

    def task_ray(task):
        t = jnp.clip(task, 0, n_tasks - 1)
        return camera_rays(scene, sampler, pixel_idx[t], sample_idx[t], msaa)

    # Lane state: task id (-1 = retired), per-lane bounce, ray, beta,
    # radiance accumulator, specular flag.
    task0 = jnp.arange(n_lanes, dtype=jnp.int32)
    rays0 = task_ray(task0)
    state = dict(
        task=task0,
        bounce=jnp.zeros(n_lanes, jnp.int32),
        rays=rays0,
        beta=jnp.ones((n_lanes, 3), jnp.float32),
        rad=jnp.zeros((n_lanes, 3), jnp.float32),
        specular=jnp.zeros(n_lanes, bool),
        out=jnp.zeros((n_tasks, 3), jnp.float32),
        next_task=jnp.int32(n_lanes),
        ray_count=jnp.zeros((), jnp.float32),
        nstep=jnp.int32(0),
    )

    def lane_pix(task):
        t = jnp.clip(task, 0, n_tasks - 1)
        return pixel_idx[t], sample_idx[t]

    # Hard bound: every iteration advances every active lane one bounce and
    # the task queue is finite, so total iterations <= n_tasks * max_depth
    # (reached only if lanes run strictly serially). The cap makes that a
    # hard guarantee — a device while loop that never exits hangs the
    # card.
    step_cap = n_tasks * max_depth + 2

    def cond(s):
        return jnp.any(s["task"] >= 0) & (s["nstep"] < step_cap)

    def body(s):
        task, bounce = s["task"], s["bounce"]
        rays, beta, rad = s["rays"], s["beta"], s["rad"]
        active = task >= 0
        pix, samp = lane_pix(task)
        s["ray_count"] = s["ray_count"] + jnp.sum(active.astype(jnp.float32))

        hit = intersect_fn(rays)
        lobes, emit = mat_mod.shading_at(
            scene.materials, scene.textures, hit.mat_id, hit.uv, hit.pos)
        env = lt.eval_env(scene.env, rays.dir)
        direct_seen = jnp.where(hit.hit[..., None], emit, env)
        count_emission = active & ((bounce == 0) | s["specular"])
        rad = rad + jnp.where(count_emission[..., None], beta * direct_seen,
                              0.0)

        alive = active & hit.hit
        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        wo = hit.wo

        if scene.num_lights > 0:
            u_sel = sampler.u1(pix, samp, bounce, smp.DIM_LIGHT_SELECT)
            u_light = sampler.u2(pix, samp, bounce, smp.DIM_LIGHT_UV)
            u_scatter = sampler.u2(pix, samp, bounce, smp.DIM_SCATTER_UV)
            l_direct = nee.uniform_sample_one_light(
                scene, lobes, frame, hit.pos, hit.normal, wo,
                u_sel, u_light, u_scatter, occlude_fn=occlude_fn,
                alive=alive)
            rad = rad + jnp.where(alive[..., None], beta * l_direct, 0.0)
            s["ray_count"] = s["ray_count"] + 2.0 * jnp.sum(
                alive.astype(jnp.float32))

        u_bsdf = sampler.u2(pix, samp, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, wo, u_bsdf)
        cos_term = jnp.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & (
            (f[..., 0] > 0.0) | (f[..., 1] > 0.0) | (f[..., 2] > 0.0))
        alive = alive & step_ok
        beta = jnp.where(alive[..., None],
                         beta * f * (cos_term * vm.weak_recip(pdf))[..., None],
                         beta)
        new_rays = ray_mod.spawn(hit.pos, hit.normal, wi)

        q = jnp.maximum(0.05, 1.0 - radiometry.luminance(beta))
        u_rr = sampler.u1(pix, samp, bounce, smp.DIM_RUSSIAN_ROULETTE)
        rr_active = bounce > rr_start
        alive = alive & ~(rr_active & (u_rr < q))
        rr_scale = jnp.where(rr_active & alive,
                             1.0 / jnp.maximum(1.0 - q, 1e-6), 1.0)
        beta = beta * rr_scale[..., None]

        bounce = bounce + 1
        alive = alive & (bounce < max_depth)

        # ---- retire finished tasks, claim fresh ones (the "compaction") --
        finished = active & ~alive
        out = s["out"] + jnp.zeros_like(s["out"]).at[
            jnp.clip(task, 0, n_tasks - 1)].add(
            jnp.where(finished[:, None], rad, 0.0))
        # Prefix-sum slot assignment keeps task issue order deterministic.
        slot = jnp.cumsum(finished.astype(jnp.int32)) - 1
        new_task = s["next_task"] + slot
        has_new = finished & (new_task < n_tasks)
        task = jnp.where(alive, task, jnp.where(has_new, new_task, -1))
        next_task = jnp.minimum(
            s["next_task"] + jnp.sum(finished.astype(jnp.int32)), n_tasks)

        fresh = task_ray(task)
        refill = has_new
        rays = new_rays.replace(
            origin=jnp.where(refill[:, None], fresh.origin, new_rays.origin),
            dir=jnp.where(refill[:, None], fresh.dir, new_rays.dir),
            t_max=jnp.where(task >= 0,
                            jnp.where(refill, fresh.t_max, new_rays.t_max),
                            0.0),
        )
        bounce = jnp.where(refill, 0, bounce)
        beta = jnp.where(refill[:, None], 1.0, beta)
        rad = jnp.where(refill[:, None], 0.0, rad)
        specular = jnp.where(refill, False, is_delta)

        return dict(task=task, bounce=bounce, rays=rays, beta=beta, rad=rad,
                    specular=specular, out=out, next_task=next_task,
                    ray_count=s["ray_count"], nstep=s["nstep"] + 1)

    state = jax.lax.while_loop(cond, body, state)
    if return_ray_count:
        return state["out"], state["ray_count"]
    return state["out"]
