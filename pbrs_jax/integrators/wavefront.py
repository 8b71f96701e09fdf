"""Wavefront path integrator.

The reference's recursive-in-spirit bounce loop
(reference src/pathintegrator.rs:9-74) becomes a breadth-first loop over the
whole ray batch: every bounce runs intersect -> emission -> NEE -> BSDF
sample -> Russian roulette on all lanes, with terminated lanes masked. The
bounce loop is a `lax.fori_loop` so the compiled graph is one bounce deep
regardless of max_depth.

Fixes vs reference (COMPAT.md): throughput uses |cos| (pathintegrator.rs:61
uses the signed dot, which corrupts transmission paths).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import radiometry
from ..bxdf import bsdf as bsdf_mod
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import camera as cam_mod
from ..geometry import ray as ray_mod
from ..lights import lights as lt
from ..materials import table as mat_mod
from ..shapes import intersect as isect_mod
from . import nee


def camera_rays(scene, sampler, pixel_idx, sample_idx, msaa,
                filter_inv_cdf=None):
    """Camera ray batch; the per-sample jitter is stratified and, when a
    reconstruction filter is given, warped through its inverse CDF (filter
    importance sampling — the reference parses filters but never applies
    them, src/main.rs:208). Non-negative filters carry weight 1; filters
    with negative lobes (Mitchell/Lanczos) use weighted FIS, and the
    per-sample weight is returned by camera_rays_weighted."""
    rays, _ = camera_rays_weighted(
        scene, sampler, pixel_idx, sample_idx, msaa, filter_inv_cdf
    )
    return rays


def camera_rays_weighted(scene, sampler, pixel_idx, sample_idx, msaa,
                         filter_table=None):
    """Like camera_rays, but returns (rays, weight) — weight is None for a
    box/unweighted filter, else the per-sample signed FIS weight [N]."""
    row, col = cam_mod.pixel_coords(scene.camera, pixel_idx)
    dx, dy = smp.stratified_jitter(sampler, pixel_idx, sample_idx, msaa)
    weight = None
    if filter_table is not None:
        from ..core import filters as flt

        ox, wx = flt.sample_filter_offset(filter_table, dx)
        oy, wy = flt.sample_filter_offset(filter_table, dy)
        dx = 0.5 + ox
        dy = 0.5 + oy
        if wx is not None:
            weight = wx * wy
    rays = cam_mod.shoot_rays(
        scene.camera, row, col, jnp.stack([dx, dy], axis=-1)
    )
    return rays, weight


def morton_pixel_order(width, height):
    """Pixel ids in Morton (Z-curve) order — host-side, O(n).

    Lane order is estimator-neutral (samples are keyed by pixel id), but
    neighbouring lanes then cover a compact ~32x32 tile instead of a
    scanline, so the rays of one warp or block stay coherent — what a
    per-lane BVH traversal wants."""
    w2 = 1 << int(np.ceil(np.log2(max(width, 1))))
    h2 = 1 << int(np.ceil(np.log2(max(height, 1))))
    s = max(w2, h2)
    xs, ys = np.meshgrid(np.arange(s, dtype=np.int64),
                         np.arange(s, dtype=np.int64), indexing="xy")

    def part1by1(v):
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        v = (v | (v << 1)) & 0x5555555555555555
        return v

    code = (part1by1(xs.reshape(-1)) | (part1by1(ys.reshape(-1)) << 1))
    order = np.argsort(code, kind="stable")
    xs, ys = xs.reshape(-1)[order], ys.reshape(-1)[order]
    keep = (xs < width) & (ys < height)
    return (ys[keep] * width + xs[keep]).astype(np.int32)


def _resolve_pending(pending, hit, env, radiance, add, p_env=None):
    """Fold the previous bounce's BSDF-arm MIS contribution using THIS
    bounce's closest hit: env leg pays when the ray escaped, area leg when
    nothing closer than the chosen light was hit (nee.py folded mode).

    p_env (env-IS scenes): the distribution pdf along this bounce's ray
    directions, from the SAME texel gather as `env` (eval_env_pdf). The
    env leg's MIS weight is deferred to here — nee.py stashes the BSDF
    pdf in the env lanes' t_light slot — so the bounce that produced the
    pending never pays a separate pdf_env gather pass."""
    coeff, t_light, is_env = (pending["coeff"], pending["t_light"],
                              pending["is_env"])
    vis_area = hit.t >= t_light * (1.0 - 1e-3)
    pend_valid = is_env | (t_light > 0.0)
    env_term = coeff * env
    if p_env is not None:
        from .nee import _power2_heuristic

        w_e = _power2_heuristic(t_light, p_env)  # t_light = p_b (env lanes)
        env_term = env_term * jnp.where(is_env, w_e, 1.0)[..., None]
    contrib = jnp.where(is_env[..., None], env_term, coeff)
    ok = pend_valid & jnp.where(is_env, ~hit.hit, vis_area)
    return add(radiance, jnp.where(ok[..., None], contrib, 0.0))


def _zero_pending(n):
    return {"coeff": jnp.zeros((n, 3), jnp.float32),
            "t_light": jnp.zeros(n, jnp.float32),
            "is_env": jnp.zeros(n, bool)}


def _make_env_evaluator(scene, folded):
    """(env rgb, distribution pdf|None) evaluator — with folded env-IS the
    escape term and the deferred MIS-weight pdf come from ONE texel
    gather (env_sampling.eval_env_pdf)."""
    if folded and getattr(scene.env, "dist", None) is not None:
        from ..lights import env_sampling as es

        return lambda dirs: es.eval_env_pdf(scene.env, dirs)
    return lambda dirs: (lt.eval_env(scene.env, dirs), None)


def path_radiance(scene, rays, sampler, pixel_idx, sample_idx, max_depth=5,
                  rr_start=3, intersect_fn=None, occlude_fn=None,
                  use_nee=True, return_ray_count=False,
                  shrink_schedule=None, sort_blocks=True,
                  nee_mode="twoarm", resort=False, audit=False):
    """Estimate radiance along camera rays. Returns [N,3].

    Every bounce, all lanes: closest-hit, emission on camera/post-delta
    segments, one-light NEE with MIS, BSDF sampling, Russian roulette after
    `rr_start`. [ref: src/pathintegrator.rs:9-74]

    `shrink_schedule` (optional, tuple of per-bounce static lane
    capacities, schedule[0] == N) switches to the compacting loop: see
    `path_radiance_compacted`.

    audit: thread per-bounce invariant violation counters through the
    loop (see integrators/debug_audit.py); returns an extra [K] f32
    vector. Diagnostic path: audit implies the masked (non-compacted)
    loop. [ref: the reference's runtime assert layer —
    interaction.rs:45-61, blas.rs:300-302, tlas/bvh.rs:62-71]

    nee_mode: "twoarm" traces a dedicated occlusion ray for the
    BSDF-sampled MIS arm (the reference's structure,
    src/directlighting.rs:155-222); "folded" shares the path's own BSDF
    sample with that arm and resolves its visibility from the NEXT
    bounce's closest hit (PBRT's one-sample fold) — one shadow traversal
    per bounce instead of two, same expectation. RR-killed lanes trace
    one extra resolution segment (t_max capped at the pending light) so
    nothing owed is dropped; one epilogue trace resolves the last bounce.
    """
    if intersect_fn is None:
        intersect_fn = lambda r: isect_mod.intersect(scene.geom, r)
    if occlude_fn is None:
        occlude_fn = lambda r: isect_mod.occluded(scene.geom, r)
    if audit:
        # The audit is a diagnostic: run the masked loop so counters map
        # 1:1 onto (lane, bounce) with no permutation/roulette in the way.
        shrink_schedule = None
        resort = False
    if resort and not sort_blocks:
        # resort's only effect is the spatial block sort; with sorting off
        # the compacted loop would never permute — identical results to the
        # masked loop at strictly more per-bounce overhead (ADVICE r4).
        resort = False
    if resort and shrink_schedule is None:
        # Sort-only: full-capacity schedule, compaction becomes a pure
        # spatial permutation at every bounce >= 1. block_compact moves
        # G-lane blocks, so a batch that doesn't tile into blocks takes
        # the masked loop instead (same estimator, no permutation).
        if rays.origin.shape[0] % COMPACT_BLOCK != 0:
            resort = False
        else:
            shrink_schedule = (rays.origin.shape[0],) * max_depth
    if shrink_schedule is not None:
        return path_radiance_compacted(
            scene, rays, sampler, pixel_idx, sample_idx,
            tuple(shrink_schedule), max_depth=max_depth, rr_start=rr_start,
            intersect_fn=intersect_fn, occlude_fn=occlude_fn,
            use_nee=use_nee, return_ray_count=return_ray_count,
            sort_blocks=sort_blocks, nee_mode=nee_mode, resort=resort,
        )

    n = rays.origin.shape[0]
    folded = nee_mode == "folded" and use_nee and scene.num_lights > 0
    eval_env_maybe_pdf = _make_env_evaluator(scene, folded)
    if audit:
        from . import debug_audit as aud_mod

    def body(bounce, state):
        (rays, radiance, beta, alive, specular_bounce, ray_count, pend,
         aud) = state
        alive_in = alive
        in_rays = rays
        # Closest-hit rays this bounce = lanes with a live extent (alive
        # paths + folded-mode resolution-only lanes).
        ray_count = ray_count + jnp.sum((rays.t_max > 0.0).astype(
            jnp.float32))
        hit = intersect_fn(rays)

        # Shading setup: one packed material lookup yields lobes + emission.
        lobes, emit = mat_mod.shading_at(
            scene.materials, scene.textures, hit.mat_id, hit.uv, hit.pos
        )
        # Emitted light at the hit (or escape to the environment) counts only
        # on camera rays and after delta bounces; NEE covers the rest.
        # [ref: pathintegrator.rs:19-22]
        env, p_env = eval_env_maybe_pdf(rays.dir)
        direct_seen = jnp.where(hit.hit[..., None], emit, env)
        if use_nee:
            count_emission = alive & ((bounce == 0) | specular_bounce)
        else:
            # Brute-force mode (validation): emission counted on every
            # segment, no NEE. Converges to the same image as NEE+MIS.
            count_emission = alive
        radiance = radiance + jnp.where(
            count_emission[..., None], beta * direct_seen, 0.0
        )
        if folded:
            radiance = _resolve_pending(pend, hit, env, radiance,
                                        lambda r, c: r + c, p_env=p_env)
            pend = _zero_pending(n)

        alive = alive & hit.hit

        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        wo = hit.wo

        # Sample the BSDF for the next direction. [ref: pathintegrator.rs:38-62]
        u_bsdf = sampler.u2(pixel_idx, sample_idx, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, wo, u_bsdf)

        # Next-event estimation. [ref: pathintegrator.rs:35]
        if use_nee and scene.num_lights > 0:
            u_sel = sampler.u1(pixel_idx, sample_idx, bounce,
                               smp.DIM_LIGHT_SELECT)
            u_light = sampler.u2(pixel_idx, sample_idx, bounce,
                                 smp.DIM_LIGHT_UV)
            u_scatter = sampler.u2(pixel_idx, sample_idx, bounce,
                                   smp.DIM_SCATTER_UV)
            if folded:
                l_direct, new_pend = nee.uniform_sample_one_light(
                    scene, lobes, frame, hit.pos, hit.normal, wo,
                    u_sel, u_light, u_scatter, occlude_fn=occlude_fn,
                    alive=alive, path_sample=(f, wi, pdf, is_delta),
                )
                pend = {
                    "coeff": jnp.where(alive[..., None],
                                       beta * new_pend["coeff"], 0.0),
                    "t_light": jnp.where(alive, new_pend["t_light"], 0.0),
                    "is_env": alive & new_pend["is_env"],
                }
                # One shadow batch per alive lane (light-sampled arm).
                ray_count = ray_count + jnp.sum(alive.astype(jnp.float32))
            else:
                l_direct = nee.uniform_sample_one_light(
                    scene, lobes, frame, hit.pos, hit.normal, wo,
                    u_sel, u_light, u_scatter, occlude_fn=occlude_fn,
                    alive=alive,
                )
                # Two shadow batches per alive lane (light + BSDF arms).
                ray_count = ray_count + 2.0 * jnp.sum(
                    alive.astype(jnp.float32))
            radiance = radiance + jnp.where(
                alive[..., None], beta * l_direct, 0.0
            )

        cos_term = jnp.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & (
            (f[..., 0] > 0.0) | (f[..., 1] > 0.0) | (f[..., 2] > 0.0)
        )
        alive = alive & step_ok
        beta = jnp.where(
            alive[..., None],
            beta * f * (cos_term * vm.weak_recip(pdf))[..., None],
            beta,
        )
        rays = ray_mod.spawn(hit.pos, hit.normal, wi)

        # Russian roulette. [ref: pathintegrator.rs:65-71]
        q = jnp.maximum(0.05, 1.0 - radiometry.luminance(beta))
        u_rr = sampler.u1(pixel_idx, sample_idx, bounce,
                          smp.DIM_RUSSIAN_ROULETTE)
        rr_active = bounce > rr_start
        killed = rr_active & (u_rr < q)
        alive = alive & ~killed
        rr_scale = jnp.where(
            rr_active & alive, 1.0 / jnp.maximum(1.0 - q, 1e-6), 1.0
        )
        beta = beta * rr_scale[..., None]
        # Dead lanes get t_max=0 so traversal-ordered tracers never walk
        # them on later bounces (the flat sweep masks them anyway). In
        # folded mode a dead lane still owing a pending resolution keeps
        # a bounded extent for exactly one more trace.
        if folded:
            pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
            resolve_tmax = jnp.where(
                pend["is_env"], rays.t_max,
                pend["t_light"] * (1.0 + 1e-3))
            rays = rays.replace(t_max=jnp.where(
                alive, rays.t_max,
                jnp.where(pend_valid, resolve_tmax, 0.0)))
        else:
            rays = rays.replace(t_max=jnp.where(alive, rays.t_max, 0.0))

        if audit:
            aud = aud + aud_mod.audit_bounce(
                in_rays, hit, frame, radiance, beta, f, wi, pdf, alive_in,
                lobes=lobes, emit=emit)
        return rays, radiance, beta, alive, is_delta, ray_count, pend, aud

    state = (
        rays,
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n, 3), jnp.float32),
        jnp.ones(n, bool),
        jnp.zeros(n, bool),
        jnp.zeros((), jnp.float32),
        _zero_pending(n),
        (jnp.zeros((len(aud_mod.AUDIT_KEYS),), jnp.float32) if audit
         else jnp.zeros((), jnp.float32)),
    )
    state = jax.lax.fori_loop(0, max_depth, body, state)
    rays, radiance, ray_count, pend, aud = (state[0], state[1], state[5],
                                            state[6], state[7])
    if folded:
        # Epilogue: one closest-hit resolves the final bounce's pending.
        # Extent bounded to exactly what's owed: the chosen light's
        # distance for area pendings, full extent for env pendings,
        # nothing otherwise.
        pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
        e_tmax = jnp.where(pend["is_env"], rays.t_max,
                           pend["t_light"] * (1.0 + 1e-3))
        rays = rays.replace(t_max=jnp.where(pend_valid, e_tmax, 0.0))
        ray_count = ray_count + jnp.sum((rays.t_max > 0.0).astype(
            jnp.float32))
        hit = intersect_fn(rays)
        env, p_env = eval_env_maybe_pdf(rays.dir)
        radiance = _resolve_pending(pend, hit, env, radiance,
                                    lambda r, c: r + c, p_env=p_env)
    if audit:
        if return_ray_count:
            return radiance, ray_count, aud
        return radiance, aud
    if return_ray_count:
        return radiance, ray_count
    return radiance


COMPACT_BLOCK = 8  # lanes move in G-lane blocks; see path_radiance_compacted


def auto_schedule(alive_counts, n, margin=1.5, min_cap=1 << 14,
                  quantum=None):
    """Static per-bounce lane capacities from measured COVERED-lane counts
    (lanes in G-blocks containing at least one alive lane —
    `measure_alive` reports these).

    Capacity = margin x covered, rounded up to `quantum` lanes (default
    max(8192, n/128) — trace rows are 1024 lanes and blocks G lanes, both
    divide it), clamped to [min_cap, n]; a shrink is only scheduled when
    it saves at least 25% of the current size (the compaction gather
    isn't free). With the default margin the block-roulette keep
    probability is 1 in practice, so the estimator matches the masked
    loop exactly (up to XLA reassociation)."""
    if quantum is None:
        quantum = max(256, min(8192, (n // 8) // 256 * 256))
    caps = [n]
    cur = n
    for c in alive_counts[1:]:
        want = max(min_cap, int(margin * float(c)))
        q = -(-want // quantum) * quantum
        cap = min(cur, q)
        if cap > (3 * cur) // 4:
            cap = cur
        caps.append(cap)
        cur = cap
    return tuple(caps)


def measure_alive(scene, sampler, pixel_idx, sample_idx, max_depth=5,
                  msaa=2, intersect_fn=None, occlude_fn=None):
    """Pilot pass: per-bounce COVERED lane counts (lanes in
    COMPACT_BLOCK-sized blocks containing >=1 alive lane) for
    `auto_schedule` (device code identical to the masked loop's survival
    logic)."""
    if intersect_fn is None:
        intersect_fn = lambda r: isect_mod.intersect(scene.geom, r)
    rays = camera_rays(scene, sampler, pixel_idx, sample_idx, msaa)
    n = rays.origin.shape[0]
    G = COMPACT_BLOCK
    alive = jnp.ones(n, bool)
    beta = jnp.ones((n, 3), jnp.float32)
    counts = []
    for bounce in range(max_depth):
        covered = jnp.sum(
            (alive.reshape(-1, G).sum(axis=1) > 0).astype(jnp.float32)
        ) * G
        counts.append(covered)
        hit = intersect_fn(rays)
        alive = alive & hit.hit
        lobes, _ = mat_mod.shading_at(
            scene.materials, scene.textures, hit.mat_id, hit.uv, hit.pos
        )
        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        u_bsdf = sampler.u2(pixel_idx, sample_idx, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, hit.wo,
                                                    u_bsdf)
        cos_term = jnp.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & (
            (f[..., 0] > 0.0) | (f[..., 1] > 0.0) | (f[..., 2] > 0.0)
        )
        alive = alive & step_ok
        beta = jnp.where(
            alive[..., None],
            beta * f * (cos_term * vm.weak_recip(pdf))[..., None], beta)
        q = jnp.maximum(0.05, 1.0 - radiometry.luminance(beta))
        u_rr = sampler.u1(pixel_idx, sample_idx, bounce,
                          smp.DIM_RUSSIAN_ROULETTE)
        killed = (bounce > 3) & (u_rr < q)
        alive = alive & ~killed
        rays = ray_mod.spawn(hit.pos, hit.normal, wi)
        rays = rays.replace(t_max=jnp.where(alive, rays.t_max, 0.0))
    return jnp.stack(counts)


STATE_COLS = 20


def _pack_state(rays, beta, pix, sid, orig, specular, alive, pend=None):
    """State -> one [M,20] f32 matrix so the compaction is a single
    row-gather instead of one gather per column; int columns ride
    bitcast). Columns 15-19 carry the folded-NEE pending
    contribution (coeff 3, t_light, is_env); zero in twoarm mode."""
    as_f = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    n = rays.origin.shape[0]
    if pend is None:
        pend = _zero_pending(n)
    return jnp.concatenate([
        rays.origin, rays.dir, rays.t_max[:, None], beta,
        as_f(pix)[:, None], as_f(sid)[:, None], as_f(orig)[:, None],
        specular.astype(jnp.float32)[:, None],
        alive.astype(jnp.float32)[:, None],
        pend["coeff"], pend["t_light"][:, None],
        pend["is_env"].astype(jnp.float32)[:, None],
    ], axis=1)


def _unpack_state(s):
    as_i = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    rays = ray_mod.RayBatch(origin=s[:, 0:3], dir=s[:, 3:6], t_max=s[:, 6])
    beta = s[:, 7:10]
    pix = as_i(s[:, 10])
    sid = as_i(s[:, 11])
    orig = as_i(s[:, 12])
    specular = s[:, 13] > 0.5
    alive = s[:, 14] > 0.5
    pend = {"coeff": s[:, 15:18], "t_light": s[:, 18],
            "is_env": s[:, 19] > 0.5}
    return rays, beta, pix, sid, orig, specular, alive, pend


def _block_sort_key(rays, G):
    """Spatial key per G-lane block (first lane's origin morton, 6 bits
    per axis over the batch's own bounds, then direction octant)."""
    o = rays.origin[0::G]
    d = rays.dir[0::G]
    lo = jnp.min(o, axis=0)
    hi = jnp.max(o, axis=0)
    inv = 63.0 / jnp.maximum(hi - lo, 1e-30)
    q = jnp.clip(((o - lo) * inv).astype(jnp.int32), 0, 63)

    def part1by2(x):
        x = (x | (x << 8)) & 0x0300F
        x = (x | (x << 4)) & 0x030C3
        x = (x | (x << 2)) & 0x09249
        return x

    morton = (part1by2(q[:, 0]) | (part1by2(q[:, 1]) << 1)
              | (part1by2(q[:, 2]) << 2))
    octant = ((d[:, 0] < 0).astype(jnp.int32)
              | ((d[:, 1] < 0).astype(jnp.int32) << 1)
              | ((d[:, 2] < 0).astype(jnp.int32) << 2))
    return (morton << 3) | octant


def block_compact(rays, beta, pix, sid, orig, specular, alive, cap, u_c,
                  sort_blocks=True, pend=None):
    """Capacity roulette + one packed block row-gather to `cap` lanes.

    Roulette: keep probability p = min(1, 0.95 capB/aliveB) per
    COMPACT_BLOCK block (one uniform from the block's first lane),
    throughput scaled 1/p — estimator-preserving like Russian roulette;
    with schedule margins p == 1 in practice. sort_blocks orders the
    surviving blocks by (origin morton, direction octant) of their first
    lane: the gather costs the same, and compacted rows become spatially
    coherent.

    pend (folded NEE): pending contributions ride the packed rows; a lane
    that is dead but still owes a resolution keeps its block alive and
    its trace extent, and its pending coeff scales by 1/p like beta."""
    G = COMPACT_BLOCK
    cur = rays.origin.shape[0]
    curB, capB = cur // G, cap // G
    pend_valid = (jnp.zeros(cur, bool) if pend is None
                  else pend["is_env"] | (pend["t_light"] > 0.0))
    need = alive | pend_valid
    balive = need.reshape(curB, G).any(axis=1)
    nb = jnp.sum(balive.astype(jnp.int32)).astype(jnp.float32)
    # Exact fit needs no roulette margin: when every needed block has a
    # slot, keep them all (p = 1). The 0.95 margin only matters when the
    # roulette must thin an overflow. This makes cap == cur a PURE
    # permutation — the resort-only pass (sort_blocks without shrinking)
    # is estimator-exact, not just unbiased.
    p = jnp.where(nb <= capB, 1.0,
                  0.95 * capB / jnp.maximum(nb, 1.0))
    keepb = balive & (u_c.reshape(curB, G)[:, 0] < p)
    inv_p = jnp.where(jnp.repeat(keepb, G), 1.0 / p, 1.0)[:, None]
    beta = beta * inv_p
    if pend is not None:
        pend = dict(pend)
        pend["coeff"] = pend["coeff"] * inv_p
    n_keep = jnp.sum(keepb.astype(jnp.int32))
    if sort_blocks:
        skey = _block_sort_key(rays, G)
        skey = jnp.where(keepb, skey, jnp.int32(2**30))
        selb = jnp.argsort(skey)[:capB].astype(jnp.int32)
    else:
        # Stable (original-order) compaction: one cumsum+scatter.
        ka = keepb.astype(jnp.int32)
        dest = jnp.cumsum(ka) - 1
        iota = jnp.arange(curB, dtype=jnp.int32)
        selb = jnp.zeros(capB, jnp.int32).at[
            jnp.where(keepb, dest, capB)
        ].set(iota, mode="drop")
    packed = _pack_state(rays, beta, pix, sid, orig, specular,
                         alive, pend).reshape(curB, G * STATE_COLS)
    sp = jnp.take(packed, selb, axis=0).reshape(capB * G, STATE_COLS)
    (rays, beta, pix, sid, orig, specular, lane_alive,
     pend) = _unpack_state(sp)
    if sort_blocks:
        slot_alive = jnp.repeat(jnp.take(keepb, selb, axis=0), G)
    else:
        slot_alive = jnp.repeat(
            jnp.arange(capB, dtype=jnp.int32) < n_keep, G)
    alive = lane_alive & slot_alive
    lane_pend = pend["is_env"] | (pend["t_light"] > 0.0)
    pend["is_env"] = pend["is_env"] & slot_alive
    pend["t_light"] = jnp.where(slot_alive, pend["t_light"], 0.0)
    keep_extent = alive | (lane_pend & slot_alive)
    rays = rays.replace(t_max=jnp.where(keep_extent, rays.t_max, 0.0))
    return rays, beta, pix, sid, orig, specular, alive, pend


def path_radiance_compacted(scene, rays, sampler, pixel_idx, sample_idx,
                            schedule, max_depth=5, rr_start=3,
                            intersect_fn=None, occlude_fn=None,
                            use_nee=True, return_ray_count=False,
                            sort_blocks=True, nee_mode="twoarm",
                            resort=False):
    """Masked bounce loop with a static shrink schedule.

    The masked wavefront's cost is lane-count-proportional at every stage
    (trace, NEE math, shading gathers) while the alive fraction collapses
    after a bounce or two on open scenes — on mesh_ball the alive fraction
    per bounce runs 0.83, 0.105, 0.079, 0.012, ... — so masked execution
    pays ~full price for ~10% utilization. Here the
    wavefront is compacted to a smaller STATIC capacity per bounce
    (Python-unrolled loop, one XLA program per depth; `schedule` is a
    tuple of pow2 lane counts from `auto_schedule`). Shapes stay static —
    the schedule, not the data, decides sizes, and compaction is one
    packed row-gather.

    Unbiasedness under overflow: if more than `cap` lanes survive, lanes
    are pre-thinned by capacity roulette — keep probability
    p = min(1, 0.95 cap / alive), throughput scaled by 1/p — the same
    estimator-preserving trick as Russian roulette
    [ref: src/pathintegrator.rs:65-71]. With auto_schedule's 4x margin,
    p == 1 in practice and the result is bit-identical to the masked
    fori_loop (tests/test_compaction.py). A >cap overflow AFTER the
    roulette margin would drop lanes (probability < 1e-12 at pow2-sized
    margins; Chernoff).

    RNG parity: every per-lane dimension is keyed by (pixel, sample,
    bounce) exactly as in the masked loop, so compaction never perturbs
    sample streams.
    """
    if intersect_fn is None:
        intersect_fn = lambda r: isect_mod.intersect(scene.geom, r)
    if occlude_fn is None:
        occlude_fn = lambda r: isect_mod.occluded(scene.geom, r)
    n = rays.origin.shape[0]
    assert len(schedule) >= max_depth and schedule[0] >= n
    assert n % COMPACT_BLOCK == 0, (
        f"compacted loop moves lanes in {COMPACT_BLOCK}-lane blocks; "
        f"batch of {n} lanes does not tile — use the masked loop "
        "(shrink_schedule=None) for odd-sized batches")

    folded = nee_mode == "folded" and use_nee and scene.num_lights > 0
    eval_env_maybe_pdf = _make_env_evaluator(scene, folded)
    radiance = jnp.zeros((n, 3), jnp.float32)
    beta = jnp.ones((n, 3), jnp.float32)
    alive = jnp.ones(n, bool)
    specular = jnp.zeros(n, bool)
    pix = pixel_idx
    sid = sample_idx
    orig = jnp.arange(n, dtype=jnp.int32)
    ray_count = jnp.zeros((), jnp.float32)
    pend = _zero_pending(n)

    G = COMPACT_BLOCK
    permuted = False

    def make_bank(orig, cur):
        # Emission and NEE are scatter-added SEPARATELY so each lane's
        # accumulation order matches the masked loop exactly (radiance +
        # emission + nee; float addition is not associative). Until the
        # first shrink the layout is the identity, so plain adds suffice;
        # afterwards contributions land as G-lane block rows (blocks move
        # atomically, so each lane's original block is orig//G of its
        # first lane — block-row scatters cost 1/G of per-lane ones).
        # A resort pass keeps the size at n but still permutes, so the
        # identity shortcut is gated on `permuted`, not just the size.
        if cur == n and not permuted:
            return lambda radiance, contrib: radiance + contrib

        def bank(radiance, contrib):
            m = contrib.shape[0]
            borig = orig.reshape(m // G, G)[:, 0] // G
            return radiance.reshape(n // G, G * 3).at[borig].add(
                contrib.reshape(m // G, G * 3), mode="drop"
            ).reshape(n, 3)
        return bank

    for bounce in range(max_depth):
        cap = min(schedule[bounce], n)
        cap -= cap % G
        cur = rays.origin.shape[0]
        # resort: run the (sorting) compaction even when nothing shrinks
        # — bounce>=1 ray batches are spatially incoherent, and row-cost
        # tracers (ARCHITECTURE §11) want coherent rows far more than
        # they want fewer rows. cap == cur makes it a pure permutation.
        if cap < cur or (resort and sort_blocks and bounce > 0):
            u_c = sampler.u1(pix, sid, bounce, smp.DIM_COMPACT)
            (rays, beta, pix, sid, orig, specular, alive,
             pend) = block_compact(rays, beta, pix, sid, orig, specular,
                                   alive, min(cap, cur), u_c,
                                   sort_blocks=sort_blocks,
                                   pend=pend if folded else None)
            permuted = True

        ray_count = ray_count + jnp.sum((rays.t_max > 0.0).astype(
            jnp.float32))
        hit = intersect_fn(rays)
        lobes, emit = mat_mod.shading_at(
            scene.materials, scene.textures, hit.mat_id, hit.uv, hit.pos
        )
        env, p_env = eval_env_maybe_pdf(rays.dir)
        direct_seen = jnp.where(hit.hit[..., None], emit, env)
        if use_nee:
            count_emission = alive & ((bounce == 0) | specular)
        else:
            count_emission = alive
        bank = make_bank(orig, rays.origin.shape[0])

        radiance = bank(radiance, jnp.where(
            count_emission[..., None], beta * direct_seen, 0.0))
        if folded:
            radiance = _resolve_pending(pend, hit, env, radiance, bank,
                                        p_env=p_env)
            pend = _zero_pending(rays.origin.shape[0])

        alive = alive & hit.hit
        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        wo = hit.wo

        u_bsdf = sampler.u2(pix, sid, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, wo, u_bsdf)

        if use_nee and scene.num_lights > 0:
            u_sel = sampler.u1(pix, sid, bounce, smp.DIM_LIGHT_SELECT)
            u_light = sampler.u2(pix, sid, bounce, smp.DIM_LIGHT_UV)
            u_scatter = sampler.u2(pix, sid, bounce, smp.DIM_SCATTER_UV)
            if folded:
                l_direct, new_pend = nee.uniform_sample_one_light(
                    scene, lobes, frame, hit.pos, hit.normal, wo,
                    u_sel, u_light, u_scatter, occlude_fn=occlude_fn,
                    alive=alive, path_sample=(f, wi, pdf, is_delta),
                )
                pend = {
                    "coeff": jnp.where(alive[..., None],
                                       beta * new_pend["coeff"], 0.0),
                    "t_light": jnp.where(alive, new_pend["t_light"], 0.0),
                    "is_env": alive & new_pend["is_env"],
                }
                ray_count = ray_count + jnp.sum(alive.astype(jnp.float32))
            else:
                l_direct = nee.uniform_sample_one_light(
                    scene, lobes, frame, hit.pos, hit.normal, wo,
                    u_sel, u_light, u_scatter, occlude_fn=occlude_fn,
                    alive=alive,
                )
                ray_count = ray_count + 2.0 * jnp.sum(
                    alive.astype(jnp.float32))
            radiance = bank(radiance, jnp.where(
                alive[..., None], beta * l_direct, 0.0))

        cos_term = jnp.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & (
            (f[..., 0] > 0.0) | (f[..., 1] > 0.0) | (f[..., 2] > 0.0)
        )
        alive = alive & step_ok
        beta = jnp.where(
            alive[..., None],
            beta * f * (cos_term * vm.weak_recip(pdf))[..., None], beta)
        rays = ray_mod.spawn(hit.pos, hit.normal, wi)
        q = jnp.maximum(0.05, 1.0 - radiometry.luminance(beta))
        u_rr = sampler.u1(pix, sid, bounce, smp.DIM_RUSSIAN_ROULETTE)
        rr_active = bounce > rr_start
        killed = rr_active & (u_rr < q)
        alive = alive & ~killed
        rr_scale = jnp.where(
            rr_active & alive, 1.0 / jnp.maximum(1.0 - q, 1e-6), 1.0)
        beta = beta * rr_scale[..., None]
        specular = is_delta
        if folded:
            pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
            resolve_tmax = jnp.where(
                pend["is_env"], rays.t_max,
                pend["t_light"] * (1.0 + 1e-3))
            rays = rays.replace(t_max=jnp.where(
                alive, rays.t_max,
                jnp.where(pend_valid, resolve_tmax, 0.0)))
        else:
            rays = rays.replace(t_max=jnp.where(alive, rays.t_max, 0.0))

    if folded:
        # Epilogue: resolve the final bounce's pending (extent bounded to
        # what's owed).
        pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
        e_tmax = jnp.where(pend["is_env"], rays.t_max,
                           pend["t_light"] * (1.0 + 1e-3))
        rays = rays.replace(t_max=jnp.where(pend_valid, e_tmax, 0.0))
        ray_count = ray_count + jnp.sum((rays.t_max > 0.0).astype(
            jnp.float32))
        hit = intersect_fn(rays)
        env, p_env = eval_env_maybe_pdf(rays.dir)
        bank = make_bank(orig, rays.origin.shape[0])
        radiance = _resolve_pending(pend, hit, env, radiance, bank,
                                    p_env=p_env)

    if return_ray_count:
        return radiance, ray_count
    return radiance


def render_samples(scene, sampler, pixel_idx, sample_idx, max_depth=5, msaa=2,
                   intersect_fn=None, occlude_fn=None, use_nee=True,
                   return_ray_count=False, filter_inv_cdf=None,
                   shrink_schedule=None, sort_blocks=True,
                   nee_mode="twoarm", resort=False, audit=False):
    """Camera rays + path integration for a (pixel, sample) batch."""
    rays, weight = camera_rays_weighted(
        scene, sampler, pixel_idx, sample_idx, msaa, filter_inv_cdf
    )
    out = path_radiance(
        scene, rays, sampler, pixel_idx, sample_idx, max_depth=max_depth,
        intersect_fn=intersect_fn, occlude_fn=occlude_fn, use_nee=use_nee,
        return_ray_count=return_ray_count, shrink_schedule=shrink_schedule,
        sort_blocks=sort_blocks, nee_mode=nee_mode, resort=resort,
        audit=audit,
    )
    if weight is None:
        return out
    if audit:
        if return_ray_count:
            return out[0] * weight[..., None], out[1], out[2]
        return out[0] * weight[..., None], out[1]
    if return_ray_count:
        return out[0] * weight[..., None], out[1]
    return out * weight[..., None]
