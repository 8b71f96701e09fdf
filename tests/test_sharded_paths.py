"""Fast paths under shard_map (8-device CPU mesh).

The compacting loop's film banking (`wavefront.bank()` block scatters)
and the tiled primitive sweep's scan are exactly the kind of code that
silently breaks under sharding. Both tests pin sharded execution against
the already-verified single-device semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from pbrs_jax import parallel
from pbrs_jax.core import sampler as smp
from pbrs_jax.geometry import ray as ray_mod
from pbrs_jax.integrators import wavefront
from pbrs_jax.scene import presets
from pbrs_jax.shapes import intersect as isect_mod
from pbrs_jax.shapes.tables import GeometryBuilder

N_DEV = 8


def _small_scene(w=64, h=48):
    from pbrs_jax.geometry import camera as cam_mod

    scene = presets.mesh_ball(levels=2)
    cam = scene.camera
    fresh = cam_mod.make_camera((w, h), 35.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation, c=cam.c,
        a=cam.a * (cam.width // 2) / (w // 2),
        b=cam.b * (cam.height // 2) / (h // 2),
    ))


def test_sharded_compacted_matches_sharded_masked():
    """path_radiance_compacted under shard_map == the masked loop under
    the same sharding. Each dp shard runs its own shrink schedule; the
    banking scatters must stay shard-local."""
    scene = _small_scene()
    sampler = smp.PCGSampler(7)
    n = 64 * 48
    depth = 5
    mesh = parallel.make_mesh(n_dp=N_DEV, n_sp=1)
    pix = jnp.arange(n, dtype=jnp.int32)
    n_shard = n // N_DEV

    # Worst-shard alive counts -> one static schedule valid (p == 1) on
    # every shard, so sharded-compacted must equal sharded-masked.
    counts = []
    for d in range(N_DEV):
        p = pix[d * n_shard:(d + 1) * n_shard]
        counts.append(np.asarray(jax.jit(lambda p=p: wavefront.measure_alive(
            scene, sampler, p, jnp.zeros(n_shard, jnp.int32),
            max_depth=depth, msaa=2))()))
    sched = wavefront.auto_schedule(
        np.max(np.stack(counts), axis=0), n_shard, min_cap=64)
    assert sched[0] == n_shard
    assert any(c < n_shard for c in sched[1:]), (sched,)

    def shard_fn(p, schedule):
        return wavefront.render_samples(
            scene, sampler, p, jnp.zeros(p.shape[0], jnp.int32),
            max_depth=depth, msaa=2, shrink_schedule=schedule)

    def run(schedule):
        fn = jax.shard_map(
            lambda p: shard_fn(p, schedule), mesh=mesh,
            in_specs=P(("dp", "sp")), out_specs=P(("dp", "sp")),
            check_vma=False)
        return np.asarray(jax.jit(fn)(pix))

    masked = run(None)
    compacted = run(sched)
    assert np.isfinite(compacted).all()
    np.testing.assert_allclose(masked, compacted, atol=1e-5, rtol=1e-4)


def test_sharded_sweep_matches_single_device():
    """The tiled primitive sweep under shard_map == the single-device
    sweep: per-shard tiles must not depend on the global lane layout."""
    rng = np.random.default_rng(0)
    n_tri = 700  # > SWEEP_TILE: the scanned, padded form
    p0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
    g = GeometryBuilder()
    for a, b, c in zip(p0, p1, p2):
        g.add_triangle(a, b, c, mat=0)
    geom = g.build()

    n_rays = 2048
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = ray_mod.make_rays(jnp.asarray(o), jnp.asarray(d))

    t_ref, i_ref = isect_mod.closest_t(geom, rays)
    occ_ref = isect_mod.occluded(geom, rays)

    mesh = parallel.make_mesh(n_dp=N_DEV, n_sp=1)
    fn = jax.shard_map(
        lambda r: (*isect_mod.closest_t(geom, r), isect_mod.occluded(geom, r)),
        mesh=mesh, in_specs=P(("dp", "sp")), out_specs=P(("dp", "sp")),
        check_vma=False)
    t_sh, i_sh, occ_sh = jax.jit(fn)(rays)

    assert np.isfinite(np.asarray(t_ref)).any()
    np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_sh))
    np.testing.assert_array_equal(np.asarray(t_ref), np.asarray(t_sh))
    np.testing.assert_array_equal(np.asarray(occ_ref), np.asarray(occ_sh))
