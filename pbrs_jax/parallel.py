"""Multi-chip execution: shard the pixel-sample grid over a device mesh.

Path tracing is embarrassingly parallel per pixel-sample, so the sharding
story is: pixels sharded over a 'dp' mesh axis, sample batches sharded over
an 'sp' axis, film combined with a psum over 'sp' (the only collective —
this replaces the reference's rayon row fan-out, reference src/main.rs:219-224).
The scene pytree is replicated; scenes are small relative to HBM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .accel import dispatch as trace_dispatch
from .core import sampler as smp
from .integrators import wavefront


def make_mesh(n_dp: int | None = None, n_sp: int = 1, devices=None) -> Mesh:
    """Mesh with pixel-parallel 'dp' and sample-parallel 'sp' axes."""
    devices = devices if devices is not None else jax.devices()
    if n_dp is None:
        n_dp = len(devices) // n_sp
    dev = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(dev, axis_names=("dp", "sp"))


def render_batch_sharded(scene, sampler, pixel_idx, sample_base: int,
                         samples_per_call: int, mesh: Mesh, max_depth=5,
                         msaa=2, use_nee=True, trace_fns=None):
    """Render `samples_per_call` samples for every pixel in `pixel_idx`,
    sharded over the mesh. Each 'sp' slice takes a disjoint sample-index
    stripe; the per-pixel sums are psum'd over 'sp'.

    Returns per-pixel radiance summed over the samples, [N, 3] (sharded
    over 'dp', replicated over 'sp').
    """
    n_sp = mesh.shape["sp"]
    assert samples_per_call % n_sp == 0, "samples must divide the sp axis"
    per_shard = samples_per_call // n_sp
    isect_fn, occl_fn = trace_fns or (None, None)

    def shard_fn(pix):
        sp_idx = jax.lax.axis_index("sp")
        acc = jnp.zeros(pix.shape + (3,), jnp.float32)

        def render_one(s):
            return wavefront.render_samples(
                scene, sampler, pix, s, max_depth=max_depth, msaa=msaa,
                use_nee=use_nee, intersect_fn=isect_fn, occlude_fn=occl_fn,
            )

        # One program per shard regardless of per_shard: the sample index
        # is a traced operand (counter-based RNG), so the per-shard sample
        # loop is a fori_loop, not a Python unroll of the whole program.
        acc = jax.lax.fori_loop(
            0, per_shard,
            lambda i, a: a + render_one(sample_base
                                        + sp_idx * per_shard + i),
            acc,
        )
        return jax.lax.psum(acc, axis_name="sp")

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("dp"),
        out_specs=P("dp"),
        check_vma=False,
    )
    return fn(pixel_idx)


def render_image_sharded(scene, spp: int, mesh: Mesh, max_depth=5, seed=0,
                         use_nee=True):
    """Full-frame sharded render -> [H, W, 3] float32 (host numpy)."""
    cam = scene.camera
    n = cam.width * cam.height
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    pad = (-n) % n_dp
    pixel_idx = jnp.arange(n + pad, dtype=jnp.int32)
    sampler = smp.PCGSampler(seed)
    msaa = max(1, int(round(spp ** 0.5)))
    samples_per_call = max(n_sp, msaa * msaa // max(1, (msaa * msaa) // n_sp))

    total = np.zeros((n + pad, 3), np.float32)
    done = 0
    spp_total = msaa * msaa
    fns = {}
    # Scene-aware trace fns (trace-time instance groups): built once on
    # the host; the default scene.geom fallback inside
    # wavefront.render_samples would silently drop instanced geometry.
    trace_fns = trace_dispatch.make_trace_fns(scene)

    def fn_for(batch):
        if batch not in fns:
            fns[batch] = jax.jit(
                lambda sc, pix, base: render_batch_sharded(
                    sc, sampler, pix, base, batch, mesh,
                    max_depth=max_depth, msaa=msaa, use_nee=use_nee,
                    trace_fns=trace_fns,
                )
            )
        return fns[batch]

    while done < spp_total:
        batch = min(samples_per_call, spp_total - done)
        batch = max(n_sp, batch - batch % n_sp)
        total += np.asarray(fn_for(batch)(scene, pixel_idx, done))
        done += batch
    img = total[:n] / float(done)
    return img.reshape(cam.height, cam.width, 3)
