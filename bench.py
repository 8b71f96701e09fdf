#!/usr/bin/env python
"""Headline benchmark: Cornell-box path trace, 1024x1024, 8 bounces.

Prints ONE JSON line: {"metric", "value", "unit", "device", "card"}, the
device as JAX reports it and the card's name and power limit from
nvidia-smi. Rays counted are actual traced segments: alive closest-hit
rays + alive shadow rays, summed on-device. Fails when JAX finds no GPU.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from pbrs_jax import runtime


def main():
    runtime.enable_compile_cache()
    runtime.require_gpu()
    from pbrs_jax.accel import dispatch as trace_dispatch
    from pbrs_jax.core import sampler as smp
    from pbrs_jax.geometry import camera as cam_mod
    from pbrs_jax.integrators import wavefront
    from pbrs_jax.scene import presets

    size = 1024
    depth = 8
    chunk = 1 << 20  # pixels per launch (= full frame at 1024²)
    warmup_samples = 1
    bench_samples = 4

    scene = presets.cornell_box()
    cam = cam_mod.looking_at(
        cam_mod.make_camera((size, size), 40.0),
        (278, 278, -800), (278, 278, 0), (0, 1, 0),
    )
    scene = scene.replace(camera=cam)
    sampler = smp.PCGSampler(0)

    n = size * size
    pix = jnp.arange(min(n, chunk), dtype=jnp.int32)

    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene)

    @jax.jit
    def step(s):
        rad, count = wavefront.render_samples(
            scene, sampler, pix, s, max_depth=depth, msaa=2,
            return_ray_count=True, intersect_fn=isect_fn,
            occlude_fn=occl_fn,
        )
        return jnp.sum(rad), count

    # Warmup / compile.
    for s in range(warmup_samples):
        r, c = step(s)
        r.block_until_ready()

    # Median of 3 timed repetitions: the headline must not wobble with
    # host load or clock variance.
    reps = 3
    rates = []
    total_rays = 0.0
    checksum = 0.0
    elapsed = 0.0
    for rep in range(reps):
        t0 = time.time()
        rep_rays = 0.0
        base = warmup_samples + rep * bench_samples
        for s in range(base, base + bench_samples):
            r, c = step(s)
            if rep == 0:
                checksum += float(r)
            else:
                float(r)
            rep_rays += float(c)
        dt = time.time() - t0
        rates.append(rep_rays / dt / 1e6)
        total_rays += rep_rays
        elapsed += dt

    mrays = sorted(rates)[reps // 2]
    result = {
        "metric": "cornell_box_1024_path8_throughput",
        "value": mrays,
        "unit": "Mrays/s/chip",
        "device": runtime.device_record(),
        "card": runtime.gpu_name_and_power_limit(),
    }
    print(f"# {total_rays / 1e6:.0f}M rays in {elapsed:.2f}s; "
          f"checksum {checksum:.3e}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
