#!/usr/bin/env python
"""Benchmark sweep over the BASELINE.md configs, on the GPU.

`bench.py` prints the single headline JSON line; this script measures
every config and prints one JSON line per config, each stamped with the
device as JAX reports it and the card's name and power limit. Fails when
JAX finds no GPU.

    python benchmarks.py                 # every config
    python benchmarks.py mesh interior   # configs whose name matches

Configs [ref: BASELINE.md / BASELINE.json]:
  1. Cornell box, direct lighting, 256², 16 spp
  2. Cornell box, path, 512², 64 spp, 8 bounces
  3. Triangle-mesh scene (mesh_ball), matte + glass, BVH traversal
  4. Multi-primitive scene with area lights, MIS, microfacet (plates), 1024²
  5. Large mixed scene (everything preset: 2400 quads + 1000-sphere cluster)
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pbrs_jax import runtime


def run_config(name, scene, size, spp, depth, integrator="path"):
    from pbrs_jax.accel import dispatch as td
    from pbrs_jax.core import sampler as smp
    from pbrs_jax.geometry import camera as cam_mod
    from pbrs_jax.integrators import direct as direct_mod
    from pbrs_jax.integrators import wavefront

    cam = scene.camera
    scale_w = (cam.width // 2) / (size[0] // 2)
    scale_h = (cam.height // 2) / (size[1] // 2)
    fresh = cam_mod.make_camera(size, 40.0)
    scene = scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * scale_w, b=cam.b * scale_h, c=cam.c,
    ))
    sampler = smp.PCGSampler(0)
    n = size[0] * size[1]
    msaa = max(1, int(round(spp ** 0.5)))

    # ~1M lanes in flight per launch: small frames pack several samples,
    # frames beyond 1M pixels split into chunks (keeps HLO temps bounded).
    chunk_n = min(n, 1 << 20)
    n_chunks = -(-n // chunk_n)
    pad_n = n_chunks * chunk_n
    order = wavefront.morton_pixel_order(size[0], size[1])
    pix_all = jnp.asarray(
        np.concatenate([order, order[:pad_n - n]]) if pad_n > n else order)
    pix_chunks = [pix_all[c * chunk_n:(c + 1) * chunk_n]
                  for c in range(n_chunks)]
    samples_per_launch = max(1, min(msaa * msaa, (1 << 20) // chunk_n))
    lanes_chunks = [jnp.tile(p, samples_per_launch) for p in pix_chunks]
    def sample_ids(base):
        return jnp.repeat(
            base + jnp.arange(samples_per_launch), chunk_n
        ).astype(jnp.int32)

    if integrator == "path":
        from pbrs_jax import tuner

        # Pilot-measured configuration (NEE structure x loop shape) at
        # this config's real launch shapes; PBRS_COMPACT pins the loop
        # shape for profiling.
        tuned = tuner.tune(scene, sampler, lanes_chunks[0], sample_ids(0),
                           depth=depth, msaa=msaa, verbose=True)
        print(f"  tuned: {tuned.label}", file=sys.stderr, flush=True)
        tuned_label = tuned.label

        def step1(lanes, base):
            rad, cnt = tuned(lanes, sample_ids(base))
            return jnp.sum(rad), cnt
        fn1 = jax.jit(step1)

        def fn(base):
            a = 0.0
            c = 0.0
            for lanes in lanes_chunks:
                ai, ci = fn1(lanes, base)
                a = a + ai
                c = c + ci
            return a, c
        acc0, cnt = fn(0)
        acc0.block_until_ready()
        iters = max(1, min(4, (msaa * msaa) // samples_per_launch))
        # Median of 3 timed repetitions (same variance control as bench.py).
        rates, times = [], []
        acc = 0.0
        for rep in range(3):
            t0 = time.time()
            total = 0.0
            for s in range(1, 1 + iters):
                a, cnt = fn((rep * iters + s) * samples_per_launch)
                total += float(cnt)
                if rep == 0:
                    acc += float(a)
                else:
                    float(a)
            dt = time.time() - t0
            rates.append(total / dt / 1e6)
            times.append(dt)
        dt = sorted(times)[1]
        mrays = sorted(rates)[1]
        iters_samples = iters * samples_per_launch
        full_time = dt / iters_samples * (msaa * msaa)
        out = {
            "config": name, "resolution": list(size), "spp": msaa * msaa,
            "depth": depth, "mrays_per_sec": mrays,
            "wall_to_target_spp_sec": full_time,
            "checksum": acc,
            "samples_per_launch": samples_per_launch,
            "tuned": tuned_label,
        }
        if tuned.nee_mode == "folded":
            # Folded NEE completes the same image with ~1/3 fewer traced
            # segments, so its raw Mrays/s is NOT comparable to the
            # twoarm structure (the reference's, and rounds 1-3's
            # numbers). equiv_twoarm_mrays_per_sec = the segment count a
            # twoarm renderer needs for the same launches, divided by the
            # measured folded wall — the apples-to-apples rate.
            def count2(lanes, base):
                _, cnt = wavefront.render_samples(
                    scene, sampler, lanes, sample_ids(base),
                    max_depth=depth, msaa=msaa,
                    intersect_fn=tuned.isect_fn, occlude_fn=tuned.occl_fn,
                    return_ray_count=True)
                return cnt
            f2 = jax.jit(count2)
            cnt_two = sum(float(f2(lanes, samples_per_launch))
                          for lanes in lanes_chunks)
            out["equiv_twoarm_mrays_per_sec"] = cnt_two * iters / dt / 1e6
        return out
    else:
        isect_fn, occl_fn = td.make_trace_fns(scene)

        def step(lanes, base):
            sid = sample_ids(base)
            rad = direct_mod.direct_radiance(
                scene, wavefront.camera_rays(scene, sampler, lanes, sid, msaa),
                sampler, lanes, sid, depth=2,
                intersect_fn=isect_fn, occlude_fn=occl_fn,
            )
            return jnp.sum(rad)
        fn1 = jax.jit(step)

        def fn(base):
            return sum(float(fn1(lanes, base)) for lanes in lanes_chunks)
        fn(0)
        iters = max(1, min(4, (msaa * msaa) // samples_per_launch))
        t0 = time.time()
        acc = 0.0
        for s in range(1, 1 + iters):
            acc += fn(s * samples_per_launch)
        dt = time.time() - t0
        iters_samples = iters * samples_per_launch
        full_time = dt / iters_samples * (msaa * msaa)
        # direct: 2 segments deep, 1 closest + 2 shadow batches each
        mrays = n * iters_samples * 6 / dt / 1e6
    return {
        "config": name,
        "resolution": list(size),
        "spp": msaa * msaa,
        "depth": depth,
        "mrays_per_sec": mrays,
        "wall_to_target_spp_sec": full_time,
        "checksum": acc,
        "samples_per_launch": samples_per_launch,
    }


def main():
    runtime.enable_compile_cache()
    runtime.require_gpu()
    from pbrs_jax.scene import presets

    stamp = {"device": runtime.device_record(),
             "card": runtime.gpu_name_and_power_limit()}
    # Optional config filter: `python benchmarks.py mesh interior` runs
    # only configs whose name contains one of the substrings.
    sel = sys.argv[1:]

    def wanted(name):
        return not sel or any(sub in name for sub in sel)

    results = []

    def run_config(name, *a, **kw):
        if not wanted(name):
            return None
        return globals()["run_config"](name, *a, **kw)

    def emit(r):
        if r is not None:
            r.update(stamp)
            results.append(r)
            print(json.dumps(r), flush=True)

    emit(run_config(
        "cornell_direct_256_16spp", presets.cornell_box(), (256, 256), 16, 2,
        integrator="direct",
    ))
    emit(run_config(
        "cornell_path_512_64spp_8b", presets.cornell_box(), (512, 512), 64, 8,
    ))
    emit(run_config(
        "cornell_path_1024_8b", presets.cornell_box(), (1024, 1024), 4, 8,
    ))
    emit(run_config(
        "mesh_ball_bvh_800x600", presets.mesh_ball(levels=5), (800, 608), 4, 6,
    ))
    emit(run_config(
        "plates_mis_microfacet_1024", presets.plates(), (1024, 1024), 4, 5,
    ))
    emit(run_config(
        "everything_3400prims_800", presets.everything(), (800, 800), 4, 5,
    ))
    emit(run_config(
        "env_mapped_specular_1280x800", presets.env_mapped(), (1280, 800), 4, 5,
    ))
    emit(run_config(
        "mixed_spheres_485_800", presets.mixed_spheres(), (800, 800), 4, 5,
    ))
    emit(run_config(
        "two_perlin_textured_800", presets.two_perlin_spheres(),
        (800, 800), 4, 5,
    ))
    emit(run_config(
        "fourier_plastic_800x600", presets.fourier_plastic(), (800, 608),
        4, 5,
    ))

    # BASELINE configs 4+5: the authored PBRT interior (scenes/interior) —
    # image env light, mixed materials, textures, PLY meshes, trace-time
    # ObjectInstance groups — through the full file->parse->load->render
    # pipeline. Config 5 measures per-sample launches and extrapolates the
    # wall-clock to the 1024-spp target (launches are identical per sample).
    from pbrs_jax.scene.pbrt import loader as pbrt_loader

    interior = pbrt_loader.build_scene("scenes/interior/interior.pbrt")
    emit(run_config(
        "interior_instanced_mis_1024", interior, (1024, 1024), 4, 5,
    ))
    emit(run_config(
        "interior_pbrt_1920x1080_1024spp", interior, (1920, 1080), 1024, 8,
    ))

    print(json.dumps({"benchmarks": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
