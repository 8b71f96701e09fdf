#!/usr/bin/env python
"""End-to-end check of the renderer on the GPU.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --cards 4    # phase 6 only: sharded interior

Phases (one card):
  1. device: JAX's default device must be a GPU;
  2. the PBRT interior at 1920x1080, depth 8, 4 spp, through the CLI;
  3. the Cornell headline, 1024x1024, 8 bounces, 4 spp, through
     render_image;
  4. mesh_ball at the benchmark's launch shape (800x608, 4 spp, depth 6);
  5. reference comparison: 64x64 center crops of five scenes rendered on
     the GPU and on the CPU backend (the plain reference: the same code
     and RNG streams), and every golden-checksum family on the GPU.
With --cards 4: the interior at 1920x1080, 4 spp, sharded over dp4 x sp1
and dp2 x sp2 meshes of four GPUs, each compared with the same render on
one card.

Any failing phase ends the run with a non-zero exit and no result line.
The last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

from pbrs_jax import checks, runtime

ROOT = os.path.dirname(os.path.abspath(__file__))
INTERIOR = os.path.join(ROOT, "scenes", "interior", "interior.pbrt")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# Per-image relative L1 limit between a sharded render and the one-card
# render of the same samples.
SHARDED_RTOL = 1e-5


def check_device(devices=None):
    """Phase 1: the GPU devices, or NoAcceleratorError."""
    devices = runtime.require_gpu(devices)
    rec = runtime.device_record(devices)
    print(f"device: platform={rec['platform']} kind={rec['kind']} "
          f"count={rec['count']}", flush=True)
    return devices


def peak_bytes(device):
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", 0))


def print_render(label, stats, device):
    mrays = stats.traced_rays / max(stats.wall_time, 1e-9) / 1e6
    print(f"[{label}] config={stats.config} setup_s={stats.setup_time:.3f} "
          f"compile_s={stats.compile_time:.3f} "
          f"render_s={stats.wall_time:.3f} "
          f"traced_segments={stats.traced_rays} "
          f"segments_per_s={mrays:.3f}M", flush=True)
    print(f"[{label}] memory_analysis={json.dumps(stats.memory)}",
          flush=True)
    print(f"[{label}] process peak_bytes_in_use={peak_bytes(device)}",
          flush=True)


def check_image(label, img, shape):
    img = np.asarray(img)
    if img.shape != shape or not np.isfinite(img).all() or img.sum() <= 0:
        raise AssertionError(f"{label}: image {img.shape} (want {shape}), "
                             f"finite={np.isfinite(img).all()}, "
                             f"sum={float(np.nansum(img))}")


def interior_cli_phase(device, width=1920, height=1080, depth=8):
    """Phase 2: the interior through the CLI entry point."""
    from pbrs_jax import cli
    from pbrs_jax.io import image as io_image

    out = os.path.join(OUT_DIR, f"interior_{width}x{height}_4spp.exr")
    t0 = time.time()
    rc = cli.main(["--pbrt_file", INTERIOR, "--resolution",
                   f"{width}x{height}", "--depth", str(depth), "--msaa", "2",
                   "--output", out])
    if rc != 0:
        raise AssertionError(f"interior CLI exit code {rc}")
    print(f"[interior] cli wall_s={time.time() - t0:.3f} "
          f"process peak_bytes_in_use={peak_bytes(device)}", flush=True)
    check_image("interior", io_image.read_exr(out), (height, width, 3))


def cornell_phase(device, size=1024):
    """Phase 3: the Cornell headline through render_image."""
    from pbrs_jax import render
    from pbrs_jax.geometry import camera as cam_mod
    from pbrs_jax.scene import presets

    cam = cam_mod.looking_at(cam_mod.make_camera((size, size), 40.0),
                             (278, 278, -800), (278, 278, 0), (0, 1, 0))
    scene = presets.cornell_box().replace(camera=cam)
    img, stats = render.render_image(scene, spp=4, max_depth=8, tune=True)
    print_render(f"cornell_{size}_8b", stats, device)
    check_image("cornell", img, (size, size, 3))


def mesh_ball_phase(device, width=800, height=608):
    """Phase 4: mesh_ball (16,384 triangles) at the benchmark shape."""
    from pbrs_jax import render
    from pbrs_jax.scene import presets

    scene = checks.shrunk(presets.mesh_ball(levels=5), width, height)
    img, stats = render.render_image(scene, spp=4, max_depth=6, tune=True)
    print_render(f"mesh_ball_{width}x{height}", stats, device)
    check_image("mesh_ball", img, (height, width, 3))


def reference_scenes():
    from pbrs_jax.scene import presets

    return {
        "cornell": presets.cornell_box,
        "plates": presets.plates,
        "env_mapped": presets.env_mapped,
        "mesh_ball_l2": lambda: presets.mesh_ball(levels=2),
        "fourier_plastic": presets.fourier_plastic,
    }


def reference_phase(device, cpu, crop=64):
    """Phase 5: device crops vs CPU crops, then the golden families on
    the device. Returns the failures."""
    failed = []
    for name, build in reference_scenes().items():
        scene = build()
        img = checks.render_crop(scene, device, size=crop)
        ref = checks.render_crop(scene, cpu, size=crop)
        rep = checks.compare_images(img, ref)
        print(f"[reference] {name}: max_abs={rep['max_abs']:.3e} "
              f"pixels_off={rep['pixels_off']:.5f} "
              f"sum_rel={rep['sum_rel']:.3e} ok={rep['ok']}", flush=True)
        if not rep["ok"]:
            failed.append(name)
    golden = checks.load_golden()
    for name, (build, depth) in checks.golden_families().items():
        got = checks.golden_checksum(build(), depth)
        ok = checks.golden_ok(got, golden[name])
        print(f"[golden] {name}: {got!r} pinned {golden[name]!r} "
              f"rel={abs(got - golden[name]) / abs(golden[name]):.2e} "
              f"ok={ok}", flush=True)
        if not ok:
            failed.append(f"golden:{name}")
    return failed


def sharded_phase(scene, devices, spp=4, meshes=((4, 1), (2, 2)),
                  max_depth=8):
    """Phase 6: render_image_sharded on each (dp, sp) mesh of `devices`
    vs the same render on devices[0] alone. Returns per-mesh reports."""
    from pbrs_jax import parallel

    def timed(mesh):
        t0 = time.time()
        img = parallel.render_image_sharded(scene, spp, mesh,
                                            max_depth=max_depth)
        first = time.time() - t0
        t0 = time.time()
        img = parallel.render_image_sharded(scene, spp, mesh,
                                            max_depth=max_depth)
        return img, first, time.time() - t0

    one = parallel.make_mesh(1, 1, devices=devices[:1])
    ref, ref_first, ref_wall = timed(one)
    print(f"[sharded] 1 card: wall_s={ref_wall:.3f} "
          f"(first call with compile {ref_first:.3f})", flush=True)
    reports = []
    for n_dp, n_sp in meshes:
        mesh = parallel.make_mesh(n_dp, n_sp, devices=devices)
        img, first, wall = timed(mesh)
        l1 = float(np.abs(img - ref).sum() / max(np.abs(ref).sum(), 1e-30))
        rep = {"mesh": f"dp{n_dp}xsp{n_sp}", "rel_l1": l1,
               "max_abs": float(np.abs(img - ref).max()),
               "wall_s": wall, "first_call_s": first,
               "one_card_wall_s": ref_wall,
               "ok": bool(np.isfinite(img).all()) and l1 <= SHARDED_RTOL}
        reports.append(rep)
        print(f"[sharded] {json.dumps(rep)}", flush=True)
    for d in devices:
        stats = d.memory_stats() or {}
        print(f"[sharded] {d}: peak_bytes_in_use="
              f"{stats.get('peak_bytes_in_use')}", flush=True)
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded four-card phase")
    args = ap.parse_args(argv)

    # The CPU backend is the reference in phase 5; keep it available when
    # the platform list was narrowed to the GPU.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    runtime.enable_compile_cache()
    devices = check_device()
    print(f"nvidia-smi: {runtime.gpu_name_and_power_limit()}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.cards == 4:
        from pbrs_jax.scene.pbrt import loader as pbrt_loader

        if len(devices) < 4:
            raise AssertionError(f"--cards 4 needs 4 GPUs, found "
                                 f"{len(devices)}")
        devices = devices[:4]
        scene = checks.shrunk(pbrt_loader.build_scene(INTERIOR), 1920, 1080)
        reports = sharded_phase(scene, devices)
        if not all(r["ok"] for r in reports):
            raise AssertionError(f"sharded renders differ: {reports}")
    else:
        device = devices[0]
        cpu = jax.devices("cpu")[0]
        for phase in (interior_cli_phase, cornell_phase, mesh_ball_phase):
            t0 = time.time()
            phase(device)
            print(f"[{phase.__name__}] done in {time.time() - t0:.3f}s",
                  flush=True)
        t0 = time.time()
        failed = reference_phase(device, cpu)
        print(f"[reference_phase] done in {time.time() - t0:.3f}s",
              flush=True)
        if failed:
            raise AssertionError(f"reference comparison failed: {failed}")

    print(json.dumps({"ok": True, "device": runtime.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
