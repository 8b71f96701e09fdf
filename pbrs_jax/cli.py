"""Command-line driver, mirroring the reference CLI.

[ref: src/cli_options.rs:25-115, src/main.rs:56-246]

    python -m pbrs_jax.cli --scene_name cornell_box --msaa 2 --integrator path

Flags kept for parity: --scene_name, --pbrt_file, --integrator direct|path,
--msaa N (spp = N²), --visualize_normals, --visualize_materials.
--use_single_thread / --use_multi_thread are accepted and ignored
(determinism comes from the counter-based sampler, not thread count).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbrs_jax", description="wavefront path tracer in JAX"
    )
    p.add_argument("--scene_name", default=None,
                   help="preset scene name [ref: cli_options.rs:52]")
    p.add_argument("--pbrt_file", default=None,
                   help="PBRT scene file [ref: cli_options.rs:54]")
    p.add_argument("--integrator", default="path", choices=["direct", "path"],
                   help="[ref: cli_options.rs:56]")
    p.add_argument("--msaa", type=int, default=2,
                   help="sqrt of samples-per-pixel [ref: cli_options.rs:57]")
    p.add_argument("--depth", type=int, default=5,
                   help="max path depth [ref hard-codes 5: main.rs:205]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler", default="pcg",
                   choices=["pcg", "sobol", "threefry"],
                   help="random sampler: pcg hash (default), "
                        "Owen-scrambled Sobol (lower variance at equal "
                        "spp) or threefry")
    p.add_argument("--resolution", default=None, metavar="WxH",
                   help="override the scene camera resolution")
    p.add_argument("--filter", default=None, metavar="KIND:RADIUS",
                   help="pixel reconstruction filter, e.g. gaussian:1.5 "
                        "(applied by filter importance sampling)")
    p.add_argument("--output", default=None, help="output EXR/PNG path")
    p.add_argument("--checkpoint", default=None,
                   help="film checkpoint path (.npz); resumes if it exists")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save film every N samples")
    p.add_argument("--visualize_normals", action="store_true")
    p.add_argument("--visualize_materials", action="store_true")
    p.add_argument("--use_single_thread", action="store_true")
    p.add_argument("--use_multi_thread", action="store_true")
    p.add_argument("--tune", default="on", choices=["on", "off"],
                   help="race two-arm vs folded NEE on a pilot launch and "
                        "render with the faster (default on)")
    p.add_argument("--compact", default="off", choices=["on", "off"],
                   help="shrink the bounce wavefront with a measured "
                        "per-depth schedule + spatial block re-sort "
                        "(estimator-identical); with --tune on, race the "
                        "compacted and re-sorted loops too (their compile "
                        "time grows with --depth)")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler trace of the render here")
    p.add_argument("--phase_timings", action="store_true",
                   help="print per-phase device timings "
                        "(raygen/trace/occlude/shade) before rendering")
    p.add_argument("--debug_checks", action="store_true",
                   help="audit per-bounce invariants on-device (NaN "
                        "radiance/throughput, non-unit normals/frames, "
                        "hit t out of range, invalid pdfs) and print the "
                        "violation table; exits nonzero on violations. "
                        "Path integrator, masked loop.")
    return p


def load_scene(args):
    if args.pbrt_file:
        from .scene.pbrt import loader as pbrt_loader

        return pbrt_loader.build_scene(args.pbrt_file), (
            args.pbrt_file.rsplit("/", 1)[-1].split(".")[0]
        )
    name = args.scene_name or "cornell_box"
    from .scene import presets

    if name not in presets.PRESETS:
        sys.exit(
            f"unknown scene {name!r}; have {sorted(presets.PRESETS)}"
        )
    return presets.PRESETS[name](), name


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import render as render_mod
    from . import runtime
    from .io import image as io_image

    runtime.enable_compile_cache()
    scene, scene_name = load_scene(args)
    if args.resolution:
        w, h = (int(x) for x in args.resolution.lower().split("x"))
        cam = scene.camera
        from .geometry import camera as cam_lib

        fresh = cam_lib.make_camera((w, h), 40.0)
        scene = scene.replace(
            camera=fresh.replace(
                center=cam.center, orientation=cam.orientation,
                a=cam.a * ((cam.width // 2) / (w // 2)),
                b=cam.b * ((cam.height // 2) / (h // 2)),
                c=cam.c,
            )
        )
    spp = args.msaa * args.msaa

    if args.visualize_normals:
        img, _ = render_mod.render_image(scene, spp=1, integrator="normals")
        io_image.write_png(f"{scene_name}-normals.png", img)
        print(f"wrote {scene_name}-normals.png")
    if args.visualize_materials:
        img, _ = render_mod.render_image(scene, spp=1, integrator="materials")
        io_image.write_png(f"{scene_name}-mtl.png", img)
        print(f"wrote {scene_name}-mtl.png")

    film = None
    if args.checkpoint:
        import os

        if os.path.exists(args.checkpoint):
            film = render_mod.Film.load(args.checkpoint)
            print(f"resuming from {args.checkpoint} at "
                  f"{film.samples_done} samples")

    if args.phase_timings:
        from . import profiling

        phases = profiling.profile_phases(scene, max_depth=args.depth,
                                          seed=args.seed)
        print("per-phase device timings (1 launch):")
        for k, v in phases.items():
            print(f"  {k}: {v}")

    t0 = time.time()
    pixel_filter = None
    if args.filter:
        kind, _, radius = args.filter.partition(":")
        pixel_filter = (kind, float(radius or 1.0))
    img, stats = render_mod.render_image(
        scene, spp=spp, max_depth=args.depth, integrator=args.integrator,
        seed=args.seed, progress=True, film=film,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        pixel_filter=pixel_filter,
        profile_dir=args.profile_dir,
        sampler_kind=args.sampler,
        compact=args.compact == "on",
        tune=(args.tune == "on" and args.integrator == "path"
              and not args.debug_checks and pixel_filter is None),
        debug_checks=args.debug_checks,
    )
    wall = time.time() - t0
    mrays = stats.traced_rays / max(stats.wall_time, 1e-9) / 1e6
    print(f"render config: {stats.config}")
    print(f"setup {stats.setup_time:.2f}s, compile {stats.compile_time:.2f}s,"
          f" render {stats.wall_time:.2f}s; {stats.traced_rays} traced "
          f"segments ({mrays:.1f} M/s over the render)")
    if stats.memory:
        print("launch memory (bytes): " + ", ".join(
            f"{k.replace('_size_in_bytes', '')} {v}"
            for k, v in stats.memory.items()))
    print(f"whole render time = {wall:.2f}s")
    rc = 0
    if args.debug_checks and stats.audit is not None:
        from .integrators import debug_audit as aud_mod

        print(aud_mod.format_report(stats.audit))
        if sum(stats.audit.values()):
            rc = 2  # image still written below for inspection

    out = args.output or f"{scene_name}-{args.integrator}-{spp}spp.exr"
    if out.endswith(".png"):
        io_image.write_png(out, img)
    else:
        io_image.write_exr(out, img)
    print(f"Image written to {out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
