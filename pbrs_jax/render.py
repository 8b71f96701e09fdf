"""Render driver: film accumulation, sample batching, checkpoint/resume.

The train-loop equivalent of reference src/main.rs:190-245, re-shaped for
device execution: instead of a rayon fan-out over rows, the whole pixel
grid renders one sample batch per device launch, accumulating into a film
buffer. Film + sample count is the complete renderer state, so
checkpointing is trivial (the reference has none, SURVEY §5).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .accel import dispatch as trace_dispatch
from .core import sampler as smp
from .integrators import direct as direct_mod
from .integrators import wavefront


@dataclass
class RenderStats:
    # Seconds: render launches (compile excluded), jit compilation, and
    # the tuner pilot / schedule measurement before the first launch.
    wall_time: float = 0.0
    compile_time: float = 0.0
    setup_time: float = 0.0
    camera_rays: int = 0
    spp: int = 0
    launches: int = 0
    # Estimated total rays traced (camera + bounce + shadow), filled by the
    # driver from depth / NEE configuration.
    traced_rays: int = 0
    # --debug_checks: {invariant: violation count} (see debug_audit.py).
    audit: dict | None = None
    # Which path rendered: "path/<tuner label>", "path/twoarm[/compact]",
    # or the integrator name.
    config: str = ""
    # memory_summary() of the compiled launch step.
    memory: dict | None = None


def memory_summary(compiled) -> dict:
    """Byte counts from a compiled executable's memory_analysis()."""
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


@dataclass
class Film:
    """Accumulated radiance + sample count; the full checkpointable state."""

    width: int
    height: int
    accum: np.ndarray = field(default=None)
    samples_done: int = 0

    def __post_init__(self):
        if self.accum is None:
            self.accum = np.zeros((self.height * self.width, 3), np.float32)

    def mean_image(self) -> np.ndarray:
        n = max(self.samples_done, 1)
        return (self.accum / n).reshape(self.height, self.width, 3)

    def save(self, path: str) -> None:
        np.savez(path, accum=self.accum, samples_done=self.samples_done,
                 width=self.width, height=self.height)

    @staticmethod
    def load(path: str) -> "Film":
        z = np.load(path)
        return Film(
            width=int(z["width"]), height=int(z["height"]),
            accum=z["accum"], samples_done=int(z["samples_done"]),
        )



def _measured_schedule(scene, sampler, w, h, chunk, samples_per_launch,
                       max_depth, msaa, isect_fn):
    """Pilot-measure per-bounce covered-lane counts at the REAL launch
    lane count (chunk pixels x samples_per_launch) and derive a static
    shrink schedule (wavefront.auto_schedule)."""
    n = w * h
    order = wavefront.morton_pixel_order(w, h)
    pix0 = np.tile(order[:min(n, chunk)], samples_per_launch)
    sid0 = np.repeat(np.arange(samples_per_launch, dtype=np.int32),
                     min(n, chunk))
    counts = np.asarray(jax.jit(lambda: wavefront.measure_alive(
        scene, sampler, jnp.asarray(pix0), jnp.asarray(sid0),
        max_depth=max_depth, msaa=msaa, intersect_fn=isect_fn))())
    return wavefront.auto_schedule(counts, pix0.shape[0])


def render_image(scene, spp: int = 4, max_depth: int = 5, integrator: str = "path",
                 seed: int = 0, chunk_pixels: int | None = None,
                 progress: bool = False, film: Film | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, use_nee: bool = True,
                 pixel_filter: tuple | None = None,
                 profile_dir: str | None = None,
                 sampler_kind: str = "pcg",
                 compact: bool = False,
                 tune: bool = False,
                 debug_checks: bool = False):
    """Render the scene camera view. Returns (image [H,W,3], RenderStats).

    spp is rounded up to a square (msaa² stratification, matching the
    reference's msaa semantics, reference src/main.rs:197-203).

    compact: False runs the masked bounce loop; True shrinks the bounce
    wavefront with a measured per-depth schedule + spatial block re-sort
    (estimator-identical; see wavefront.block_compact).

    tune: race the path integrator's configurations on one pilot launch
    and render with the fastest (pbrs_jax.tuner): two-arm vs folded NEE
    on the masked loop, plus the compacted and re-sorted loops when
    compact is also set. The configuration used is reported in
    RenderStats.config.
    """
    cam = scene.camera
    w, h = cam.width, cam.height
    n = w * h
    msaa = max(1, int(np.ceil(np.sqrt(spp))))
    spp_total = msaa * msaa
    if film is None:
        film = Film(width=w, height=h)
    samplers = {"pcg": smp.PCGSampler, "sobol": smp.SobolSampler,
                "threefry": smp.ThreefrySampler}
    sampler = samplers[sampler_kind](seed)

    # Lanes per launch: frames above the budget split into pixel chunks;
    # smaller frames pack several samples into one launch.
    lane_budget = chunk_pixels or (1 << 20)
    chunk = min(n, lane_budget)
    n_chunks = (n + chunk - 1) // chunk
    pad_n = n_chunks * chunk
    samples_per_launch = max(1, min(spp_total, lane_budget // chunk))
    # Morton (Z-curve) lane order: estimator-neutral, but keeps the pixels
    # of neighbouring lanes in a compact tile (see
    # wavefront.morton_pixel_order). The last chunk pads with repeats.
    order = wavefront.morton_pixel_order(w, h)
    pixel_all = np.concatenate([order, order[:pad_n - n]]) \
        if pad_n > n else order

    if debug_checks and integrator != "path":
        raise ValueError("--debug_checks audits the path integrator only")
    t_setup = time.time()
    if tune and (integrator != "path" or not use_nee or debug_checks
                 or pixel_filter is not None):
        raise ValueError("tune races the path integrator with NEE; it "
                         "takes no pixel filter or debug checks")
    compact_race, compact = (compact, False) if tune else (False, compact)

    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene)
    config = integrator

    filter_inv = None
    if pixel_filter is not None:
        from .core import filters as flt

        kind, radius = pixel_filter
        kinds = {"box": flt.BOX, "triangle": flt.TRIANGLE,
                 "gaussian": flt.GAUSSIAN, "mitchell": flt.MITCHELL,
                 "sinc": flt.LANCZOS, "lanczos": flt.LANCZOS}
        filter_inv = flt.make_filter_cdf(kinds[kind], float(radius))

    if tune:
        from . import tuner as tuner_mod

        pilot_pix = np.tile(pixel_all[:chunk], samples_per_launch)
        pilot_sid = np.repeat(
            np.arange(samples_per_launch, dtype=np.int32), chunk)
        tuned = tuner_mod.tune(
            scene, sampler, jnp.asarray(pilot_pix), jnp.asarray(pilot_sid),
            depth=max_depth, msaa=msaa, compact=compact_race)
        tuned_masked = tuned.masked()
        pilot_n = int(pilot_pix.shape[0])
        config = f"path/{tuned.label}"
        kernel = None  # launches run the tuner's compiled executables
    elif integrator == "path":
        gen_sched = None
        if compact and max_depth > 1:
            gen_sched = _measured_schedule(
                scene, sampler, w, h, chunk, samples_per_launch, max_depth,
                msaa, isect_fn)
        config = "path/twoarm" + ("/compact" if gen_sched else "")

        def kernel(scene_, sampler_, pix, s):
            sched = gen_sched
            if sched is not None and pix.shape[0] != sched[0]:
                sched = None  # odd-sized tail chunk: masked loop
            out = wavefront.render_samples(
                scene_, sampler_, pix, s, max_depth=max_depth, msaa=msaa,
                use_nee=use_nee, intersect_fn=isect_fn,
                occlude_fn=occl_fn, filter_inv_cdf=filter_inv,
                shrink_schedule=sched, audit=debug_checks,
                return_ray_count=True)
            return out if debug_checks else (*out, None)
    elif integrator == "direct":
        def kernel(scene, sampler, pix, s):
            rays = wavefront.camera_rays(scene, sampler, pix, s, msaa)
            return direct_mod.direct_radiance(scene, rays, sampler, pix, s,
                                              depth=max_depth,
                                              intersect_fn=isect_fn,
                                              occlude_fn=occl_fn), None, None
    elif integrator == "normals":
        def kernel(scene, sampler, pix, s):
            rays = wavefront.camera_rays(scene, sampler, pix, s, msaa)
            return direct_mod.normal_visualizer(scene, rays), None, None
    elif integrator == "materials":
        def kernel(scene, sampler, pix, s):
            rays = wavefront.camera_rays(scene, sampler, pix, s, msaa)
            return direct_mod.material_visualizer(scene, rays), None, None
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    setup_time = time.time() - t_setup

    def _step(sc, pix, s_base, batch):
        """-> (radiance summed over the batch [chunk, 3], traced segment
        count or None, audit counters or None)."""
        lanes = jnp.tile(pix, batch) if batch > 1 else pix
        sid = jnp.repeat(
            s_base + jnp.arange(batch), pix.shape[0]
        ).astype(jnp.int32)
        rad, count, aud = kernel(sc, sampler, lanes, sid)
        if batch > 1:
            rad = rad.reshape(batch, pix.shape[0], 3).sum(axis=0)
        return rad, count, aud

    jitted = jax.jit(_step, static_argnames=("batch",))
    stats = RenderStats(spp=spp_total, config=config, setup_time=setup_time)
    compiled = {}

    def tuned_launch(batch):
        """(scene, pix, s) -> _step's outputs through the tuner's compiled
        executable for `batch` samples per launch."""
        t = tuned if chunk * batch == pilot_n else tuned_masked
        lanes0 = jnp.tile(pix_dev[0], batch)
        exe = t.executable(lanes0, jnp.zeros(lanes0.shape, jnp.int32))

        def launch(_sc, pix, s):
            lanes = jnp.tile(pix, batch) if batch > 1 else pix
            sid = jnp.repeat(s + jnp.arange(batch, dtype=jnp.int32),
                             pix.shape[0])
            rad, count = exe(lanes, sid)
            return rad.reshape(batch, -1, 3).sum(axis=0), count, None
        return launch, exe

    def step_for(batch):
        """Ahead-of-time compiled launch for `batch` samples; compile time
        and the device memory analysis go into stats."""
        if batch not in compiled:
            tc = time.time()
            if kernel is None:
                compiled[batch], exe = tuned_launch(batch)
            else:
                compiled[batch] = exe = jitted.lower(
                    scene, pix_dev[0], 0, batch=batch).compile()
            stats.compile_time += time.time() - tc
            if stats.memory is None:
                stats.memory = memory_summary(exe)
        return compiled[batch]

    t0 = time.time()
    s = film.samples_done
    # Per-chunk device-resident film accumulators: radiance stays on-device
    # until checkpoint/finish (host transfers dominate otherwise).
    dev_accum = [None] * n_chunks
    audit_total = None
    count_total = None

    def flush_device_film():
        for c, acc in enumerate(dev_accum):
            if acc is None:
                continue
            nv = min(chunk, n - c * chunk)  # pad lanes (dup ids) dropped
            ids = pixel_all[c * chunk:c * chunk + nv]
            film.accum[ids] += np.asarray(acc)[:nv]
            dev_accum[c] = None

    pix_dev = [
        jnp.asarray(pixel_all[c * chunk:(c + 1) * chunk])
        for c in range(n_chunks)
    ]

    # Failure handling: SIGTERM/SIGINT mid-render flushes completed samples
    # to the checkpoint before exiting, so a preempted job resumes exactly
    # where it stopped (the film is the full renderer state).
    import signal

    prev_term = None
    stop = {"requested": False}

    def _on_term(signum, frame):
        stop["requested"] = True

    if checkpoint_path:
        try:
            prev_term = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            prev_term = None  # not the main thread

    from .profiling import profiler_trace

    import contextlib

    prof_stack = contextlib.ExitStack()
    prof_stack.enter_context(profiler_trace(profile_dir))
    try:
        while s < spp_total:
            batch = min(samples_per_launch, spp_total - s)
            # Stage the batch, then commit atomically: an interrupt mid-batch
            # leaves (accum, samples_done) consistent.
            launch = step_for(batch)
            staged = [launch(scene, pix_dev[c], s) for c in range(n_chunks)]
            for c, (rad, count, aud) in enumerate(staged):
                if debug_checks:
                    audit_total = (aud if audit_total is None
                                   else audit_total + aud)
                if count is not None:
                    count_total = (count if count_total is None
                                   else count_total + count)
                dev_accum[c] = (
                    rad if dev_accum[c] is None else dev_accum[c] + rad
                )
                stats.launches += 1
            s += batch
            film.samples_done = s
            stats.camera_rays += n * batch
            if progress:
                print(f"  sample {s}/{spp_total}", flush=True)
            hit_interval = checkpoint_every and s % checkpoint_every < batch
            if checkpoint_path and (hit_interval or stop["requested"]):
                flush_device_film()
                film.save(checkpoint_path)
            if stop["requested"]:
                raise KeyboardInterrupt  # preemption: film checkpointed
    except KeyboardInterrupt:
        if checkpoint_path:
            flush_device_film()
            film.save(checkpoint_path)
        raise
    finally:
        prof_stack.close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    flush_device_film()
    if debug_checks and audit_total is not None:
        from .integrators import debug_audit as aud_mod

        stats.audit = aud_mod.report(audit_total)
    stats.wall_time = time.time() - t0 - stats.compile_time
    if count_total is not None:
        # Segments the device traced (closest-hit + shadow rays of alive
        # lanes), pad lanes of a partial last chunk included.
        stats.traced_rays = int(float(count_total))
    else:
        # Estimate: per camera ray per bounce, 1 closest-hit + up to 2
        # shadow batches when NEE is on.
        rays_per_sample = max_depth * (
            3 if (use_nee and scene.num_lights) else 1)
        stats.traced_rays = stats.camera_rays * rays_per_sample
    if checkpoint_path:
        film.save(checkpoint_path)
    return film.mean_image(), stats
