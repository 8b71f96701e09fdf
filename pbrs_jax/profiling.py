"""Per-phase device timers and profiler hooks.

The reference reports wall-clock only (reference src/main.rs:217,234-235);
SURVEY §5 prescribes per-phase timers (raygen/trace/shade/NEE) and a
`jax.profiler` option. Phases live inside one fused jit
in production, so profiling runs them as *separate* jitted calls on a
representative batch with block_until_ready fences — the numbers are
per-phase device ms for one launch, not a decomposition of the fused
kernel (which XLA overlaps anyway).
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def profiler_trace(profile_dir: str | None):
    """`jax.profiler.trace` wrapper: no-op when profile_dir is falsy."""
    if not profile_dir:
        yield
        return
    with jax.profiler.trace(profile_dir):
        yield


def _time_ms(fn, *args, iters=3):
    """Median device ms for fn(*args), after one warmup (compile) call."""
    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_phases(scene, n_pixels: int = 1 << 20, max_depth: int = 5,
                   seed: int = 0, iters: int = 3) -> dict:
    """Per-phase device timings (ms per launch of `n_pixels` lanes).

    Phases: raygen (camera kernel), trace (closest-hit), occlude
    (shadow any-hit), bounce1 (full single-bounce radiance = trace + shade
    + NEE), full (max_depth bounces). shade_nee is derived as
    bounce1 - trace - occlude. Also reports Mrays/s for trace/occlude.
    """
    from .accel import dispatch as trace_dispatch
    from .core import sampler as smp
    from .integrators import wavefront

    cam = scene.camera
    n = cam.width * cam.height
    pix = jnp.asarray(np.arange(n_pixels, dtype=np.int32) % n)
    sampler = smp.PCGSampler(seed)
    sid = jnp.zeros((), jnp.int32)
    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene)

    raygen = jax.jit(
        lambda p, s: wavefront.camera_rays(scene, sampler, p, s, 1))
    rays = raygen(pix, sid)
    jax.block_until_ready(rays)

    out = {"lanes": int(n_pixels)}
    out["raygen_ms"] = _time_ms(raygen, pix, sid, iters=iters)
    trace = jax.jit(lambda r: isect_fn(r))
    out["trace_ms"] = _time_ms(trace, rays, iters=iters)
    occl = jax.jit(lambda r: occl_fn(r))
    out["occlude_ms"] = _time_ms(occl, rays, iters=iters)

    def bounce(p, s, depth):
        r = wavefront.camera_rays(scene, sampler, p, s, 1)
        return wavefront.path_radiance(
            scene, r, sampler, p, s, max_depth=depth,
            intersect_fn=isect_fn, occlude_fn=occl_fn)

    b1 = jax.jit(lambda p, s: bounce(p, s, 1))
    out["bounce1_ms"] = _time_ms(b1, pix, sid, iters=iters)
    full = jax.jit(lambda p, s: bounce(p, s, max_depth))
    out["full_ms"] = _time_ms(full, pix, sid, iters=iters)
    out["shade_nee_ms"] = round(
        max(out["bounce1_ms"] - out["trace_ms"] - out["occlude_ms"], 0.0), 3)
    out["trace_mrays_s"] = round(n_pixels / out["trace_ms"] / 1e3, 2)
    out["occlude_mrays_s"] = round(n_pixels / out["occlude_ms"] / 1e3, 2)
    for k in ("raygen_ms", "trace_ms", "occlude_ms", "bounce1_ms", "full_ms"):
        out[k] = round(out[k], 3)
    return out
