"""Pilot-measured render configuration selection.

Static eligibility rules once shipped a 2.6x slowdown on the interior
(eligible != faster), so configurations are picked by MEASUREMENT: build
each candidate, time one real launch at the render's own shapes, keep the
winner. Every candidate runs the general wavefront
(integrators/wavefront.py) over the same trace functions; they differ in

* NEE structure: "twoarm" (a dedicated occlusion ray for the
  BSDF-sampled MIS arm) or "folded" (the continuation ray resolves that
  arm; tests/test_folded_nee.py), and
* loop shape: masked, compacted to a measured per-bounce shrink schedule
  (wavefront.auto_schedule), or re-sorted into spatially coherent blocks
  every bounce.

The pilot costs a few compiles; for any render long enough to care about
throughput it amortizes to noise. Winners are cached on disk per scene
fingerprint, launch shape and device kind. `compact=True` (or the
PBRS_COMPACT=1 env var, kept for profiling) adds the compacted and
re-sorted loops to the race.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import runtime
from .accel import dispatch as trace_dispatch
from .integrators import wavefront

# Bump when candidate semantics change: stale cached winners must not
# outlive the configurations they were measured against.
TUNER_CACHE_VERSION = 2
_CACHE_DIR_ENV = "PBRS_TUNER_CACHE"


def _scene_fingerprint(scene):
    """Cheap, stable identity for tuning decisions: family/material/light
    shapes + world-extent content sample. Two scenes with the same
    fingerprint have (to the pilot's resolution) the same cost
    structure."""
    g = scene.geom

    def cnt(a):
        return int(np.asarray(a).shape[0])

    parts = [cnt(g.tri_p0), cnt(g.quad_origin), cnt(g.sph_center),
             cnt(g.disk_center), int(scene.num_lights)]
    mk = np.asarray(scene.materials.kind)
    parts.append(list(mk.shape))
    parts.append([int(x) for x in mk.reshape(-1)])
    env = getattr(scene, "env", None)
    parts.append(getattr(env, "kind", None) if env is not None else None)
    for grp in getattr(scene, "instanced", ()):
        gg = grp.geom
        parts.append(("grp", cnt(gg.tri_p0), cnt(gg.quad_origin),
                      cnt(gg.sph_center), cnt(gg.disk_center),
                      int(np.asarray(grp.fwd).shape[0])))
    # Content sample: geometry extents (rounded) catch same-shape scenes
    # with different layouts without hashing full buffers.
    for a in (g.tri_p0, g.quad_origin, g.sph_center, g.disk_center):
        arr = np.asarray(a)
        if arr.size:
            parts.append([round(float(x), 3)
                          for x in (arr.min(0).tolist()
                                    + arr.max(0).tolist())])
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _cache_root():
    return (os.environ.get(_CACHE_DIR_ENV)
            or os.path.join(runtime.checkout_dir(), ".pbrs_tuner"))


def _cache_path(key):
    return os.path.join(_cache_root(), f"{key}.json")


def _cache_key(scene, n_lanes, depth, msaa, compact):
    dev = jax.devices()[0].device_kind
    blob = json.dumps([TUNER_CACHE_VERSION, _scene_fingerprint(scene),
                       int(n_lanes), int(depth), int(msaa), str(compact),
                       dev]).encode()
    return hashlib.sha1(blob).hexdigest()[:24]


def _cache_load(key):
    try:
        with open(_cache_path(key)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _cache_store(key, rec):
    try:
        os.makedirs(_cache_root(), exist_ok=True)
        tmp = _cache_path(key) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, _cache_path(key))
    except OSError:
        pass  # caching is best-effort; never fail a render over it


class TunedRender:
    """One render configuration of the general wavefront, callable as
    (lanes, sample_ids) -> (radiance [N,3], traced_segment_count)."""

    def __init__(self, scene, sampler, depth, msaa, schedule, isect_fn,
                 occl_fn, label, nee_mode="twoarm", resort=False):
        self.scene = scene
        self.sampler = sampler
        self.depth = depth
        self.msaa = msaa
        self.schedule = schedule
        self.isect_fn = isect_fn
        self.occl_fn = occl_fn
        self.label = label
        self.nee_mode = nee_mode
        self.resort = resort
        self._compiled = {}

    def executable(self, lanes, sample_ids):
        """This configuration compiled ahead of time for the lane count of
        `lanes` (cached): the tuner times it, and render_image launches
        the winner's executable without compiling it again."""
        n = int(lanes.shape[0])
        if n not in self._compiled:
            self._compiled[n] = jax.jit(self.__call__).lower(
                lanes, sample_ids).compile()
        return self._compiled[n]

    def masked(self):
        """Twin configuration without the shrink schedule — for odd-sized
        tail batches whose lane count doesn't match the schedule."""
        if self.schedule is None and not self.resort:
            return self
        return TunedRender(
            self.scene, self.sampler, self.depth, self.msaa, None,
            self.isect_fn, self.occl_fn, self.label + "/masked-tail",
            self.nee_mode)

    def __call__(self, lanes, sample_ids):
        return wavefront.render_samples(
            self.scene, self.sampler, lanes, sample_ids,
            max_depth=self.depth, msaa=self.msaa,
            intersect_fn=self.isect_fn, occlude_fn=self.occl_fn,
            return_ray_count=True, shrink_schedule=self.schedule,
            nee_mode=self.nee_mode, resort=self.resort)


def _measure(cand, lanes, sample_ids, reps=2):
    """Compile + time `reps` launches; returns median seconds/launch.
    Raises if the candidate's radiance is non-finite — a fast wrong
    candidate must never win the tuning race."""
    fn = cand.executable(lanes, sample_ids)
    out = fn(lanes, sample_ids)
    jax.block_until_ready(out)
    if not bool(jnp.isfinite(out[0]).all()):
        raise FloatingPointError("non-finite radiance from candidate")
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(lanes, sample_ids))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _auto_sched(scene, sampler, lanes, sample_ids, depth, msaa, isect_fn,
                folded=False):
    counts = np.asarray(jax.jit(
        lambda: wavefront.measure_alive(
            scene, sampler, lanes, sample_ids, max_depth=depth, msaa=msaa,
            intersect_fn=isect_fn))())
    if folded:
        # Folded NEE: a lane that dies at bounce b-1 still owes its
        # pending MIS-arm resolution at bounce b, and its block must keep
        # capacity (block_compact keeps need = alive | pend_valid). Pend
        # lanes at b were alive during b-1's shade, so lagging the covered
        # counts by one bounce is an exact bound — the roulette keep
        # probability stays 1 and the folded compacted estimator matches
        # the folded masked one (tests/test_folded_nee.py).
        counts = np.maximum(counts, np.concatenate([counts[:1],
                                                    counts[:-1]]))
    n = int(lanes.shape[0])
    sched = wavefront.auto_schedule(counts, n)
    if all(c >= n for c in sched):
        return None  # nothing ever shrinks; the masked loop is the same
    return sched


def candidates(scene, sampler, lanes, sample_ids, depth, msaa, compact,
               isect_fn, occl_fn):
    """The configurations the race times: NEE structure (two-arm, and
    folded when the scene has lights) x loop shape. compact=False races
    the masked loop only; compact=True adds the loop compacted to the
    pilot's shrink schedule (when it shrinks) and the re-sorted loop
    (when the batch tiles into compaction blocks). Those two unroll the
    bounce loop, so their compile time grows with depth (PERF.md)."""
    n = int(lanes.shape[0])
    nee_modes = ["twoarm"] + (["folded"] if scene.num_lights > 0 else [])
    out = []
    for nmode in nee_modes:
        out.append(TunedRender(scene, sampler, depth, msaa, None, isect_fn,
                               occl_fn, nmode, nee_mode=nmode))
        if not compact or depth <= 1:
            continue
        sched = _auto_sched(scene, sampler, lanes, sample_ids, depth, msaa,
                            isect_fn, folded=nmode == "folded")
        if sched is not None:
            out.append(TunedRender(scene, sampler, depth, msaa, sched,
                                   isect_fn, occl_fn, f"{nmode}/compact",
                                   nee_mode=nmode))
        if n % wavefront.COMPACT_BLOCK == 0:
            out.append(TunedRender(
                scene, sampler, depth, msaa,
                sched if sched is not None else (n,) * depth,
                isect_fn, occl_fn,
                f"{nmode}{'/compact' if sched else ''}/resort",
                nee_mode=nmode, resort=True))
    return out


def tune(scene, sampler, lanes, sample_ids, depth=5, msaa=2,
         compact=False, verbose=False):
    """Measure candidate configurations on (lanes, sample_ids)-shaped
    batches and return the fastest TunedRender.

    compact: False races the NEE structures on the masked loop; True also
    races the compacted and re-sorted loops (see candidates()).
    """
    env_compact = os.environ.get("PBRS_COMPACT")
    if env_compact is not None:
        compact = env_compact == "1"

    def log(msg):
        if verbose:
            print(f"  [tune] {msg}", file=sys.stderr, flush=True)

    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene)

    def rebuild(rec):
        """TunedRender from a cached winner record (no measurement)."""
        sched = rec["schedule"]
        return TunedRender(
            scene, sampler, depth, msaa,
            tuple(sched) if sched is not None else None,
            isect_fn, occl_fn, rec["label"], nee_mode=rec["nee_mode"],
            resort=bool(rec["resort"]))

    cache_key = None
    # Per-candidate measurements are checkpointed as they land, so a pilot
    # killed mid-run resumes instead of restarting.
    partial = {}
    if os.environ.get("PBRS_TUNER_NOCACHE") != "1":
        cache_key = _cache_key(scene, lanes.shape[0], depth, msaa, compact)
        rec = _cache_load(cache_key)
        if rec is not None and "partial" in rec:
            partial = dict(rec["partial"])
            log(f"resuming pilot: {len(partial)} cached measurements")
        elif rec is not None:
            cand = rebuild(rec)
            log(f"cache hit ({cache_key}): {cand.label}")
            return cand

    cands = candidates(scene, sampler, lanes, sample_ids, depth, msaa,
                       compact, isect_fn, occl_fn)
    if len(cands) == 1:
        return cands[0]

    best, best_t = None, float("inf")
    for cand in cands:
        if cand.label in partial:
            dt = partial[cand.label]
            if dt is None:  # failed in a previous attempt; don't retry
                continue
            log(f"{cand.label}: {dt * 1e3:.1f} ms/launch (checkpointed)")
        else:
            try:
                dt = _measure(cand, lanes, sample_ids)
            except FloatingPointError as e:
                log(f"{cand.label}: rejected ({e})")
                dt = None
            partial[cand.label] = dt
            if cache_key is not None:
                _cache_store(cache_key, {"partial": partial})
            if dt is None:
                continue
            log(f"{cand.label}: {dt * 1e3:.1f} ms/launch")
        if dt < best_t:
            best, best_t = cand, dt
    if best is None:
        raise FloatingPointError("every tuner candidate rendered non-finite "
                                 "radiance")
    if cache_key is not None:
        _cache_store(cache_key, {
            "label": best.label, "nee_mode": best.nee_mode,
            "schedule": (list(best.schedule)
                         if best.schedule is not None else None),
            "resort": bool(best.resort),
        })
    log(f"selected {best.label}")
    return best
