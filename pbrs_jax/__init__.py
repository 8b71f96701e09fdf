"""pbrs_jax — a wavefront path tracer in JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of the ``pbrs``
CPU path tracer. The recursive CPU megakernel becomes a breadth-first
wavefront loop over SoA ray batches; primitive intersection is a tiled
sweep over flat typed tables; BSDF evaluation and sampling are branchless
vectorized dispatch over lobe tables; samplers are counter-based and
stateless so every pixel-sample is independently jittable.

Layering (mirrors reference crate DAG, reference Cargo.toml:44-53):
  core        — math substrate (vecmath, rng, spline, filters)   [ref: math/]
  radiometry  — color & spectra                                  [ref: radiometry/]
  geometry    — rays, cameras, transforms, interactions          [ref: geometry/]
  shapes      — typed primitive SoA tables + intersection        [ref: shape/]
  bxdf        — BSDF lobe models, fresnel, microfacet            [ref: geometry/src/bxdf.rs]
  materials   — material → lobe-table compiler                   [ref: material/]
  textures    — solid/checker/perlin/image texture tables        [ref: texture/]
  lights      — delta/area/env lights + shape sampling           [ref: light/]
  accel       — host BVH builders + trace functions              [ref: tlas/, shape/src/blas.rs]
  scene       — PBRT parser, PLY loader, presets, scene compiler [ref: scene_parser/, scene/]
  integrators — wavefront path / direct-lighting integrators     [ref: src/]
  io          — EXR/PNG input and output
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry flows through matmuls (camera basis, one-hot table lookups in
# core/gather.py, transform einsums). On the GPU, XLA's default f32
# matmul precision may run them as TF32, which keeps 10 mantissa bits: a
# one-hot lookup of the coordinate 554.3 comes back as 554.5. Force full
# f32; these matmuls are a negligible fraction of the frame.
_jax.config.update("jax_default_matmul_precision", "highest")
