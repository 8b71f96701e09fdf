"""Equirect environment-map importance sampling.

The reference treats an image environment as a BSDF-sampled light only
(reference src/directlighting.rs:93-99): NEE never aims at the bright
texels, so a small window in a dark room converges at the variance of
hemisphere sampling. This module adds the standard PBRT InfiniteAreaLight
distribution, shaped for batched lanes:

* Host build: luminance * sin(theta) weighted piecewise-constant 2-D
  distribution over the equirect grid, compiled to a FLAT Vose alias
  table over all H*W texels with both outcomes' payloads packed per
  bucket row.
* Device sample: ONE wide row gather. The first CDF implementation
  (marginal searchsorted + per-row conditional binary scan) materialized
  [N, W+1] row fetches and dominated the NEE stage on the interior scene;
  the alias draw replaces it. Same distribution, different u -> texel
  mapping.
* Device pdf: direction -> (row, col) -> pdf, for the MIS weight of the
  BSDF-sampled arm.

pdf(dir) = p_img(u, v) * (H * W) / (2 pi^2 sin(theta)) with
p_img the normalized texel probability — the Jacobian of the equirect
(u, v) -> direction map. Poles (sin(theta) ~ 0) carry ~zero weight by
construction.

Both NEE arms (light-sampled here + BSDF-sampled) combine with the power-2
heuristic in integrators/nee.py; ACCURACY.md
records the measured equal-spp MSE win.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct


@struct.dataclass
class EnvDistribution:
    """Piecewise-constant 2-D distribution over the equirect image."""

    marginal_cdf: jnp.ndarray  # [H+1] over rows, cdf[0]=0, cdf[H]=1
    conditional_cdf: jnp.ndarray  # [H, W+1] per-row cdf
    pdf_img: jnp.ndarray  # [H, W] normalized texel density (sums to 1)
    image: jnp.ndarray  # [H, W, 3]
    scale: jnp.ndarray  # [3]
    # Flat alias table over H*W texels; per bucket row:
    # [q, b_row, b_col, b_r, b_g, b_b, b_p, a_row, a_col, a_r, a_g, a_b,
    #  a_p] — threshold + (row, col, radiance, texel prob) for the bucket
    # texel and its alias, so one gather serves the whole draw.
    alias_packed: jnp.ndarray = None  # [H*W, 13]


def build_distribution(image, scale=(1.0, 1.0, 1.0)) -> EnvDistribution:
    """Host-side CDF build from the [H, W, 3] equirect radiance map."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    lum = (0.21267127 * img[..., 0] + 0.71515972 * img[..., 1]
           + 0.07216883 * img[..., 2])
    # sin(theta) row weight: the solid angle of an equirect texel row.
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0:
        weight = np.ones_like(weight)
        total = weight.sum()
    pdf_img = (weight / total).astype(np.float32)  # [H, W], sums to 1

    row_w = pdf_img.sum(axis=1)  # [H]
    marginal = np.zeros(h + 1, np.float32)
    marginal[1:] = np.cumsum(row_w)
    marginal[-1] = 1.0

    cond = np.zeros((h, w + 1), np.float32)
    safe_row = np.where(row_w > 0, row_w, 1.0)
    cond[:, 1:] = np.cumsum(pdf_img / safe_row[:, None], axis=1)
    cond[:, -1] = 1.0

    # --- flat Vose alias table over the H*W texels -----------------------
    p = pdf_img.reshape(-1).astype(np.float64)
    hw = p.size
    scaled = p * hw
    q = np.ones(hw, np.float64)
    alias = np.arange(hw, dtype=np.int64)
    small = [i for i in range(hw) if scaled[i] < 1.0]
    large = [i for i in range(hw) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        q[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        q[i] = 1.0

    rows_i = (np.arange(hw, dtype=np.int64) // w).astype(np.float32)
    cols_i = (np.arange(hw, dtype=np.int64) % w).astype(np.float32)
    rgb = img.reshape(hw, 3)
    p32 = pdf_img.reshape(-1)

    def payload(idx):
        return np.concatenate([
            rows_i[idx, None], cols_i[idx, None], rgb[idx], p32[idx, None],
        ], axis=1)

    own = payload(np.arange(hw))
    ali = payload(alias)
    alias_packed = np.concatenate(
        [q[:, None].astype(np.float32), own, ali], axis=1)

    return EnvDistribution(
        marginal_cdf=jnp.asarray(marginal),
        conditional_cdf=jnp.asarray(cond),
        pdf_img=jnp.asarray(pdf_img),
        image=jnp.asarray(img),
        scale=jnp.asarray(scale, jnp.float32),
        alias_packed=jnp.asarray(alias_packed),
    )


def _dir_from_uv(u, v):
    """Equirect (u, v) in [0,1)^2 -> unit direction; the inverse of the
    lookup in lights.eval_env (phi = atan2(z, x), theta from +y)."""
    phi = (u - 0.5) * (2.0 * jnp.pi)
    theta = v * jnp.pi
    sin_t = jnp.sin(theta)
    return jnp.stack(
        [sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)],
        axis=-1)


def sample_env(dist: EnvDistribution, u2):
    """Draw directions from the env distribution via the flat alias
    table: ONE [N, 13] row gather + arithmetic.

    u2: [N, 2] uniforms. Returns (dir [N,3], radiance [N,3], pdf [N]).
    pdf is w.r.t. solid angle; 0 only at degenerate poles. Within-texel
    position is jittered from the residual uniforms (frac of the bucket
    coordinate + the rescaled threshold residual), so the continuous
    (u, v) density stays p_img * H * W exactly as in the CDF inversion —
    same distribution, different u -> texel mapping."""
    h = dist.pdf_img.shape[0]
    w = dist.pdf_img.shape[1]
    hw = h * w
    u, v = u2[..., 0], u2[..., 1]
    x = jnp.clip(v, 0.0, 1.0 - 1e-7) * hw
    b = jnp.clip(x.astype(jnp.int32), 0, hw - 1)
    rowv = jnp.take(dist.alias_packed, b, axis=0)  # [N, 13]
    q = rowv[..., 0]
    take_alias = u >= q
    sel = jnp.where(take_alias[..., None], rowv[..., 7:13], rowv[..., 1:7])
    ju = jnp.where(
        take_alias,
        (u - q) / jnp.maximum(1.0 - q, 1e-12),
        u / jnp.maximum(q, 1e-12),
    )
    jv = x - b.astype(jnp.float32)
    row_f, col_f = sel[..., 0], sel[..., 1]
    radiance = sel[..., 2:5] * dist.scale
    p_img = sel[..., 5]
    uu = (col_f + jnp.clip(ju, 0.0, 1.0 - 1e-6)) / w
    vv = (row_f + jnp.clip(jv, 0.0, 1.0 - 1e-6)) / h
    direction = _dir_from_uv(uu, vv)
    sin_t = jnp.sqrt(jnp.maximum(
        1.0 - direction[..., 1] * direction[..., 1], 0.0))
    pdf = p_img * hw / jnp.maximum(2.0 * jnp.pi * jnp.pi * sin_t, 1e-8)
    return direction, radiance, pdf


def _sample_env_cdf(dist: EnvDistribution, u2):
    """Reference CDF-inversion sampler (the alias table's cross-check;
    too gather-heavy for the hot path — see module docstring)."""
    h = dist.pdf_img.shape[0]
    w = dist.pdf_img.shape[1]
    u, v = u2[..., 0], u2[..., 1]
    # Invert the marginal: row = largest i with cdf[i] <= v.
    row = jnp.clip(
        jnp.searchsorted(dist.marginal_cdf, v, side="right") - 1, 0, h - 1)
    c0 = dist.marginal_cdf[row]
    c1 = dist.marginal_cdf[row + 1]
    dv = jnp.where(c1 > c0, (v - c0) / jnp.maximum(c1 - c0, 1e-30), 0.5)
    vv = (row.astype(jnp.float32) + jnp.clip(dv, 0.0, 1.0 - 1e-6)) / h
    # Invert the row-conditional (vectorized per-row binary scan).
    cond = dist.conditional_cdf[row]  # [N, W+1] row gather
    col = jnp.clip(_searchsorted_rows(cond, u), 0, w - 1)
    d0 = jnp.take_along_axis(cond, col[..., None], axis=-1)[..., 0]
    d1 = jnp.take_along_axis(cond, col[..., None] + 1, axis=-1)[..., 0]
    du = jnp.where(d1 > d0, (u - d0) / jnp.maximum(d1 - d0, 1e-30), 0.5)
    uu = (col.astype(jnp.float32) + jnp.clip(du, 0.0, 1.0 - 1e-6)) / w

    direction = _dir_from_uv(uu, vv)
    radiance = dist.image[row, col] * dist.scale
    p_img = dist.pdf_img[row, col]
    sin_t = jnp.sqrt(jnp.maximum(
        1.0 - direction[..., 1] * direction[..., 1], 0.0))
    pdf = p_img * (h * w) / jnp.maximum(
        2.0 * jnp.pi * jnp.pi * sin_t, 1e-8)
    return direction, radiance, pdf


def _searchsorted_rows(cdf_rows, x):
    """Per-row searchsorted(side='right') - 1 on [N, K+1] rows against [N]
    queries: a vectorized binary scan (log2 K steps, no data-dependent
    control flow)."""
    n, kp1 = cdf_rows.shape
    lo = jnp.zeros(x.shape, jnp.int32)
    hi = jnp.full(x.shape, kp1 - 1, jnp.int32)
    steps = int(np.ceil(np.log2(max(kp1, 2))))
    for _ in range(steps):
        mid = (lo + hi) // 2
        val = jnp.take_along_axis(cdf_rows, mid[..., None], axis=-1)[..., 0]
        go_right = val <= x
        lo = jnp.where(go_right, mid, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def eval_env_pdf(env, directions):
    """(radiance [N,3], solid-angle pdf [N]) along directions — ONE texel
    gather for what eval_env + pdf_env cost two.

    Packing the pdf as a 4th channel next to rgb halves the env
    machinery's per-bounce random-row gather passes. The [H, W, 4] concat of two scene constants is
    constant-folded by XLA at compile time — no persistent table. Same
    nearest-texel semantics and identical values to the separate
    lookups."""
    dist = env.dist
    h, w = dist.pdf_img.shape
    assert env.image.shape[:2] == (h, w)
    d = directions / jnp.maximum(
        jnp.linalg.norm(directions, axis=-1, keepdims=True), 1e-30)
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    u = (phi / (2.0 * jnp.pi) + 0.5) % 1.0
    v = theta / jnp.pi
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    packed = jnp.concatenate(
        [env.image, dist.pdf_img[..., None]], axis=-1)  # [H, W, 4]
    g = packed[row, col]
    rgb = g[..., :3] * env.scale
    sin_t = jnp.sin(theta)
    pdf = g[..., 3] * (h * w) / jnp.maximum(
        2.0 * jnp.pi * jnp.pi * sin_t, 1e-8)
    return rgb, pdf


def pdf_env(dist: EnvDistribution, directions):
    """Solid-angle pdf of the distribution along arbitrary directions
    (the MIS weight for the BSDF-sampled arm)."""
    h = dist.pdf_img.shape[0]
    w = dist.pdf_img.shape[1]
    d = directions / jnp.maximum(
        jnp.linalg.norm(directions, axis=-1, keepdims=True), 1e-30)
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    u = (phi / (2.0 * jnp.pi) + 0.5) % 1.0
    v = theta / jnp.pi
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    p_img = dist.pdf_img[row, col]
    sin_t = jnp.sin(theta)
    return p_img * (h * w) / jnp.maximum(
        2.0 * jnp.pi * jnp.pi * sin_t, 1e-8)
