"""Device-resident texture table.

Textures are rows in a typed table (kind + params + a shared flat image
atlas); evaluation reads the whole parameter row in ONE packed one-hot
lookup and mask-selects over kinds — replacing the reference's
`Arc<dyn Texture>` virtual calls (reference texture/src/lib.rs).

Kinds:
  SOLID    color_a                                  [ref: texture/src/lib.rs:19-33]
  CHECKER  3D sine checker, odd/even colors         [ref: lib.rs:35-49]
  PERLIN   marble pattern over gradient noise       [ref: lib.rs:51-160]
  IMAGE    nearest-neighbor clamp sampling, atlas   [ref: lib.rs:162-223]

Perlin is gather-free: the reference's random permutation + gradient
tables (lib.rs:60-96) are per-lane lattice GATHERS — 4 gathers x 8
corners x 7 octaves = 224 per evaluation, which dominated whole frames.
The lattice hash here is a murmur-style integer mix and the gradient is
Perlin's classic 16-direction branchless set, all elementwise arithmetic. Both
schemes are randomized gradient lattices; the reference's exact pattern is
RNG-seeded and not bit-reproducible anyway (COMPAT.md).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core import gather as gth

SOLID = 0
CHECKER = 1
PERLIN = 2
IMAGE = 3


@struct.dataclass
class TextureTable:
    kind: jnp.ndarray  # [T] int32
    color_a: jnp.ndarray  # [T,3] solid color / checker even
    color_b: jnp.ndarray  # [T,3] checker odd
    freq: jnp.ndarray  # [T] perlin frequency
    img_offset: jnp.ndarray  # [T] int32 offset into atlas
    img_w: jnp.ndarray  # [T] int32
    img_h: jnp.ndarray  # [T] int32
    atlas: jnp.ndarray  # [P,3] flattened image pixels
    packed: jnp.ndarray = None  # [T,C] all scalar fields, one-hot lookup
    layout: tuple = struct.field(pytree_node=False, default=())

    @property
    def num_textures(self):
        return self.kind.shape[0]


def _hash3(ix, iy, iz):
    """Murmur-style integer mix of three lattice coordinates -> uint32."""
    h = ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
    h = h + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
    h = h + iz.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(16))
    return h


def _grad_dot(h, x, y, z):
    """Perlin's 16-direction gradient dot product, branchless (no table)."""
    hi = (h & jnp.uint32(15)).astype(jnp.int32)
    u = jnp.where(hi < 8, x, y)
    v = jnp.where(hi < 4, y, jnp.where((hi == 12) | (hi == 14), x, z))
    su = jnp.where((hi & 1) == 0, u, -u)
    sv = jnp.where((hi & 2) == 0, v, -v)
    return su + sv


def _perlin_noise(p):
    """Gradient lattice noise with trilinear smoothstep interpolation —
    same structure as reference texture/src/lib.rs:98-139, gather-free
    gradients (module docstring)."""
    i0 = jnp.floor(p).astype(jnp.int32)
    frac = p - jnp.floor(p)
    sm = frac * frac * (3.0 - 2.0 * frac)  # smoothstep weights [N,3]
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                h = _hash3(i0[..., 0] + di, i0[..., 1] + dj, i0[..., 2] + dk)
                dotp = _grad_dot(
                    h, frac[..., 0] - di, frac[..., 1] - dj, frac[..., 2] - dk
                )
                wu = sm[..., 0] * di + (1.0 - sm[..., 0]) * (1 - di)
                wj = sm[..., 1] * dj + (1.0 - sm[..., 1]) * (1 - dj)
                wk = sm[..., 2] * dk + (1.0 - sm[..., 2]) * (1 - dk)
                accum = accum + wu * wj * wk * dotp
    # 16-direction gradients have length sqrt(2); match the reference's
    # unit-vector amplitude.
    return accum * float(1.0 / np.sqrt(2.0))


def _perlin_turbulence(p, octaves=7):
    """[ref: texture/src/lib.rs:141-149]"""
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    for i in range(octaves):
        accum = accum + 0.5**i * _perlin_noise(p * (2.0**i))
    return jnp.abs(accum)


def eval_texture(table: TextureTable, tex_id, uv, pos):
    """Evaluate textures for per-hit tex ids. tex_id [N], uv [N,2], pos [N,3].
    tex_id < 0 yields black (callers overlay solid colors themselves)."""
    tid = jnp.maximum(tex_id, 0)
    rows = gth.lookup_rows(table.packed, tid, table.num_textures)
    kind, ca, cb, freq, off, w, h = gth.unpack_fields(rows, table.layout)

    out = ca  # SOLID

    # CHECKER: sines of 10x position. [ref: lib.rs:41-48]
    sines = (
        jnp.sin(10.0 * pos[..., 0])
        * jnp.sin(10.0 * pos[..., 1])
        * jnp.sin(10.0 * pos[..., 2])
    )
    checker = jnp.where((sines < 0.0)[..., None], cb, ca)
    out = jnp.where((kind == CHECKER)[..., None], checker, out)

    # PERLIN marble: sin(freq*z + 10*turbulence(p)) * .5 + .5.
    # [ref: lib.rs:151-160]. Reference noise() scales the lattice by freq
    # internally and turbulence scales by 2^i; equivalent to evaluating
    # noise at freq * 2^i * p.
    turb = _perlin_turbulence_scaled(pos, freq)
    marble = jnp.sin(freq * pos[..., 2] + 10.0 * turb) * 0.5 + 0.5
    out = jnp.where((kind == PERLIN)[..., None], marble[..., None], out)

    # IMAGE: nearest with uv clamp. [ref: lib.rs:205-216]
    u = jnp.clip(uv[..., 0], 0.0, 1.0)
    v = jnp.clip(uv[..., 1], 0.0, 1.0)
    col = jnp.mod((u * w).astype(jnp.int32), jnp.maximum(w, 1))
    row = jnp.mod((v * h).astype(jnp.int32), jnp.maximum(h, 1))
    pix = table.atlas[off + row * w + col]
    out = jnp.where((kind == IMAGE)[..., None], pix, out)
    return jnp.where((tex_id < 0)[..., None], 0.0, out)


def _perlin_turbulence_scaled(p, freq, octaves=7):
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    for i in range(octaves):
        accum = accum + 0.5**i * _perlin_noise(p * (freq * 2.0**i)[..., None])
    return jnp.abs(accum)


class TextureBuilder:
    """Host-side accumulator. `add_*` returns the texture id."""

    def __init__(self):
        self.rows = []  # (kind, color_a, color_b, freq, image|None)
        self.images = []

    def add_solid(self, color) -> int:
        self.rows.append((SOLID, np.asarray(color, np.float32), np.zeros(3), 1.0, None))
        return len(self.rows) - 1

    def add_checker(self, even, odd) -> int:
        self.rows.append(
            (CHECKER, np.asarray(even, np.float32), np.asarray(odd, np.float32), 1.0, None)
        )
        return len(self.rows) - 1

    def add_perlin(self, freq: float) -> int:
        self.rows.append((PERLIN, np.zeros(3), np.zeros(3), float(freq), None))
        return len(self.rows) - 1

    def add_image(self, pixels_hw3) -> int:
        img = np.asarray(pixels_hw3, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3
        self.rows.append((IMAGE, np.zeros(3), np.zeros(3), 1.0, img))
        return len(self.rows) - 1

    def add_image_file(self, path: str) -> int:
        from ..io import image as io_image

        return self.add_image(io_image.load_image(path))

    def build(self) -> TextureTable:
        rows = self.rows or [(SOLID, np.zeros(3), np.zeros(3), 1.0, None)]
        offsets, widths, heights = [], [], []
        atlas_parts = []
        cursor = 0
        for (_, _, _, _, img) in rows:
            if img is None:
                offsets.append(0)
                widths.append(0)
                heights.append(0)
            else:
                offsets.append(cursor)
                heights.append(img.shape[0])
                widths.append(img.shape[1])
                atlas_parts.append(img.reshape(-1, 3))
                cursor += img.shape[0] * img.shape[1]
        atlas = (
            np.concatenate(atlas_parts, axis=0)
            if atlas_parts
            else np.zeros((1, 3), np.float32)
        )
        kind = np.asarray([r[0] for r in rows], np.int32)
        color_a = np.stack([r[1] for r in rows]).astype(np.float32)
        color_b = np.stack([r[2] for r in rows]).astype(np.float32)
        freq = np.asarray([r[3] for r in rows], np.float32)
        off = np.asarray(offsets, np.int32)
        w = np.asarray(widths, np.int32)
        h = np.asarray(heights, np.int32)
        packed, layout = gth.pack_fields(
            [kind, color_a, color_b, freq, off, w, h]
        )
        return TextureTable(
            kind=jnp.asarray(kind),
            color_a=jnp.asarray(color_a),
            color_b=jnp.asarray(color_b),
            freq=jnp.asarray(freq),
            img_offset=jnp.asarray(off),
            img_w=jnp.asarray(w),
            img_h=jnp.asarray(h),
            atlas=jnp.asarray(atlas),
            packed=jnp.asarray(packed),
            layout=tuple(layout),
        )
