"""Counter-based stateless samplers.

The reference draws from per-thread mutable RNGs (`rand::thread_rng()`,
reference src/pathintegrator.rs:10, src/directlighting.rs:67). That is
incompatible with jit-compiled SPMD execution, so every random draw here is
a pure function of (seed, pixel, sample, bounce, dimension). Two backends:

* ``pcg``    — a PCG-style integer hash chain, one multiply-xorshift per
  draw. Pure integer arithmetic; the default for rendering.
* ``threefry`` — `jax.random` fold_in chains. Slower, used as the
  gold-standard in statistical tests.

Both give every pixel-sample an independent, reproducible stream, which is
what makes the renderer deterministic under any device sharding (the
reference's determinism story was `--use_single_thread`,
reference src/cli_options.rs:89-90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Purpose/dimension ids — one stream per logical decision per bounce.
DIM_CAMERA_JITTER = 0
DIM_LIGHT_SELECT = 1
DIM_LIGHT_UV = 2
DIM_SCATTER_UV = 3
DIM_BSDF_UV = 4
DIM_RUSSIAN_ROULETTE = 5
DIM_SPECULAR_CHOICE = 6
DIM_CAMERA_STRATUM = 7
DIM_COMPACT = 8


def _pcg_permute(x):
    """PCG output permutation (RXS-M-XS variant) on uint32."""
    x = x.astype(jnp.uint32)
    word = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def _mix(h, k):
    """One absorb step: murmur3-style integer mixing of k into state h."""
    k = k.astype(jnp.uint32)
    k = k * jnp.uint32(0xCC9E2D51)
    k = (k << jnp.uint32(15)) | (k >> jnp.uint32(17))
    k = k * jnp.uint32(0x1B873593)
    h = h ^ k
    h = (h << jnp.uint32(13)) | (h >> jnp.uint32(19))
    h = h * jnp.uint32(5) + jnp.uint32(0xE6546B64)
    return h


def _finalize(h):
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h


def hash_u32(*counters):
    """Hash an arbitrary list of int32/uint32 counters to uint32."""
    h = jnp.uint32(0x9E3779B9)
    for c in counters:
        h = _mix(h, jnp.asarray(c))
    return _pcg_permute(_finalize(h))


def uniform_from_u32(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


class PCGSampler:
    """Stateless sampler: draws are pure functions of the counter tuple."""

    def __init__(self, seed: int = 0):
        self.seed = jnp.uint32(seed)

    def u1(self, pixel, sample, bounce, dim, lane=0):
        """One uniform [0,1) per element of the broadcast counter arrays."""
        bits = hash_u32(self.seed, pixel, sample, bounce * 16 + dim, lane)
        return uniform_from_u32(bits)

    def u2(self, pixel, sample, bounce, dim):
        """Two independent uniforms, stacked on the last axis."""
        return jnp.stack(
            [
                self.u1(pixel, sample, bounce, dim, lane=0),
                self.u1(pixel, sample, bounce, dim, lane=1),
            ],
            axis=-1,
        )


# --------------------------- Sobol (Owen-scrambled) -------------------------
#
# Low-discrepancy counterpart to PCGSampler with the same stateless
# interface. Design (Burley, "Practical Hash-based Owen Scrambling", JCGT
# 2020): every logical dimension (bounce*16+dim, lane) uses the base-2
# Sobol' pair (dim 0 = bit-reversed van der Corput, dim 1 = the classic
# direction-number column), padded across logical dimensions by
# hierarchically shuffling the *sample index* with a nested-uniform
# (Laine-Karras) scramble keyed by (seed, pixel, dimension), and the
# *output* Owen-scrambled with an independent key. Index shuffling is a
# bijection that permutes within nested dyadic blocks, so any power-of-two
# prefix of samples remains a (0,2)-sequence prefix per pixel, and output
# scrambling preserves elementary-interval stratification — variance falls
# ~O(1/N²·polylog) on smooth integrands vs O(1/N) for independent PCG.
# The reference has no low-discrepancy sampler (rand::thread_rng only);
# this fulfils the BASELINE.json north-star "Samplers (PCG/Sobol)".

# Direction numbers for Sobol' dimension 1 (Joe-Kuo; x_{k} columns v_k =
# 2^31 / 2^k * m_k with the primitive polynomial x^2+x+1, s=1): the
# standard 32 columns.
_SOBOL_DIM1 = np.zeros(32, np.uint32)
_v = np.uint32(1 << 31)
for _k in range(32):
    _SOBOL_DIM1[_k] = _v
    _v = _v ^ (_v >> np.uint32(1))
_SOBOL_DIM1 = tuple(int(x) for x in _SOBOL_DIM1)


def _reverse_bits_u32(x):
    x = x.astype(jnp.uint32)
    x = ((x << jnp.uint32(16)) | (x >> jnp.uint32(16)))
    x = (((x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8))
         | ((x & jnp.uint32(0xFF00FF00)) >> jnp.uint32(8)))
    x = (((x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4))
         | ((x & jnp.uint32(0xF0F0F0F0)) >> jnp.uint32(4)))
    x = (((x & jnp.uint32(0x33333333)) << jnp.uint32(2))
         | ((x & jnp.uint32(0xCCCCCCCC)) >> jnp.uint32(2)))
    x = (((x & jnp.uint32(0x55555555)) << jnp.uint32(1))
         | ((x & jnp.uint32(0xAAAAAAAA)) >> jnp.uint32(1)))
    return x


def _laine_karras(x, seed):
    """Owen scramble of a bit-REVERSED value (Laine-Karras permutation,
    Burley 2020 §10.2 'nested_uniform_scramble_base2')."""
    x = x.astype(jnp.uint32)
    seed = seed.astype(jnp.uint32)
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble on the natural bit order (reverse, LK, reverse)."""
    return _reverse_bits_u32(_laine_karras(_reverse_bits_u32(x), seed))


def sobol_u32(index, dim):
    """Unscrambled base-2 Sobol' sample `index` of dimension `dim` (0/1)
    as a uint32 in [0, 2^32)."""
    index = jnp.asarray(index).astype(jnp.uint32)
    if dim == 0:
        return _reverse_bits_u32(index)
    out = jnp.zeros(jnp.shape(index), jnp.uint32)
    for k in range(32):
        bit = (index >> jnp.uint32(k)) & jnp.uint32(1)
        out = out ^ (bit * jnp.uint32(_SOBOL_DIM1[k]))
    return out


class SobolSampler:
    """Stateless Owen-scrambled Sobol'; drop-in for PCGSampler.

    u2 draws the genuine 2-D Sobol' pair (preserving its joint (0,2)
    stratification); u1 draws dimension 0. Per-(pixel, dimension) index
    shuffling pads the two base dimensions to the full path-space
    dimension set."""

    def __init__(self, seed: int = 0):
        self.seed = jnp.uint32(seed)

    def _draw(self, pixel, sample, bounce, dim, lane, sobol_dim):
        dkey = jnp.uint32(bounce) * jnp.uint32(16) + jnp.uint32(dim)
        shuffle_key = hash_u32(self.seed, pixel, dkey, lane,
                               jnp.uint32(0x51633E2D))
        scramble_key = hash_u32(self.seed, pixel, dkey, lane,
                                jnp.uint32(0x68BC21EB) + jnp.uint32(sobol_dim))
        idx = nested_uniform_scramble(
            jnp.asarray(sample).astype(jnp.uint32), shuffle_key)
        bits = nested_uniform_scramble(sobol_u32(idx, sobol_dim),
                                       scramble_key)
        return uniform_from_u32(bits)

    def u1(self, pixel, sample, bounce, dim, lane=0):
        out = self._draw(pixel, sample, bounce, dim, lane, 0)
        return jnp.broadcast_to(out, jnp.broadcast_shapes(
            jnp.shape(pixel), jnp.shape(out)))

    def u2(self, pixel, sample, bounce, dim):
        # Same shuffled index for both axes: the pair is a true 2-D Sobol'
        # point, so (u, v) keeps the joint elementary-interval property.
        return jnp.stack(
            [
                self._draw(pixel, sample, bounce, dim, 0, 0),
                self._draw(pixel, sample, bounce, dim, 0, 1),
            ],
            axis=-1,
        )


class ThreefrySampler:
    """jax.random-backed equivalent (threefry), for cross-validation."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.key(seed)

    def _key(self, pixel, sample, bounce, dim, lane):
        k = self.key
        for c in (pixel, sample, bounce * 16 + dim, lane):
            k = jax.random.fold_in(k, jnp.asarray(c, jnp.uint32))
        return k

    def u1(self, pixel, sample, bounce, dim, lane=0):
        keys = jax.vmap(
            lambda p, s: self._key(p, s, bounce, dim, lane)
        )(jnp.ravel(pixel), jnp.broadcast_to(sample, jnp.shape(pixel)).ravel())
        u = jax.vmap(lambda k: jax.random.uniform(k))(keys)
        return u.reshape(jnp.shape(pixel))

    def u2(self, pixel, sample, bounce, dim):
        return jnp.stack(
            [
                self.u1(pixel, sample, bounce, dim, lane=0),
                self.u1(pixel, sample, bounce, dim, lane=1),
            ],
            axis=-1,
        )


def stratified_jitter(sampler, pixel, sample, msaa: int):
    """Per-sample stratified jitter inside the pixel, matching the reference
    sampling layout (reference src/main.rs:197-203): sample i of msaa² lands
    in stratum (i // msaa, i % msaa) with a uniform sub-jitter.
    Returns (dx, dy) in [0,1)².
    """
    u = sampler.u2(pixel, sample, 0, DIM_CAMERA_JITTER)
    i = jnp.asarray(sample)
    # Sample ids >= msaa² (sharded renders round the batch up to the 'sp'
    # axis) fall back to a *random* stratum, keeping the jitter inside the
    # pixel footprint and the estimator unbiased regardless of how many
    # extra samples the rounding added. [ADVICE r1 #5]
    n_strata = msaa * msaa
    overflow = i >= n_strata
    if isinstance(sample, (int, np.integer)) and int(sample) < n_strata:
        k = i
    else:
        u_s = sampler.u1(pixel, sample, 0, DIM_CAMERA_STRATUM)
        rand_k = jnp.minimum(
            (u_s * n_strata).astype(jnp.int32), n_strata - 1
        )
        k = jnp.where(overflow, rand_k, i)
    sx = ((k // msaa) % msaa).astype(jnp.float32)
    sy = (k % msaa).astype(jnp.float32)
    dx = (sx + u[..., 0]) / msaa
    dy = (sy + u[..., 1]) / msaa
    return dx, dy
