"""Multi-lobe BSDF aggregation in the world frame.

Replaces the reference's `BSDF` struct (reference src/bsdf.rs:11-137):
builds the TBN frame from hit normal + dpdu, converts directions to the
local frame, and combines the per-lobe models of `lobes.py`.

Mixture semantics (documented deviation, see COMPAT.md): the lobe to sample
is picked uniformly among the `n` active slots; the returned pdf is the
true procedure density Σ_l pdf_l / n (delta lobes contribute pmf_l / n).
The reference divides by the number of *smooth* lobes only
(src/bsdf.rs:95-97) and returns a chosen delta lobe's mass undivided
(src/bsdf.rs:86-88) — biased whenever delta and smooth lobes mix (the Uber
material); identical for single-lobe materials.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core import vecmath as vm
from . import lobes as lb


@struct.dataclass
class Frame:
    t: jnp.ndarray
    b: jnp.ndarray
    n: jnp.ndarray


def make_frame(normal, dpdu) -> Frame:
    """[ref: src/bsdf.rs:18-31 — tangent = bitangent × normal]"""
    t, b, n = vm.orthonormal_frame(normal, dpdu)
    return Frame(t=t, b=b, n=n)


def world_to_local(frame: Frame, w):
    return vm.normalize(vm.to_local(frame.t, frame.b, frame.n, w))


def local_to_world(frame: Frame, w):
    return vm.to_world(frame.t, frame.b, frame.n, w)


def eval_bsdf(lobes: lb.Lobes, frame: Frame, wo_world, wi_world):
    """Σ lobes f(wo, wi); zero when wo is tangent to the surface.
    [ref: src/bsdf.rs:43-51]"""
    wo = world_to_local(frame, wo_world)
    wi = world_to_local(frame, wi_world)
    total = jnp.zeros(wo.shape, wo.dtype)
    for l in range(lobes.num_slots):
        total = total + lb.eval_lobe(lb.slot(lobes, l), wo, wi)
    return jnp.where((wo[..., 2] == 0.0)[..., None], 0.0, total)


def pdf_bsdf(lobes: lb.Lobes, frame: Frame, wo_world, wi_world):
    """Mixture density Σ pdf_l / n_active. [ref: src/bsdf.rs:53-57, corrected]"""
    wo = world_to_local(frame, wo_world)
    wi = world_to_local(frame, wi_world)
    total = jnp.zeros(wo.shape[:-1], wo.dtype)
    for l in range(lobes.num_slots):
        total = total + lb.pdf_lobe(lb.slot(lobes, l), wo, wi)
    n = lb.num_active(lobes)
    return jnp.where(n > 0, total / jnp.maximum(n, 1), 0.0)


def sample_bsdf(lobes: lb.Lobes, frame: Frame, wo_world, u2):
    """Pick a lobe uniformly (scene compiler packs active lobes from slot 0),
    sample it, tally the other lobes. [ref: src/bsdf.rs:59-103]

    Returns (f, wi_world, pdf, is_delta). For delta lobes f is the delta
    throughput (already divided by |cos|) and pdf is pmf/n.
    """
    wo = world_to_local(frame, wo_world)
    u, v = u2[..., 0], u2[..., 1]
    n = lb.num_active(lobes)
    n_f = jnp.maximum(n, 1).astype(u.dtype)
    chosen = jnp.minimum((u * n_f).astype(jnp.int32), jnp.maximum(n - 1, 0))
    u_remap = jnp.mod(u * n_f, 1.0)
    # Reference passes (v, remapped_u) to the chosen lobe. [ref: src/bsdf.rs:79]
    rnd2 = jnp.stack([v, u_remap], axis=-1)

    chosen_lobe = lb.slot(lobes, chosen)
    f_c, wi, p_c, is_delta = lb.sample_lobe(chosen_lobe, wo, rnd2)

    f_sum = jnp.zeros_like(f_c)
    p_sum = jnp.zeros_like(p_c)
    for l in range(lobes.num_slots):
        other = lb.slot(lobes, l)
        mask = (l != chosen) & (other.kind != lb.NONE)
        f_sum = f_sum + jnp.where(
            mask[..., None], lb.eval_lobe(other, wo, wi), 0.0
        )
        p_sum = p_sum + jnp.where(mask, lb.pdf_lobe(other, wo, wi), 0.0)

    f = jnp.where(is_delta[..., None], f_c, f_c + f_sum)
    pdf = jnp.where(is_delta, p_c, p_c + p_sum) / n_f
    none_active = n == 0
    f = jnp.where(none_active[..., None], 0.0, f)
    pdf = jnp.where(none_active, 0.0, pdf)
    return f, local_to_world(frame, wi), pdf, is_delta


def sample_specular(lobes: lb.Lobes, frame: Frame, wo_world):
    """Sample the first delta lobe, if any (direct-lighting integrator's
    perfect-specular bounce). [ref: src/bsdf.rs:104-113]
    Returns (f, wi_world, pmf, has_specular)."""
    wo = world_to_local(frame, wo_world)
    found = jnp.zeros(wo.shape[:-1], bool)
    f_out = jnp.zeros_like(wo)
    wi_out = jnp.zeros_like(wo)
    pmf_out = jnp.zeros(wo.shape[:-1], wo.dtype)
    zeros2 = jnp.zeros(wo.shape[:-1] + (2,), wo.dtype)
    for l in range(lobes.num_slots):
        this = lb.slot(lobes, l)
        is_spec = lb.is_delta_kind(this.kind) & ~found
        f, wi, p, _ = lb.sample_lobe(this, wo, zeros2)
        f_out = jnp.where(is_spec[..., None], f, f_out)
        wi_out = jnp.where(is_spec[..., None], wi, wi_out)
        pmf_out = jnp.where(is_spec, p, pmf_out)
        found = found | lb.is_delta_kind(this.kind)
    return f_out, local_to_world(frame, wi_out), pmf_out, found
