"""BSDF lobe models with branchless kind dispatch.

The reference dispatches `BXDF` enum variants per hit
(reference geometry/src/bxdf.rs:262-269). Here a *lobe* is a row of SoA
parameter arrays tagged with an integer kind; eval/pdf/sample compute every
model for every lane and mask-select — no divergence, no virtual
calls. All directions are unit vectors in the local shading frame (+z =
normal, matching the Omega convention, geometry/src/bxdf.rs:9-29).

Kinds:
  NONE             empty slot
  LAMBERT          albedo/π                   [ref: bxdf.rs:539-573]
  OREN_NAYAR       alpha=(A,B) coefficients   [ref: bxdf.rs:543-558]
  MICROFACET       Torrance-Sparrow           [ref: bxdf.rs:575-639]
  SPEC_MIRROR      delta reflection           [ref: bxdf.rs:395-434, 467-469]
  SPEC_DIELECTRIC  delta reflect+refract mix  [ref: bxdf.rs:482-498]
  SPEC_TRANSMIT    delta refraction only      [ref: bxdf.rs:470-481]
  FRESNEL_BLEND    Ashikhmin-Shirley          [ref: bxdf.rs:641-717]

Deliberate fixes vs the reference (see COMPAT.md): FresnelBlend's
hemisphere checks are inverted in the reference (bxdf.rs:700-710) and its
pdf drops the 1/π and |cosθh| factors; both corrected here to the standard
Ashikhmin-Shirley sampling density.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core import gather as gth
from ..core import vecmath as vm
from . import fresnel as fr
from . import microfacet as mf

NONE = 0
LAMBERT = 1
OREN_NAYAR = 2
MICROFACET = 3
SPEC_MIRROR = 4
SPEC_DIELECTRIC = 5
SPEC_TRANSMIT = 6
FRESNEL_BLEND = 7
FOURIER = 8

_PI = jnp.pi
INV_PI = 1.0 / jnp.pi


ALL_KINDS = (LAMBERT, OREN_NAYAR, MICROFACET, SPEC_MIRROR, SPEC_DIELECTRIC,
             SPEC_TRANSMIT, FRESNEL_BLEND, FOURIER)


@struct.dataclass
class Lobes:
    """Per-hit lobe table; every field is [..., L] or [..., L, 3].

    `present_kinds` is the static set of lobe kinds that can occur in the
    scene: dispatch skips every model the scene cannot produce (a
    diffuse-only Cornell box evaluates exactly one model)."""

    kind: jnp.ndarray
    albedo: jnp.ndarray
    specular: jnp.ndarray  # FresnelBlend Rs
    alpha: jnp.ndarray  # [..., L, 2] microfacet alphas / Oren-Nayar (A, B)
    distrib: jnp.ndarray
    fr_kind: jnp.ndarray
    eta: jnp.ndarray  # [..., L, 2] dielectric (eta_front, eta_back)
    eta_t: jnp.ndarray  # [..., L, 3] conductor eta
    k: jnp.ndarray  # [..., L, 3] conductor absorption
    fourier: object = None  # scene-level FourierTable (one per scene)
    present_kinds: tuple = struct.field(pytree_node=False, default=ALL_KINDS)

    @property
    def num_slots(self):
        return self.kind.shape[-1]

    def has(self, *kinds):
        return any(k in self.present_kinds for k in kinds)


def slot(lobes: Lobes, l) -> Lobes:
    """View of slot l. `l` may be an int or an int array (per-lane
    selection, done with one-hot masking rather than a gather)."""
    if isinstance(l, int):
        pick = lambda a: a[..., l, :] if a.ndim > lobes.kind.ndim else a[..., l]
    else:
        pick = lambda a: gth.select_slot(a, l)
    return Lobes(*(pick(getattr(lobes, f)) for f in (
        "kind", "albedo", "specular", "alpha", "distrib", "fr_kind",
        "eta", "eta_t", "k")), fourier=lobes.fourier,
        present_kinds=lobes.present_kinds)


def num_active(lobes: Lobes):
    return jnp.sum((lobes.kind != NONE).astype(jnp.int32), axis=-1)


def is_delta_kind(kind):
    return (kind == SPEC_MIRROR) | (kind == SPEC_DIELECTRIC) | (
        kind == SPEC_TRANSMIT
    )


def _fourier_idx(lb: "Lobes"):
    """Per-lane Fourier table index, stashed in alpha[..., 0] by the
    material builder (multi-table scenes; 0 for single-table)."""
    return lb.alpha[..., 0].astype(jnp.int32)


# --------------------------- sampling helpers ------------------------------


def concentric_sample_disk(u2):
    """Map [0,1)² UNIFORMLY to the unit disk (Shirley-Chiu concentric).

    Deliberate fix vs the reference (COMPAT.md): bxdf.rs:187-200 uses a
    "polar form" — radius = max(|x|,|y|), angle from the *normalized*
    (x, y) — whose radius marginal is correct but whose azimuth density
    varies by ±33% (period π/2, diagonals oversampled: the square has
    more area per unit angle toward its corners). Every cosine-hemisphere
    sample drawn that way is azimuthally biased while its pdf is reported
    as cos/π, which biases any azimuth-dependent integrand (~20% on an
    off-axis environment window; constant-albedo reflectance tests cannot
    see it because the wrong density cancels against the wrong pdf)."""
    x = u2[..., 0] * 2.0 - 1.0
    y = u2[..., 1] * 2.0 - 1.0
    big = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(big, x, y)
    x_safe = jnp.where(x == 0.0, 1.0, x)
    y_safe = jnp.where(y == 0.0, 1.0, y)
    theta = jnp.where(
        big,
        (jnp.pi / 4.0) * (y / x_safe),
        (jnp.pi / 2.0) - (jnp.pi / 4.0) * (x / y_safe),
    )
    px = r * jnp.cos(theta)
    py = r * jnp.sin(theta)
    degenerate = (x == 0.0) & (y == 0.0)
    return jnp.where(degenerate, 0.0, px), jnp.where(degenerate, 0.0, py)


def cos_sample_hemisphere(u2):
    """Cosine-weighted +z hemisphere. [ref: geometry/src/bxdf.rs:202-206]"""
    x, y = concentric_sample_disk(u2)
    z = vm.safe_sqrt(1.0 - x * x - y * y)
    return jnp.stack([x, y, z], axis=-1)


def cos_hemisphere_pdf(wi):
    return jnp.abs(wi[..., 2]) * INV_PI


# ------------------------------- eval --------------------------------------


def _fresnel_of(lb: Lobes, cos_i):
    return fr.eval_color(
        lb.fr_kind, cos_i, lb.eta[..., 0], lb.eta[..., 1], lb.eta_t, lb.k
    )


def _oren_nayar_factor(lb, wo, wi):
    a, b = lb.alpha[..., 0], lb.alpha[..., 1]
    sin_i = jnp.sqrt(mf.sin2_theta(wi))
    sin_o = jnp.sqrt(mf.sin2_theta(wo))
    hyp_i = jnp.maximum(jnp.sqrt(wi[..., 0] ** 2 + wi[..., 1] ** 2), 1e-20)
    hyp_o = jnp.maximum(jnp.sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2), 1e-20)
    cos_dphi = (
        wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]
    ) / (hyp_i * hyp_o)
    d_cos = jnp.maximum(cos_dphi, 0.0)
    aci = jnp.abs(wi[..., 2])
    aco = jnp.abs(wo[..., 2])
    i_steeper = aci > aco
    sin_alpha = jnp.where(i_steeper, sin_o, sin_i)
    tan_beta = jnp.where(
        i_steeper, sin_i / jnp.maximum(aci, 1e-20), sin_o / jnp.maximum(aco, 1e-20)
    )
    return a + b * d_cos * sin_alpha * tan_beta


def _microfacet_eval(lb, wo, wi):
    aco = jnp.abs(mf.cos_theta(wo))
    aci = jnp.abs(mf.cos_theta(wi))
    mid = wo + wi
    ok = vm.dot(mid, mid) > 1e-16
    wh = vm.normalize(mid)
    wh = vm.face_forward(wh, jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], wh.dtype), wh.shape))
    f_color = _fresnel_of(lb, vm.dot(wi, wh))
    ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
    val = (
        lb.albedo
        * (mf.d(lb.distrib, ax, ay, wh) * mf.g(lb.distrib, ax, ay, wo, wi))[
            ..., None
        ]
        * f_color
        * vm.weak_recip(4.0 * aco * aci)[..., None]
    )
    zero_mask = (~ok) | (aco == 0.0) | (aci == 0.0)
    return jnp.where(zero_mask[..., None], 0.0, val)


def _fresnel_blend_eval(lb, wo, wi):
    mid = wo + wi
    ok = vm.dot(mid, mid) > 1e-16
    wh = vm.normalize(mid)
    aci = jnp.abs(mf.cos_theta(wi))
    aco = jnp.abs(mf.cos_theta(wo))
    rd, rs = lb.albedo, lb.specular
    diffuse = (
        (28.0 / 23.0 * INV_PI)
        * rd
        * (1.0 - rs)
        * ((1.0 - (1.0 - 0.5 * aci) ** 5) * (1.0 - (1.0 - 0.5 * aco) ** 5))[
            ..., None
        ]
    )
    iw = vm.dot(wi, wh)
    schlick_c = rs + ((1.0 - iw) ** 5)[..., None] * (1.0 - rs)
    ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
    denom = 4.0 * jnp.abs(iw) * jnp.maximum(aci, aco)
    spec = (
        mf.d(lb.distrib, ax, ay, wh) * vm.weak_recip(denom)
    )[..., None] * schlick_c
    return jnp.where(ok[..., None], diffuse + spec, 0.0)


def eval_lobe(lb: Lobes, wo, wi):
    """f(wo, wi) for one lobe slot; specular kinds evaluate to 0. Models
    absent from the scene (static) are never built.

    Reflection-only lobes (Lambert, Oren-Nayar, microfacet reflection,
    FresnelBlend) are zero for transmission-hemisphere wi: the reference
    sums lobes with no sidedness check (src/bsdf.rs:43-51), a latent light
    leak its BSDF-sampled-only integrators never hit — environment
    importance sampling aims below the horizon and exposed it (COMPAT.md).
    Fourier tables cover both hemispheres by construction."""
    k = lb.kind
    out = jnp.zeros_like(lb.albedo)
    same = (mf.same_hemisphere(wo, wi))[..., None]
    if lb.has(LAMBERT):
        out = jnp.where((k[..., None] == LAMBERT) & same,
                        lb.albedo * INV_PI, out)
    if lb.has(OREN_NAYAR):
        on = lb.albedo * INV_PI * _oren_nayar_factor(lb, wo, wi)[..., None]
        out = jnp.where((k[..., None] == OREN_NAYAR) & same, on, out)
    if lb.has(MICROFACET):
        out = jnp.where(
            (k[..., None] == MICROFACET) & same,
            _microfacet_eval(lb, wo, wi), out
        )
    if lb.has(FRESNEL_BLEND):
        out = jnp.where(
            (k[..., None] == FRESNEL_BLEND) & same,
            _fresnel_blend_eval(lb, wo, wi), out
        )
    if lb.has(FOURIER) and lb.fourier is not None:
        from . import fourier as fourier_mod

        out = jnp.where(
            k[..., None] == FOURIER,
            fourier_mod.eval_fourier(lb.fourier, wo, wi,
                                     _fourier_idx(lb)), out,
        )
    return out


def pdf_lobe(lb: Lobes, wo, wi):
    """Sampling density of one lobe slot (0 for delta kinds)."""
    k = lb.kind
    same = mf.same_hemisphere(wo, wi)
    out = jnp.zeros(k.shape, jnp.float32)
    if lb.has(LAMBERT, OREN_NAYAR, FRESNEL_BLEND):
        p_cos = jnp.where(same, cos_hemisphere_pdf(wi), 0.0)
        out = jnp.where((k == LAMBERT) | (k == OREN_NAYAR), p_cos, out)
    if lb.has(MICROFACET, FRESNEL_BLEND):
        mid = wo + wi
        ok = vm.dot(mid, mid) > 1e-16
        wh = vm.normalize(mid)
        ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
        p_mf = mf.pdf_wh(lb.distrib, ax, ay, wo, wh) * vm.weak_recip(
            4.0 * vm.dot(wo, wh)
        )
        p_mf = jnp.where(same & ok, p_mf, 0.0)
        out = jnp.where(k == MICROFACET, p_mf, out)
        if lb.has(FRESNEL_BLEND):
            p_fb = jnp.where(
                same & ok, 0.5 * (cos_hemisphere_pdf(wi) + p_mf), 0.0
            )
            out = jnp.where(k == FRESNEL_BLEND, p_fb, out)
    if lb.has(FOURIER) and lb.fourier is not None:
        from . import fourier as fourier_mod

        out = jnp.where(
            k == FOURIER,
            fourier_mod.pdf_fourier(lb.fourier, wo, wi, _fourier_idx(lb)),
            out,
        )
    return jnp.maximum(out, 0.0)


# ------------------------------- sample ------------------------------------


def _refract_local(wo, eta_front, eta_back):
    """Refract wo across the local z interface.
    [ref: geometry/src/bxdf.rs:436-454]"""
    entering = mf.cos_theta(wo) > 0.0
    eta_i = jnp.where(entering, eta_front, eta_back)
    eta_t = jnp.where(entering, eta_back, eta_front)
    sign = jnp.where(entering, 1.0, -1.0)
    normal = jnp.zeros_like(wo).at[..., 2].set(sign)
    wi, tir = vm.refract(normal, wo, eta_i / eta_t)
    return wi, tir


def sample_lobe(lb: Lobes, wo, u2):
    """Sample an incident direction from one lobe slot.

    Returns (f, wi, pdf_or_pmf, is_delta). For delta kinds the third value
    is the probability mass of the chosen branch.
    """
    k = lb.kind
    u, v = u2[..., 0], u2[..., 1]
    has = lb.has

    # Family A: cosine hemisphere (LAMBERT / OREN_NAYAR).
    wi = cos_sample_hemisphere(u2)
    # Reference asserts wo.z >= 0 here; frames are built with the normal
    # facing wo so flipping is a no-op in practice, kept for robustness.
    wi = wi * jnp.where(mf.cos_theta(wo) < 0.0, -1.0, 1.0)[..., None]

    ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
    fb_diffuse = u < 0.5

    if has(MICROFACET):
        wh = mf.sample_wh(lb.distrib, ax, ay, wo, u2)
        wi = jnp.where(k[..., None] == MICROFACET, vm.reflect(wh, wo), wi)

    if has(SPEC_MIRROR, SPEC_DIELECTRIC):
        wi_mirror = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
        wi = jnp.where(k[..., None] == SPEC_MIRROR, wi_mirror, wi)

    if has(SPEC_TRANSMIT, SPEC_DIELECTRIC):
        wi_refr, tir = _refract_local(wo, lb.eta[..., 0], lb.eta[..., 1])
        wi = jnp.where(k[..., None] == SPEC_TRANSMIT, wi_refr, wi)

    if has(FRESNEL_BLEND):
        # Two-strategy split on u. [ref: geometry/src/bxdf.rs:688-705]
        u_fb_lo = jnp.minimum(u * 2.0, 1.0 - 1e-7)
        u_fb_hi = jnp.mod(u * 2.0, 1.0)
        wi_fb_cos = cos_sample_hemisphere(jnp.stack([u_fb_lo, v], axis=-1))
        wh_fb = mf.sample_wh(
            lb.distrib, ax, ay, wo, jnp.stack([u_fb_hi, v], axis=-1)
        )
        wi_fb = jnp.where(
            fb_diffuse[..., None], wi_fb_cos, vm.reflect(wh_fb, wo)
        )
        wi = jnp.where(k[..., None] == FRESNEL_BLEND, wi_fb, wi)

    if has(SPEC_DIELECTRIC):
        # Hybrid dielectric: reflect with prob R, else refract.
        # [ref: geometry/src/bxdf.rs:482-498]
        r_coeff = fr.dielectric_refl(
            mf.cos_theta(wo), lb.eta[..., 0], lb.eta[..., 1]
        )
        diel_reflect = v < r_coeff
        wi_diel = jnp.where(diel_reflect[..., None], wi_mirror, wi_refr)
        wi = jnp.where(k[..., None] == SPEC_DIELECTRIC, wi_diel, wi)

    if has(FOURIER) and lb.fourier is not None:
        from . import fourier as fourier_mod

        f_f, wi_f, pdf_f = fourier_mod.sample_fourier_bsdf(
            lb.fourier, wo, u2, _fourier_idx(lb))
        wi = jnp.where(k[..., None] == FOURIER, wi_f, wi)

    # --- smooth f/pdf via shared eval ---
    f = eval_lobe(lb, wo, wi)
    p = pdf_lobe(lb, wo, wi)
    if has(FOURIER) and lb.fourier is not None:
        # The azimuth sampler returns its own f/pdf (cheaper and exact for
        # the sampled direction).
        f = jnp.where(k[..., None] == FOURIER, f_f, f)
        p = jnp.where(k == FOURIER, pdf_f, p)
    # Microfacet / FB-specular samples below the horizon are rejected.
    if has(MICROFACET, FRESNEL_BLEND):
        same = mf.same_hemisphere(wo, wi)
        reject = (
            (k == MICROFACET) | ((k == FRESNEL_BLEND) & ~fb_diffuse)
        ) & ~same
        f = jnp.where(reject[..., None], 0.0, f)
        p = jnp.where(reject, 0.0, p)

    # --- delta f/pmf ---
    is_delta = is_delta_kind(k)
    if has(SPEC_MIRROR, SPEC_DIELECTRIC, SPEC_TRANSMIT):
        aci = jnp.maximum(jnp.abs(mf.cos_theta(wi)), 0.0)
        inv_aci = vm.weak_recip(aci)
        pmf = jnp.ones(k.shape, jnp.float32)
        if has(SPEC_MIRROR):
            f_mirror = (
                _fresnel_of(lb, mf.cos_theta(wi)) * lb.albedo
                * inv_aci[..., None]
            )
            f = jnp.where(k[..., None] == SPEC_MIRROR, f_mirror, f)
        if has(SPEC_TRANSMIT, SPEC_DIELECTRIC):
            r_at_wi = fr.dielectric_refl(
                mf.cos_theta(wi), lb.eta[..., 0], lb.eta[..., 1]
            )
            f_refr = (1.0 - r_at_wi)[..., None] * lb.albedo * inv_aci[..., None]
            f_refr = jnp.where(tir[..., None], 0.0, f_refr)
            f = jnp.where(k[..., None] == SPEC_TRANSMIT, f_refr, f)
        if has(SPEC_DIELECTRIC):
            f_diel = jnp.where(
                diel_reflect[..., None],
                (r_coeff * inv_aci)[..., None] * lb.albedo,
                f_refr,
            )
            f = jnp.where(k[..., None] == SPEC_DIELECTRIC, f_diel, f)
            pmf = jnp.where(
                k == SPEC_DIELECTRIC,
                jnp.where(diel_reflect, r_coeff, 1.0 - r_coeff),
                pmf,
            )
        p = jnp.where(is_delta, pmf, p)

    p = jnp.where(k == NONE, 0.0, p)
    f = jnp.where((k == NONE)[..., None], 0.0, f)
    return f, wi, p, is_delta
