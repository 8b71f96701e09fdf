"""Vector math over ``[..., 3]`` jnp arrays — the SoA substrate.

Batched replacement for the reference's scalar Vec3/Point3 algebra
(reference math/src/hcm.rs:23-34, 595-650). Everything here is shape-
polymorphic over leading batch dimensions and safe under jit/vmap: no
data-dependent branching, division guarded by ``where``.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-8


def vec3(x, y, z, dtype=jnp.float32):
    """Stack three scalars/arrays into a [..., 3] vector."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)], axis=-1
    )


def dot(a, b, keepdims: bool = False):
    # Component arithmetic instead of a reduce op: the last axis is always
    # tiny (2 or 3), and elementwise products fuse where a reduce may not.
    if a.shape[-1] == 3 or b.shape[-1] == 3:
        out = (
            a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2]
        )
    elif a.shape[-1] == 2 or b.shape[-1] == 2:
        out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
    else:
        out = jnp.sum(a * b, axis=-1)
    return out[..., None] if keepdims else out


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length_squared(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length_squared(a))


def normalize(a, eps: float = EPS):
    """Unit vector; returns 0 for (near-)zero input instead of NaN."""
    n2 = dot(a, a)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return a * inv[..., None]


def distance(a, b):
    return length(a - b)


def lerp(t, a, b):
    """Linear interpolation a + t*(b-a). [ref: math/src/float.rs:23-50]"""
    return a + t * (b - a)


def weak_recip(x):
    """1/x with 0 -> 0 (reference `weak_recip`, math/src/float.rs:53-67)."""
    return jnp.where(x != 0.0, 1.0 / jnp.where(x != 0.0, x, 1.0), 0.0)


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def face_forward(v, ref):
    """Flip v to lie in the hemisphere of ref. [ref: geometry/src/bxdf.rs:149-155]"""
    s = jnp.where(dot(v, ref) < 0.0, -1.0, 1.0)
    return v * s[..., None]


def reflect(normal, wi):
    """Mirror wi about (not necessarily unit) normal.

    Matches reference semantics: result points to the same side as wi
    [ref: math/src/hcm.rs:607-611]: reflect(n, wi) = 2*proj_n(wi) - wi... in the
    reference's convention wi and the result both make an acute angle with n.
    """
    n2 = jnp.maximum(dot(normal, normal), EPS)
    perp = (dot(wi, normal) / n2)[..., None] * normal
    parallel = wi - perp
    return wi - 2.0 * parallel


def refract(normal, wi, ni_over_no):
    """Refract `wi` (unit, acute with unit `normal`) across the interface.

    Returns (direction, full_reflect_mask): where total internal reflection
    occurs, `direction` is the mirror reflection and the mask is True.
    [ref: math/src/hcm.rs:613-640]
    """
    cos_i = dot(wi, normal)
    sin2_i = jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    sin2_o = sin2_i * ni_over_no * ni_over_no
    full = sin2_o >= 1.0
    cos_o = safe_sqrt(1.0 - sin2_o)
    transmitted = -ni_over_no[..., None] * wi + (
        ni_over_no * cos_i - cos_o
    )[..., None] * normal
    reflected = reflect(normal, wi)
    return jnp.where(full[..., None], reflected, transmitted), full


def make_coord_system(v):
    """Two unit vectors forming an orthonormal basis with unit `v`.

    Branchless, gather-free ONB (Duff et al. 2017, "Building an Orthonormal
    Basis, Revisited") — replaces the reference's argmin-axis construction
    (math/src/hcm.rs:595-605), which needs per-lane index gathers.
    Returns (v1, v2) with v1 × v2 = v (so v × v1 = v2, right-handed).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    s = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + z)
    b = x * y * a
    v1 = vec3(1.0 + s * x * x * a, s * b, -s * x)
    v2 = vec3(b, s + y * y * a, -y)
    return v1, v2


def spherical_direction(sin_theta, cos_theta, phi):
    """Unit vector at polar angle theta from +z, azimuth phi from +x.
    [ref: math/src/hcm.rs:647-650]"""
    return vec3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)


def orthonormal_frame(normal, tangent_hint):
    """Build TBN columns (tangent, bitangent, normal) from a normal and a
    (possibly non-orthogonal) tangent hint. [ref: geometry/src/interaction.rs:45-61]

    Degenerate hints (parallel to the normal / zero) fall back to an
    automatically constructed basis so the frame is always orthonormal.
    """
    n = normalize(normal)
    b = cross(n, tangent_hint)
    good = dot(b, b) > 1e-12
    auto_t, _ = make_coord_system(n)
    b = jnp.where(good[..., None], b, cross(n, auto_t))
    b = normalize(b)
    t = cross(b, n)
    return t, b, n


def to_local(t, b, n, w):
    """World direction -> local frame coordinates (n = +z)."""
    return vec3(dot(w, t), dot(w, b), dot(w, n))


def to_world(t, b, n, w):
    """Local frame coordinates -> world direction."""
    return (
        w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n
    )
