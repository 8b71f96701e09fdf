"""Render-time invariant auditing (--debug_checks).

The reference enforces its geometric invariants with dense runtime
``assert!``s: the shading frame must be right-handed orthonormal
(interaction.rs:45-61), a BLAS hit must lie inside the node's bbox with
t in the ray's live extent (blas.rs:300-302), and TLAS children must be
enclosed by their parent (tlas/bvh.rs:62-71). Asserts are the wrong tool
on an accelerator — data-dependent aborts don't exist under jit, and a host round
trip per bounce would serialize the pipeline — so the audit is a set of
*branchless violation counters*: each bounce reduces every invariant to
one lane-mask popcount, the counters ride the fori_loop state, and the
host inspects one tiny [K] vector after the launch. Zero overhead when
off (the checks are simply not traced).

Counter semantics: each entry is the number of (lane, bounce) pairs that
violated the invariant during the launch, summed over bounces. A clean
render reports all zeros; any nonzero is a bug in a kernel, a scene with
degenerate geometry, or numeric blow-up worth investigating — the CLI
prints the table and exits nonzero on violations.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import vecmath as vm

# Fixed category order — the loop carries a [K] f32 vector, keyed here.
AUDIT_KEYS = (
    "nonfinite_radiance",   # accumulated L has a NaN/inf component
    "negative_radiance",    # accumulated L dipped below -1e-5
    "nonfinite_beta",       # path throughput has a NaN/inf component
    "negative_beta",        # throughput component below -1e-5
    "hit_t_out_of_range",   # reported hit with t <= 0 or t > t_max(1+1e-3)
    "hit_normal_not_unit",  # | |n| - 1 | > 2e-3 on a hit lane
    "frame_not_orthonormal",  # TBN fails |t.n|,|t.b|,|b.n| <= 2e-3
    "nonfinite_hit_pos",    # hit position has a NaN/inf component
    "bsdf_pdf_invalid",     # sampled pdf negative or non-finite
    "bsdf_wi_not_unit",     # sampled direction | |wi| - 1 | > 2e-3
    "nonfinite_f",          # sampled BSDF value has a NaN/inf component
    "nonfinite_material",   # shading_at produced NaN/inf lobe params or
                            # emission (NaN here is laundered into dead
                            # lanes by the lobe-selection comparisons — a
                            # silently black image, not a NaN image)
)

_UNIT_TOL = 2e-3
_ORTHO_TOL = 2e-3
_NEG_TOL = -1e-5


def zero_counts():
    return jnp.zeros((len(AUDIT_KEYS),), jnp.float32)


def _count(mask):
    return jnp.sum(mask.astype(jnp.float32))


def _any_nonfinite(x):
    return ~jnp.isfinite(x).all(axis=-1)


def audit_bounce(rays, hit, frame, radiance, beta, f, wi, pdf, alive_in,
                 lobes=None, emit=None):
    """One bounce's violation counts, [K] f32.

    `alive_in`: lanes that were alive entering the bounce (hit-dependent
    checks only fire on lanes whose hit is real: alive & hit.hit).
    `rays` are the bounce's INPUT rays (t_max defines the live extent the
    hit must respect). `f, wi, pdf` are the BSDF sample at the hit.
    """
    hit_lane = alive_in & hit.hit
    t_hi = rays.t_max * (1.0 + 1e-3)
    n_len = vm.length(hit.normal)
    wi_len = vm.length(wi)
    tn = jnp.abs(vm.dot(frame.t, frame.n))
    tb = jnp.abs(vm.dot(frame.t, frame.b))
    bn = jnp.abs(vm.dot(frame.b, frame.n))
    counts = [
        _count(_any_nonfinite(radiance)),
        _count((radiance < _NEG_TOL).any(axis=-1)),
        _count(alive_in & _any_nonfinite(beta)),
        _count(alive_in & (beta < _NEG_TOL).any(axis=-1)),
        _count(hit_lane & ((hit.t <= 0.0) | (hit.t > t_hi))),
        _count(hit_lane & (jnp.abs(n_len - 1.0) > _UNIT_TOL)),
        _count(hit_lane & ((tn > _ORTHO_TOL) | (tb > _ORTHO_TOL)
                           | (bn > _ORTHO_TOL))),
        _count(hit_lane & _any_nonfinite(hit.pos)),
        _count(hit_lane & (~jnp.isfinite(pdf) | (pdf < 0.0))),
        _count(hit_lane & (jnp.abs(wi_len - 1.0) > _UNIT_TOL)),
        _count(hit_lane & _any_nonfinite(f)),
    ]
    bad_mat = jnp.zeros(hit_lane.shape, bool)
    if lobes is not None:
        for field in (lobes.albedo, lobes.specular, lobes.alpha,
                      lobes.eta, lobes.eta_t, lobes.k):
            flat = field.reshape(field.shape[0], -1)
            bad_mat = bad_mat | ~jnp.isfinite(flat).all(axis=-1)
    if emit is not None:
        bad_mat = bad_mat | _any_nonfinite(emit)
    counts.append(_count(hit_lane & bad_mat))
    return jnp.stack(counts)


def report(counts) -> dict:
    """[K] vector -> {key: int} (host side)."""
    import numpy as np

    c = np.asarray(counts)
    return {k: int(c[i]) for i, k in enumerate(AUDIT_KEYS)}


def format_report(rep: dict) -> str:
    total = sum(rep.values())
    lines = [f"debug_checks: {total} violation(s)"]
    for k, v in rep.items():
        mark = "FAIL" if v else "ok"
        lines.append(f"  {mark:4s} {k:24s} {v}")
    return "\n".join(lines)
