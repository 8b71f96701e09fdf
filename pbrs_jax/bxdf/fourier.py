"""Fourier-basis measured BSDF (layerlab "SCATFUN" format).

[ref: geometry/src/fourier.rs] — the isotropic Spline×Fourier BSDF of
Jakob et al. 2014. Host side parses the binary table and pads the
variable-length a_k coefficient runs into a dense [n_mu², C, M] array
(the reference walks ragged runs through `a_offset`/`m_lookup`,
fourier.rs:160-165 — ragged indirection doesn't vectorize).

Device side:
* `eval`  — Catmull-Rom weights over both zenith grids, 16-pair weighted
  coefficient mix (linearity of the Fourier sum lets the mix happen in
  coefficient space), Chebyshev-recurrence cosine series.
* `pdf`   — luminance series over the per-μo CDF total (fourier.rs:445-485).
* `sample`— inverse-CDF zenith sampling over the tabulated a0 marginal +
  bounded Newton-bisection azimuth sampling (fourier.rs:245-297) as a
  fixed-iteration fori_loop.

The coefficient order is capped at M_CAP (static); tables with longer runs
are truncated with an energy warning (`truncation_energy_ratio` quantifies
the dropped tail; tests/test_fourier.py bounds the induced eval error).

Multiple tables per scene (the reference gives each Fourier material its
own table, material/src/lib.rs:451-475) are supported by stacking tables
along the row axis (`concat_tables`): cdf/a0/m_lookup become
[T*n_mu, n_mu], a_dense [T*n_mu², C, M], and every eval/pdf/sample takes a
per-lane `table_idx` that offsets the pair index — same code path, zero
cost for single-table scenes.
"""

from __future__ import annotations

import struct

import numpy as np
import jax
import jax.numpy as jnp
from ..core import struct as fstruct

from ..core import spline as spl

M_CAP = 128


@fstruct.dataclass
class FourierTable:
    mu: jnp.ndarray  # [n_mu]
    cdf: jnp.ndarray  # [n_mu, n_mu] row = o index, col = i index
    a0: jnp.ndarray  # [n_mu, n_mu] order-0 luminance coefficient
    a_dense: jnp.ndarray  # [n_mu*n_mu, C, M] padded coefficients
    m_lookup: jnp.ndarray  # [n_mu, n_mu] i32 series length
    eta: float = fstruct.field(pytree_node=False, default=1.0)
    n_channels: int = fstruct.field(pytree_node=False, default=3)
    m_cap: int = fstruct.field(pytree_node=False, default=M_CAP)
    n_tables: int = fstruct.field(pytree_node=False, default=1)


def load_scatfun(path: str) -> FourierTable:
    """Parse a layerlab .bsdf file. [ref: geometry/src/fourier.rs:54-96,
    166-216]"""
    with open(path, "rb") as f:
        raw = f.read()
    ident = raw[:7]
    assert ident == b"SCATFUN", "not a SCATFUN file"
    version, flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack(
        "<BIiiiii", raw[7:7 + 1 + 4 * 6]
    )
    assert version == 1 and flags == 1, (version, flags)
    (_n_meta, _n_par, _n_parv, eta, _a0, _a1, _u0, _u1) = struct.unpack(
        "<iiifffff", raw[32:64]
    )
    off = 64
    mu = np.frombuffer(raw, "<f4", n_mu, off); off += 4 * n_mu
    cdf = np.frombuffer(raw, "<f4", n_mu * n_mu, off); off += 4 * n_mu * n_mu
    ol = np.frombuffer(raw, "<i4", n_mu * n_mu * 2, off)
    off += 4 * n_mu * n_mu * 2
    a = np.frombuffer(raw, "<f4", n_coeffs, off)
    a_offset = ol[0::2]
    m_lookup = ol[1::2]
    return build_table(
        n_channels, mu, cdf.reshape(n_mu, n_mu), a_offset, m_lookup, a,
        eta=eta,
    )


def build_table(n_channels, mu, cdf, a_offset, m_lookup, coefficients,
                eta=1.0, m_cap=M_CAP) -> FourierTable:
    """Dense-pad the ragged coefficient runs. [ref: fourier.rs:116-149]"""
    mu = np.asarray(mu, np.float32)
    n_mu = mu.shape[0]
    cdf = np.asarray(cdf, np.float32).reshape(n_mu, n_mu)
    a_offset = np.asarray(a_offset, np.int64).reshape(-1)
    m_lookup = np.asarray(m_lookup, np.int64).reshape(-1)
    coefficients = np.asarray(coefficients, np.float32)
    m_cap = int(min(m_cap, max(1, m_lookup.max())))

    a_dense = np.zeros((n_mu * n_mu, n_channels, m_cap), np.float32)
    a0 = np.zeros(n_mu * n_mu, np.float32)
    for idx in range(n_mu * n_mu):
        m = int(m_lookup[idx])
        if m == 0:
            continue
        start = int(a_offset[idx])
        run = coefficients[start:start + m * n_channels].reshape(
            n_channels, m
        )
        keep = min(m, m_cap)
        a_dense[idx, :, :keep] = run[:, :keep]
        a0[idx] = run[0, 0]
    return FourierTable(
        mu=jnp.asarray(mu),
        cdf=jnp.asarray(cdf),
        a0=jnp.asarray(a0.reshape(n_mu, n_mu)),
        a_dense=jnp.asarray(a_dense),
        m_lookup=jnp.asarray(
            np.minimum(m_lookup, m_cap).reshape(n_mu, n_mu).astype(np.int32)
        ),
        eta=float(eta),
        n_channels=int(n_channels),
        m_cap=m_cap,
    )


def make_lambert_table(albedo=0.5, n_mu=16) -> FourierTable:
    """Synthetic table for a Lambertian BRDF: the stored function is
    f·|μi| = (ρ/π)·|μi| with a single order-0 coefficient. Used by tests
    (the reference's .bsdf assets are absent from its repo, SURVEY §4)."""
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    n = n_mu
    a0 = np.zeros((n, n), np.float32)
    for o in range(n):
        for i in range(n):
            # reflection only: mu_i (incident, stored as -wi.z) < 0 means wi
            # above the surface when wo above; table convention: mu_i grid
            # value is cos of incident zenith = -wi.z.
            if mu[o] > 0 and mu[i] < 0:
                a0[o, i] = albedo / np.pi * abs(mu[i])
    # CDF over mu_i for each mu_o row: cdf[o,i] = ∫ 2π a0 dmu (unnormalized,
    # matching the reference's use of the last column as total, fourier.rs
    # prob: rho = cdf[o, n-1] * 2π).
    cdf = np.zeros((n, n), np.float32)
    for o in range(n):
        acc = 0.0
        for i in range(1, n):
            acc += 0.5 * (a0[o, i] + a0[o, i - 1]) * (mu[i] - mu[i - 1])
            cdf[o, i] = acc
    m_lookup = (a0 > 0).astype(np.int64).reshape(-1)
    a_offset = np.arange(n * n, dtype=np.int64) * 3
    coeffs = np.zeros(n * n * 3, np.float32)
    # channel layout per run: [y..., r..., b...] with m=1
    coeffs[0::3] = a0.reshape(-1)
    coeffs[1::3] = a0.reshape(-1)  # r
    coeffs[2::3] = a0.reshape(-1)  # b
    return build_table(3, mu, cdf, a_offset, m_lookup, coeffs)


def truncation_energy_ratio(m_lookup, a_offset, coefficients, n_channels,
                            m_cap=M_CAP) -> float:
    """Fraction of summed |a_k| (luminance channel) dropped by capping the
    series at m_cap — the quantity the build warning reports. 0.0 means the
    cap is lossless for this table."""
    m_lookup = np.asarray(m_lookup, np.int64).reshape(-1)
    a_offset = np.asarray(a_offset, np.int64).reshape(-1)
    coefficients = np.asarray(coefficients, np.float32)
    kept = 0.0
    dropped = 0.0
    for idx in range(m_lookup.shape[0]):
        m = int(m_lookup[idx])
        if m == 0:
            continue
        start = int(a_offset[idx])
        y_run = np.abs(coefficients[start:start + m])  # channel 0 slice
        kept += float(y_run[:m_cap].sum())
        dropped += float(y_run[m_cap:].sum())
    total = kept + dropped
    return dropped / total if total > 0 else 0.0


def concat_tables(tables) -> FourierTable:
    """Stack several FourierTables into one multi-table FourierTable.

    Requires identical mu grids (layerlab emits the standard grid; a
    mismatch raises). m_cap pads to the max; 1-channel tables replicate the
    luminance run into the r/b channels (g then reconstructs to y within
    1e-6 via the rgb matrix). [ref: material/src/lib.rs:451-475 — one table
    per Fourier material]"""
    if len(tables) == 1:
        return tables[0]
    mu0 = np.asarray(tables[0].mu)
    n_mu = mu0.shape[0]
    for t in tables[1:]:
        if np.asarray(t.mu).shape != mu0.shape or not np.allclose(
                np.asarray(t.mu), mu0, atol=1e-6):
            raise ValueError(
                "fourier tables with differing mu grids cannot share a "
                "scene; resample offline")
    m_cap = max(t.m_cap for t in tables)
    n_ch = max(t.n_channels for t in tables)
    cdfs, a0s, denses, lookups = [], [], [], []
    for t in tables:
        cdfs.append(np.asarray(t.cdf))
        a0s.append(np.asarray(t.a0))
        lookups.append(np.asarray(t.m_lookup))
        d = np.asarray(t.a_dense)
        if t.n_channels < n_ch:
            d = np.repeat(d, n_ch, axis=1)[:, :n_ch]
        if t.m_cap < m_cap:
            d = np.pad(d, ((0, 0), (0, 0), (0, m_cap - t.m_cap)))
        denses.append(d)
    return FourierTable(
        mu=jnp.asarray(mu0),
        cdf=jnp.asarray(np.concatenate(cdfs, axis=0)),
        a0=jnp.asarray(np.concatenate(a0s, axis=0)),
        a_dense=jnp.asarray(np.concatenate(denses, axis=0)),
        m_lookup=jnp.asarray(np.concatenate(lookups, axis=0)),
        eta=tables[0].eta,
        n_channels=n_ch,
        m_cap=m_cap,
        n_tables=len(tables),
    )


# ------------------------------ device math --------------------------------


def _cos_dphi(wo, wi_neg):
    """cos of azimuth difference. [ref: geometry/src/bxdf.rs:96-107]"""
    x0, y0 = wo[..., 0], wo[..., 1]
    x1, y1 = wi_neg[..., 0], wi_neg[..., 1]
    denom = jnp.sqrt((x0 * x0 + y0 * y0) * (x1 * x1 + y1 * y1))
    r = (x0 * x1 + y0 * y1) / jnp.where(denom == 0.0, 1.0, denom)
    r = jnp.where(denom == 0.0, 0.0, r)
    return jnp.clip(r, -1.0, 1.0)


def _tidx(table, table_idx, like):
    if table.n_tables == 1 or table_idx is None:
        return jnp.zeros(jnp.shape(like), jnp.int32)
    return jnp.clip(jnp.asarray(table_idx, jnp.int32), 0, table.n_tables - 1)


def _mix_coefficients(table: FourierTable, mu_i, mu_o, table_idx=None):
    """Catmull-Rom-weighted 16-pair coefficient mix.
    Returns ak [N, C, M] and valid mask. [ref: fourier.rs:327-346]"""
    n_mu = table.mu.shape[0]
    off_i, w_i = spl.catmull_rom_weights(table.mu, mu_i)
    off_o, w_o = spl.catmull_rom_weights(table.mu, mu_o)
    taps_i = spl.catmull_rom_taps(table.mu, off_i)  # [N,4]
    taps_o = spl.catmull_rom_taps(table.mu, off_o)
    # pair weights [N,4,4] and flat pair indices [N,4,4]
    w = w_o[..., :, None] * w_i[..., None, :]
    pair = taps_o[..., :, None] * n_mu + taps_i[..., None, :]
    flat_pair = pair.reshape(pair.shape[0], 16)
    tid = _tidx(table, table_idx, mu_i)
    flat_pair = flat_pair + (tid * n_mu * n_mu)[..., None]
    flat_w = w.reshape(w.shape[0], 16)
    rows = table.a_dense[flat_pair]  # [N,16,C,M] gather
    ak = jnp.einsum("np,npcm->ncm", flat_w, rows)
    valid = (mu_i >= table.mu[0]) & (mu_i <= table.mu[-1]) & (
        mu_o >= table.mu[0]
    ) & (mu_o <= table.mu[-1])
    return ak, valid, (off_o, w_o, taps_o)


def _cos_basis(cos_phi, m):
    """cos(k φ) for k in [0, m) via Chebyshev recurrence.
    [ref: fourier.rs:224-236]"""
    def step(carry, _):
        prev, cur = carry
        nxt = 2.0 * cos_phi * cur - prev
        return (cur, nxt), cur

    (_, _), ks = jax.lax.scan(
        step, (cos_phi, jnp.ones_like(cos_phi)), None, length=m
    )
    return jnp.moveaxis(ks, 0, -1)  # [N, m]: k=0 -> 1, k=1 -> cos_phi, ...


def _series(ak, basis):
    """Σ_k ak[...,k] basis[...,k]."""
    return jnp.sum(ak * basis[..., None, :], axis=-1)  # [N, C]


def _rgb_from_channels(y, r, b, scale):
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    rgb = jnp.stack([r, g, b], axis=-1) * scale[..., None]
    return jnp.clip(rgb, 0.0, None)


def eval_fourier(table: FourierTable, wo, wi, table_idx=None):
    """f(wo, wi) [N,3]. [ref: fourier.rs:299-360]"""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    cos_phi = _cos_dphi(wo, -wi)
    ak, valid, _ = _mix_coefficients(table, mu_i, mu_o, table_idx)
    basis = _cos_basis(cos_phi, table.m_cap)
    vals = _series(ak, basis)  # [N, C]
    scale = jnp.where(mu_i != 0.0, 1.0 / jnp.abs(mu_i), 0.0)
    if table.n_channels == 1:
        y = jnp.maximum(vals[..., 0], 0.0) * scale
        rgb = jnp.stack([y, y, y], axis=-1)
    else:
        y = jnp.maximum(vals[..., 0], 0.0)
        rgb = _rgb_from_channels(y, vals[..., 1], vals[..., 2], scale)
    return jnp.where(valid[..., None], rgb, 0.0)


def pdf_fourier(table: FourierTable, wo, wi, table_idx=None):
    """Sampling density of wi. [ref: fourier.rs:445-485]"""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    cos_phi = _cos_dphi(wo, -wi)
    ak, valid, (off_o, w_o, taps_o) = _mix_coefficients(
        table, mu_i, mu_o, table_idx)
    basis = _cos_basis(cos_phi, table.m_cap)
    y = jnp.maximum(_series(ak, basis)[..., 0], 0.0)
    # rho = Σ_o w_o · cdf[tap_o, last] · 2π
    n_mu = table.mu.shape[0]
    tid = _tidx(table, table_idx, mu_i)
    last = table.cdf[:, -1]
    rho = jnp.sum(w_o * last[tid[..., None] * n_mu + taps_o],
                  axis=-1) * 2.0 * jnp.pi
    pdf = jnp.where(rho > 0.0, y / jnp.where(rho > 0.0, rho, 1.0), 0.0)
    return jnp.where(valid, pdf, 0.0)


def _sample_zenith(table: FourierTable, mu_o, v, table_idx=None):
    """Inverse-CDF sample of mu_i from the tabulated marginal for each μo
    (piecewise-linear approximation of the reference's
    sample_catmull_rom_2d, math/src/spline.rs:240-310).
    Returns (mu_i, pdf_mu)."""
    n_mu = table.mu.shape[0]
    off_o, w_o = spl.catmull_rom_weights(table.mu, mu_o)
    taps_o = spl.catmull_rom_taps(table.mu, off_o)
    tid = _tidx(table, table_idx, mu_o)
    taps_o = tid[..., None] * n_mu + taps_o
    # Interpolated CDF row and marginal (a0) row for this μo.
    cdf_row = jnp.einsum("nk,nki->ni", w_o, table.cdf[taps_o])  # [N, n_mu]
    a0_row = jnp.einsum("nk,nki->ni", w_o, table.a0[taps_o])
    total = cdf_row[:, -1]
    target = v * total
    # Find segment: largest i with cdf_row[i] <= target.
    below = (cdf_row <= target[:, None]).astype(jnp.int32)
    seg = jnp.clip(jnp.sum(below, axis=1) - 1, 0, n_mu - 2)
    take = lambda arr, i: jnp.take_along_axis(arr, i[:, None], axis=1)[:, 0]
    c0 = take(cdf_row, seg)
    c1 = take(cdf_row, seg + 1)
    f0 = take(a0_row, seg)
    f1 = take(a0_row, seg + 1)
    mu0 = table.mu[seg]
    mu1 = table.mu[seg + 1]
    dc = jnp.where(c1 > c0, c1 - c0, 1.0)
    t = jnp.clip((target - c0) / dc, 0.0, 1.0)
    mu_i = mu0 + t * (mu1 - mu0)
    f_mu = f0 + t * (f1 - f0)
    pdf = jnp.where(total > 0.0, f_mu / jnp.where(total > 0.0, total, 1.0),
                    0.0)
    return mu_i, jnp.maximum(pdf, 0.0)


def _sample_azimuth(ak_y, u, m_cap, iters=24):
    """Invert the azimuth CDF F(φ) ∝ ∫ Σ a_k cos(kφ): Newton-bisection with
    a fixed iteration budget. Returns (f(φ), φ, pdf). ak_y: [N, M].
    [ref: fourier.rs:245-297]"""
    flip = u >= 0.5
    u = jnp.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    ks = jnp.arange(m_cap, dtype=jnp.float32)
    recip = jnp.where(ks > 0, 1.0 / jnp.where(ks > 0, ks, 1.0), 0.0)
    a0 = ak_y[:, 0]

    def f_and_int(phi):
        kphi = phi[:, None] * ks[None, :]
        f = jnp.sum(ak_y * jnp.cos(kphi), axis=1)
        integral = a0 * phi + jnp.sum(
            ak_y * recip[None, :] * jnp.sin(kphi), axis=1
        )
        return f, integral

    def body(_, state):
        left, right, phi = state
        f, integral = f_and_int(phi)
        err = integral - u * a0 * jnp.pi
        right = jnp.where(err > 0.0, phi, right)
        left = jnp.where(err > 0.0, left, phi)
        newton = phi - err / jnp.where(f != 0.0, f, 1.0)
        ok = (newton > left) & (newton < right) & (f != 0.0)
        phi = jnp.where(ok, newton, 0.5 * (left + right))
        return left, right, phi

    n = ak_y.shape[0]
    init = (jnp.zeros(n), jnp.full(n, jnp.pi), jnp.full(n, 0.5 * jnp.pi))
    _, _, phi = jax.lax.fori_loop(0, iters, body, init)
    f, _ = f_and_int(phi)
    phi = jnp.where(flip, 2.0 * jnp.pi - phi, phi)
    pdf = jnp.where(a0 > 0.0, f / (2.0 * jnp.pi * jnp.where(a0 > 0, a0, 1.0)),
                    0.0)
    return f, phi, jnp.maximum(pdf, 0.0)


def sample_fourier_bsdf(table: FourierTable, wo, u2, table_idx=None):
    """Sample wi. Returns (f [N,3], wi [N,3], pdf [N]).
    [ref: fourier.rs:362-442]"""
    u, v = u2[..., 0], u2[..., 1]
    mu_o = wo[..., 2]
    mu_i, pdf_mu = _sample_zenith(table, mu_o, v, table_idx)
    ak, valid, _ = _mix_coefficients(table, mu_i, mu_o, table_idx)
    y_f, phi, pdf_phi = _sample_azimuth(ak[:, 0, :], u, table.m_cap)
    pdf = jnp.maximum(pdf_phi * pdf_mu, 0.0)

    sin2_i = jnp.maximum(1.0 - mu_i * mu_i, 0.0)
    sin2_o = jnp.maximum(1.0 - mu_o * mu_o, 0.0)
    norm = jnp.sqrt(sin2_i / jnp.where(sin2_o == 0.0, 1.0, sin2_o))
    norm = jnp.where(sin2_o == 0.0, 0.0, norm)
    sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
    wix = norm * (cos_phi * wo[..., 0] - sin_phi * wo[..., 1])
    wiy = norm * (sin_phi * wo[..., 0] + cos_phi * wo[..., 1])
    wi = -jnp.stack([wix, wiy, mu_i], axis=-1)
    nlen = jnp.sqrt(jnp.sum(wi * wi, axis=-1, keepdims=True))
    wi = wi / jnp.where(nlen == 0.0, 1.0, nlen)

    scale = jnp.where(mu_i != 0.0, 1.0 / jnp.abs(mu_i), 0.0)
    basis = _cos_basis(cos_phi, table.m_cap)
    vals = _series(ak, basis)
    if table.n_channels == 1:
        yv = jnp.maximum(vals[..., 0], 0.0) * scale
        f = jnp.stack([yv, yv, yv], axis=-1)
    else:
        f = _rgb_from_channels(
            jnp.maximum(vals[..., 0], 0.0), vals[..., 1], vals[..., 2], scale
        )
    f = jnp.where(valid[..., None], f, 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return f, wi, pdf
