"""Material table: materials compiled to per-slot lobe templates.

The reference's `Material::bxdfs_at` allocates a `Vec<BXDF>` per hit behind
a vtable (reference material/src/lib.rs:11-28). Here each material is M rows
of a [M, L] lobe-template table; shading gathers a hit's row and overlays
texture-driven albedos to produce the `Lobes` batch consumed by
`pbrs_jax.bxdf.bsdf`.

Semantics notes (COMPAT.md):
* The reference drops lobes whose texture evaluates to black at the hit
  (material/src/lib.rs:317-364). Lobe counts must be static here, so black
  lobes stay resident: they contribute f=0 and are accounted for in the
  mixture pdf — unbiased, slightly different sampling mix for Uber.
* Substrate builds the real FresnelBlend lobe; the reference ships a
  lambertian fallback with the blend commented out (lib.rs:389-424).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..bxdf import lobes as lb
from ..bxdf import microfacet as mf
from ..bxdf import fresnel as fr
from ..core import gather as gth
from ..textures import textures as tex

MAX_LOBES = 5


def _fourier_mod():
    from ..bxdf import fourier

    return fourier


@struct.dataclass
class MaterialTable:
    kind: jnp.ndarray  # [M,L]
    albedo: jnp.ndarray  # [M,L,3]
    specular: jnp.ndarray  # [M,L,3]
    alpha: jnp.ndarray  # [M,L,2]
    distrib: jnp.ndarray  # [M,L]
    fr_kind: jnp.ndarray  # [M,L]
    eta: jnp.ndarray  # [M,L,2]
    eta_t: jnp.ndarray  # [M,L,3]
    k: jnp.ndarray  # [M,L,3]
    tex_id: jnp.ndarray  # [M,L] int32, -1 = solid albedo
    emission: jnp.ndarray  # [M,3]
    packed: jnp.ndarray  # [M,C] all fields packed for one-shot row lookup
    fourier: object = None  # scene-level FourierTable, if any material uses it
    textured_slots: tuple = struct.field(pytree_node=False, default=())
    layout: tuple = struct.field(pytree_node=False, default=())
    present_kinds: tuple = struct.field(pytree_node=False,
                                        default=lb.ALL_KINDS)

    @property
    def num_materials(self):
        return self.kind.shape[0]


def shading_at(table: MaterialTable, textures: tex.TextureTable, mat_id, uv,
               pos):
    """Instantiate (Lobes, emission) for a hit batch in ONE packed-table
    lookup. mat_id [N], uv [N,2], pos [N,3]. Equivalent of `bxdfs_at` +
    `emission` (material/src/lib.rs:22-26)."""
    safe = jnp.maximum(mat_id, 0)
    rows = gth.lookup_rows(table.packed, safe, table.num_materials)
    (kind, albedo, specular, alpha, distrib, fr_kind, eta, eta_t, k, tex_id,
     emission) = gth.unpack_fields(rows, table.layout)
    # Overlay textures on slots that actually use them (static slot list).
    for slot in table.textured_slots:
        tid = tex_id[:, slot]
        value = tex.eval_texture(textures, tid, uv, pos)
        use = tid >= 0
        albedo = albedo.at[:, slot, :].set(
            jnp.where(use[..., None], value, albedo[:, slot, :])
        )
    hit_ok = mat_id >= 0
    kind = jnp.where(hit_ok[..., None], kind, lb.NONE)
    emission = jnp.where(hit_ok[..., None], emission, 0.0)
    lobes = lb.Lobes(
        kind=kind, albedo=albedo, specular=specular, alpha=alpha,
        distrib=distrib, fr_kind=fr_kind, eta=eta, eta_t=eta_t, k=k,
        fourier=table.fourier, present_kinds=table.present_kinds,
    )
    return lobes, emission


def emission_of(table: MaterialTable, mat_id):
    """Per-hit emission; mat_id < 0 (miss) yields black.
    [ref: material/src/lib.rs:294-296]"""
    safe = jnp.maximum(mat_id, 0)
    rows = gth.lookup_rows(table.packed, safe, table.num_materials)
    e = gth.unpack_fields(rows, table.layout)[-1]
    return jnp.where((mat_id >= 0)[..., None], e, 0.0)


def lobes_at(table: MaterialTable, textures: tex.TextureTable, mat_id, uv, pos
             ) -> lb.Lobes:
    return shading_at(table, textures, mat_id, uv, pos)[0]


class _Lobe:
    def __init__(self, kind, albedo=(0, 0, 0), specular=(0, 0, 0),
                 alpha=(0.0, 0.0), distrib=mf.BECKMANN, fr_kind=fr.NOP,
                 eta=(1.0, 1.5), eta_t=(1, 1, 1), k=(0, 0, 0), tex_id=-1):
        self.kind = kind
        self.albedo = np.asarray(albedo, np.float32)
        self.specular = np.asarray(specular, np.float32)
        self.alpha = np.asarray(alpha, np.float32)
        self.distrib = distrib
        self.fr_kind = fr_kind
        self.eta = np.asarray(eta, np.float32)
        self.eta_t = np.asarray(eta_t, np.float32)
        self.k = np.asarray(k, np.float32)
        self.tex_id = tex_id


class MaterialBuilder:
    """Host-side material compiler; `add_*` returns the material id."""

    def __init__(self):
        self.materials = []  # list[(lobes, emission)]
        self.fourier_tables = []  # one per Fourier material (concat at build)

    def _add(self, lobes, emission=(0, 0, 0)) -> int:
        assert len(lobes) <= MAX_LOBES
        self.materials.append((lobes, np.asarray(emission, np.float32)))
        return len(self.materials) - 1

    # -- reference material set [ref: material/src/lib.rs] ------------------
    def add_lambertian(self, albedo=None, tex_id: int = -1) -> int:
        """[ref: lib.rs:180-184]"""
        return self._add([
            _Lobe(lb.LAMBERT, albedo=albedo if albedo is not None else (0, 0, 0),
                  tex_id=tex_id)
        ])

    def add_matte(self, albedo=None, sigma_deg: float = 0.0, tex_id: int = -1) -> int:
        """PBRT matte: lambertian or Oren-Nayar by sigma.
        [ref: bxdf.rs:528-536 coefficients]"""
        if sigma_deg == 0.0:
            return self.add_lambertian(albedo, tex_id)
        s2 = np.radians(sigma_deg) ** 2
        a = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b = 0.45 * s2 / (s2 + 0.09)
        return self._add([
            _Lobe(lb.OREN_NAYAR, albedo=albedo if albedo is not None else (0, 0, 0),
                  alpha=(a, b), tex_id=tex_id)
        ])

    def add_metal(self, eta, k, fuzz: float) -> int:
        """Conductor microfacet; albedo hard-white per reference.
        [ref: lib.rs:200-206]"""
        alpha = float(mf.roughness_to_alpha(jnp.asarray(fuzz)))
        return self._add([
            _Lobe(lb.MICROFACET, albedo=(1, 1, 1), alpha=(alpha, alpha),
                  distrib=mf.BECKMANN, fr_kind=fr.CONDUCTOR, eta_t=eta, k=k)
        ])

    def add_glossy(self, albedo, roughness: float) -> int:
        """[ref: lib.rs:71-79]"""
        alpha = float(mf.roughness_to_alpha(jnp.asarray(roughness)))
        return self._add([
            _Lobe(lb.MICROFACET, albedo=albedo, alpha=(alpha, alpha),
                  distrib=mf.BECKMANN, fr_kind=fr.NOP)
        ])

    def add_mirror(self, albedo=(1, 1, 1)) -> int:
        """[ref: lib.rs:229-232]"""
        return self._add([_Lobe(lb.SPEC_MIRROR, albedo=albedo, fr_kind=fr.NOP)])

    def add_dielectric(self, ior: float, reflect=(1, 1, 1)) -> int:
        """[ref: lib.rs:265-268]"""
        return self._add([
            _Lobe(lb.SPEC_DIELECTRIC, albedo=reflect, fr_kind=fr.DIELECTRIC,
                  eta=(1.0, ior))
        ])

    def add_fourier(self, table) -> int:
        """Measured Fourier BSDF; every material gets its own table
        (stacked into one multi-table device array at build, see
        fourier.concat_tables). [ref: material/src/lib.rs:451-475]"""
        idx = len(self.fourier_tables)
        self.fourier_tables.append(table)
        # Table index rides in alpha[0] (unused by the Fourier model).
        return self._add([_Lobe(lb.FOURIER, alpha=(float(idx), 0.0))])

    def add_diffuse_light(self, emit) -> int:
        """No lobes; emission only. [ref: lib.rs:291-296]"""
        return self._add([], emission=emit)

    def add_plastic(self, diffuse, specular, roughness: float,
                    remap_roughness: bool = True, kd_tex: int = -1,
                    ks_tex: int = -1) -> int:
        """Microfacet + lambertian. [ref: lib.rs:433-445]"""
        alpha = (
            float(mf.roughness_to_alpha(jnp.asarray(roughness)))
            if remap_roughness else roughness
        )
        return self._add([
            _Lobe(lb.MICROFACET, albedo=specular, alpha=(alpha, alpha),
                  distrib=mf.BECKMANN, fr_kind=fr.NOP, tex_id=ks_tex),
            _Lobe(lb.LAMBERT, albedo=diffuse, tex_id=kd_tex),
        ])

    def add_substrate(self, kd, ks, roughness: float,
                      remap_roughness: bool = True, kd_tex: int = -1) -> int:
        """Real FresnelBlend (reference ships a lambertian stand-in,
        lib.rs:389-424)."""
        alpha = (
            float(mf.roughness_to_alpha(jnp.asarray(roughness)))
            if remap_roughness else roughness
        )
        return self._add([
            _Lobe(lb.FRESNEL_BLEND, albedo=kd, specular=ks,
                  alpha=(alpha, alpha), distrib=mf.TROWBRIDGE_REITZ,
                  tex_id=kd_tex)
        ])

    def add_uber(self, kd, ks, kr=None, kt=None, roughness=0.1, eta=1.5,
                 opacity=1.0, remap_roughness=True, kd_tex=-1, ks_tex=-1) -> int:
        """Up to five lobes. [ref: lib.rs:313-365]"""
        lobes = []
        transmission = max(0.0, min(1.0, 1.0 - opacity))
        if transmission > 0.0:
            lobes.append(_Lobe(lb.SPEC_TRANSMIT, albedo=(transmission,) * 3,
                               fr_kind=fr.DIELECTRIC, eta=(1.0, eta)))
        lobes.append(_Lobe(lb.LAMBERT, albedo=kd, tex_id=kd_tex))
        alpha = (
            float(mf.roughness_to_alpha(jnp.asarray(roughness)))
            if remap_roughness else roughness
        )
        lobes.append(_Lobe(lb.MICROFACET, albedo=ks, alpha=(alpha, alpha),
                           distrib=mf.BECKMANN, fr_kind=fr.DIELECTRIC,
                           eta=(1.0, eta), tex_id=ks_tex))
        if kr is not None:
            lobes.append(_Lobe(lb.SPEC_DIELECTRIC, albedo=kr,
                               fr_kind=fr.DIELECTRIC, eta=(1.0, eta)))
        if kt is not None:
            lobes.append(_Lobe(lb.SPEC_TRANSMIT, albedo=kt,
                               fr_kind=fr.DIELECTRIC, eta=(1.0, eta)))
        return self._add(lobes)

    # -- build ---------------------------------------------------------------
    def build(self) -> MaterialTable:
        mats = self.materials or [([], np.zeros(3, np.float32))]
        m = len(mats)
        # Trim the lobe axis to the widest material actually present: the
        # per-slot dispatch in bsdf.sample/eval is O(L), so a single-lobe
        # scene (e.g. Cornell) pays for exactly one slot.
        n_lobes = max(1, max(len(lobe_list) for lobe_list, _ in mats))
        shape2 = (m, n_lobes)
        kind = np.zeros(shape2, np.int32)
        albedo = np.zeros(shape2 + (3,), np.float32)
        specular = np.zeros(shape2 + (3,), np.float32)
        alpha = np.zeros(shape2 + (2,), np.float32)
        distrib = np.zeros(shape2, np.int32)
        fr_kind = np.zeros(shape2, np.int32)
        eta = np.tile(np.asarray([1.0, 1.5], np.float32), shape2 + (1,))
        eta_t = np.ones(shape2 + (3,), np.float32)
        kk = np.zeros(shape2 + (3,), np.float32)
        tex_id = np.full(shape2, -1, np.int32)
        emission = np.zeros((m, 3), np.float32)
        textured = set()
        for i, (lobe_list, emit) in enumerate(mats):
            emission[i] = emit
            for l, lobe in enumerate(lobe_list):
                kind[i, l] = lobe.kind
                albedo[i, l] = lobe.albedo
                specular[i, l] = lobe.specular
                alpha[i, l] = lobe.alpha
                distrib[i, l] = lobe.distrib
                fr_kind[i, l] = lobe.fr_kind
                eta[i, l] = lobe.eta
                eta_t[i, l] = lobe.eta_t
                kk[i, l] = lobe.k
                tex_id[i, l] = lobe.tex_id
                if lobe.tex_id >= 0:
                    textured.add(l)
        packed, layout = gth.pack_fields([
            kind, albedo, specular, alpha, distrib, fr_kind, eta, eta_t, kk,
            tex_id, emission,
        ])
        layout = tuple(
            (off, tuple(shape), np.dtype(dt).name) for off, shape, dt in layout
        )
        return MaterialTable(
            kind=jnp.asarray(kind), albedo=jnp.asarray(albedo),
            specular=jnp.asarray(specular), alpha=jnp.asarray(alpha),
            distrib=jnp.asarray(distrib), fr_kind=jnp.asarray(fr_kind),
            eta=jnp.asarray(eta), eta_t=jnp.asarray(eta_t), k=jnp.asarray(kk),
            tex_id=jnp.asarray(tex_id), emission=jnp.asarray(emission),
            packed=jnp.asarray(packed),
            fourier=(None if not self.fourier_tables else
                     _fourier_mod().concat_tables(self.fourier_tables)),
            textured_slots=tuple(sorted(textured)),
            layout=layout,
            present_kinds=tuple(sorted(
                {l.kind for ll, _ in mats for l in ll}
            )),
        )
