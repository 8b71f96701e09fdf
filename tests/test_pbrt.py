"""PBRT parser/loader, PLY reader, and loop subdivision tests."""

import struct

import numpy as np
import jax.numpy as jnp
import pytest

from pbrs_jax.scene import ply as ply_mod
from pbrs_jax.scene import subdivision
from pbrs_jax.scene.pbrt import loader as pbrt_loader
from pbrs_jax.scene.pbrt import parser as pbrt_parser
from pbrs_jax.scene.pbrt import tokenizer

CORNELL_PBRT = """
# cornell-style test scene
LookAt 278 278 -800   278 278 0   0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "random" "integer pixelsamples" [4]
Integrator "path"

WorldBegin

MakeNamedMaterial "white" "string type" "matte" "rgb Kd" [.73 .73 .73]

AttributeBegin
  AreaLightSource "diffuse" "L" [15 15 15]
  Shape "trianglemesh" "point P" [213 554 227  343 554 227  343 554 332  213 554 332]
        "integer indices" [0 1 2  0 2 3]
AttributeEnd

AttributeBegin
  Material "matte" "rgb Kd" [.65 .05 .05]
  Shape "trianglemesh" "point P" [0 0 0  0 555 0  0 555 555  0 0 555]
        "integer indices" [0 1 2  0 2 3]
AttributeEnd

NamedMaterial "white"
Shape "trianglemesh" "point P" [0 0 0  555 0 0  555 0 555  0 0 555]
      "integer indices" [0 1 2  0 2 3]

AttributeBegin
  Translate 200 100 200
  Material "glass" "float eta" [1.5]
  Shape "sphere" "float radius" [80]
AttributeEnd

LightSource "point" "point from" [278 500 100] "rgb I" [100 100 100]

WorldEnd
"""


def test_tokenizer_basics():
    toks = tokenizer.tokenize_string('Shape "sphere" "float radius" [1.5] # c')
    kinds = [t.kind for t in toks]
    assert kinds == ["word", "string", "string", "lbracket", "number",
                     "rbracket"]
    assert toks[-2].value == 1.5


def test_parser_ast():
    toks = tokenizer.tokenize_string(CORNELL_PBRT)
    options, items = pbrt_parser.parse_tokens(toks)
    tags = [o[0] for o in options]
    assert "camera" in tags and "film" in tags and "transform" in tags
    item_tags = [i[0] for i in items]
    assert item_tags.count("attribute") == 3
    assert "make_material" in item_tags
    assert "light" in item_tags


def test_loader_builds_scene(tmp_path):
    path = tmp_path / "scene.pbrt"
    path.write_text(CORNELL_PBRT)
    scene = pbrt_loader.build_scene(str(path))
    assert scene.camera.width == 32 and scene.camera.height == 32
    # 2 light triangles + 2 red + 2 white tris + 1 sphere
    assert scene.geom.tri_p0.shape[0] == 6
    assert scene.geom.sph_center.shape[0] == 1
    # Sphere translated to (200,100,200).
    np.testing.assert_allclose(
        np.asarray(scene.geom.sph_center[0]), [200, 100, 200], atol=1e-4
    )
    assert scene.area_lights.count == 2  # two light triangles
    assert scene.delta_lights.count == 1
    assert scene.num_lights == 3


def test_loader_end_to_end_render(tmp_path):
    import jax
    from pbrs_jax.core import sampler as smp
    from pbrs_jax.integrators import wavefront

    path = tmp_path / "scene.pbrt"
    path.write_text(CORNELL_PBRT)
    scene = pbrt_loader.build_scene(str(path))
    sampler = smp.PCGSampler(0)
    pix = jnp.arange(32 * 32)
    fn = jax.jit(lambda s: wavefront.render_samples(
        scene, sampler, pix, s, max_depth=4, msaa=2))
    img = np.asarray(fn(0)).reshape(32, 32, 3)
    assert not np.isnan(img).any()
    assert img.mean() > 0.01  # light reaches the film


def test_pbrt_rotate_negated_compat(tmp_path):
    """pbrt-v3 Rotate compatibility: angle is negated.
    [ref: scene/src/loader.rs:786-802]"""
    src = """
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte" "rgb Kd" [1 0 0]
AttributeBegin
  Rotate 90 0 0 1
  Translate 1 0 0
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""
    path = tmp_path / "rot.pbrt"
    path.write_text(src)
    scene = pbrt_loader.build_scene(str(path))
    center = np.asarray(scene.geom.sph_center[0])
    # Rotate(90, z) then translate(1,0,0): pbrt-v3-compat rotation is the
    # INVERSE, so the point lands at (0,-1,0) instead of (0,1,0).
    np.testing.assert_allclose(center, [0, -1, 0], atol=1e-5)


def test_object_instancing(tmp_path):
    src = """
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte" "rgb Kd" [1 1 1]
ObjectBegin "ball"
  Shape "sphere" "float radius" [1]
ObjectEnd
AttributeBegin
  Translate 5 0 0
  ObjectInstance "ball"
AttributeEnd
AttributeBegin
  Translate 0 7 0
  ObjectInstance "ball"
AttributeEnd
WorldEnd
"""
    path = tmp_path / "obj.pbrt"
    path.write_text(src)
    scene = pbrt_loader.build_scene(str(path))
    # ObjectInstance builds a trace-time instance group: one master sphere
    # stored once + two transforms (round-2: replaces geometry replay).
    assert len(scene.instanced) == 1
    grp = scene.instanced[0]
    assert grp.geom.sph_center.shape[0] == 1
    assert grp.fwd.shape[0] == 2
    got = {tuple(np.asarray(f)[:, 3].round(4)) for f in grp.fwd}
    assert (5.0, 0.0, 0.0) in got and (0.0, 7.0, 0.0) in got


def test_include(tmp_path):
    (tmp_path / "mat.pbrt").write_text('Material "matte" "rgb Kd" [0 1 0]\n')
    src = """
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Include "mat.pbrt"
Shape "sphere" "float radius" [2]
WorldEnd
"""
    path = tmp_path / "main.pbrt"
    path.write_text(src)
    scene = pbrt_loader.build_scene(str(path))
    assert scene.geom.sph_radius[0] == 2.0


def _write_binary_ply(path, positions, faces, normals=None):
    n = len(positions)
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        for i, p in enumerate(positions):
            row = list(p) + (list(normals[i]) if normals is not None else [])
            f.write(struct.pack(f"<{len(row)}f", *row))
        for face in faces:
            f.write(struct.pack(f"<B{len(face)}i", len(face), *face))


def test_ply_binary_with_quad_fan(tmp_path):
    path = str(tmp_path / "mesh.ply")
    pts = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)]
    _write_binary_ply(path, pts, [(0, 1, 2, 3)])
    pos, nrm, uv, idx = ply_mod.load_ply(path)
    assert pos.shape == (4, 3)
    assert idx.shape == (2, 3)  # quad fan-triangulated
    np.testing.assert_allclose(np.abs(nrm[:, 2]), 1.0, atol=1e-5)


def test_ply_ascii(tmp_path):
    path = tmp_path / "mesh.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n"
    )
    pos, nrm, uv, idx = ply_mod.load_ply(str(path))
    assert pos.shape == (3, 3) and idx.shape == (1, 3)


def test_loop_subdivision_counts_and_limit():
    # Octahedron -> subdivide: V'=V+E=6+12=18, F'=4F=32.
    pos = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    idx = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64
    )
    p1, i1 = subdivision.loop_subdivide(pos, idx, 1)
    assert p1.shape[0] == 18 and i1.shape[0] == 32
    # Repeated subdivision converges toward a smooth (spherish) surface:
    # radius variance shrinks.
    p3, i3 = subdivision.loop_subdivide(pos, idx, 3)
    r = np.linalg.norm(p3, axis=1)
    assert r.std() < 0.05
    assert 0.4 < r.mean() < 1.0


def test_subdivision_preserves_boundary_square():
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    p1, i1 = subdivision.loop_subdivide(pos, idx, 1)
    assert np.allclose(p1[:, 2], 0.0)  # planar stays planar
    assert i1.shape[0] == 8
