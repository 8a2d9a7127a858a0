"""The port's scene loaders (rayverb_tpu_torch/scene: dxfloader, stlply,
gltf and load_mesh's dispatch) against the JAX package's on the same files:
the demo corpus's DXF rooms, and STL, PLY, glTF, GLB and OFF files written
here as tests/test_scene.py writes them. The meshes must be equal (vertices
bit for bit, faces, material names); one small render of room1.dxf is held
to the JAX package's within -60 dB of peak."""

import base64
import json
import struct

import numpy as np
import pytest

from rayverb_tpu import load_scene as jax_load_scene
from rayverb_tpu.config.schema import parse_config as jax_parse_config
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.scene import objloader as jax_objloader
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch.config.schema import parse_config as port_parse_config
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.scene import compile as port_compile
from rayverb_tpu_torch.scene import objloader as port_objloader

SQUARE = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)


def _assert_same_mesh(path):
    want = jax_objloader.load_mesh(str(path))
    got = port_objloader.load_mesh(str(path))
    assert got.vertices.dtype == want.vertices.dtype
    assert got.vertices.tobytes() == want.vertices.tobytes()
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.dtype == want.faces.dtype
    assert got.face_materials == want.face_materials
    assert got.num_triangles > 0
    return got


@pytest.mark.parametrize("room", ["room1", "room2", "room3"])
def test_dxf_rooms_match_jax(assets_dir, room):
    """The demo corpus's DXF rooms (3DFACE quads and triangles, layer names
    as materials), and their compiled scenes with mat.json."""
    path = assets_dir / "test_models" / f"{room}.dxf"
    mesh = _assert_same_mesh(path)
    assert len(set(mesh.face_materials)) > 1
    mat = str(assets_dir / "materials" / "mat.json")
    want = jax_load_scene(str(path), mat)
    got = port_compile.load_scene(str(path), mat)
    assert got.num_triangles == want.num_triangles
    for field in ("tri_verts", "tri_surface", "specular", "diffuse"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(np.asarray(got.bounds), np.asarray(want.bounds))


def _write_binary_stl(path, tris):
    tris = np.asarray(tris, np.float32)
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            fh.write(struct.pack("<3f", 0, 0, 0))  # normal (ignored)
            for v in t:
                fh.write(struct.pack("<3f", *v))
            fh.write(struct.pack("<H", 0))


def _write_ascii_stl(path, tris):
    lines = ["solid synthetic"]
    for t in tris:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {v[0]} {v[1]} {v[2]}" for v in t]
        lines += ["endloop", "endfacet"]
    path.write_text("\n".join(lines + ["endsolid synthetic"]) + "\n")


_PLY_HEADER = (
    "element vertex 4\n"
    "property float x\nproperty float y\nproperty float z\n"
    "property uchar red\n"
    "element face 1\n"
    "property uchar flags\n"
    "property list uchar int vertex_indices\n"
    "end_header\n"
)


def _write_ascii_ply(path):
    path.write_text(
        "ply\nformat ascii 1.0\ncomment synthetic\n" + _PLY_HEADER
        + "".join(f"{x} {y} {z} 255\n" for x, y, z in SQUARE) + "7 4 0 1 2 3\n"
    )


def _write_binary_ply(path):
    body = b"".join(struct.pack("<3fB", *map(float, v), 255) for v in SQUARE)
    body += struct.pack("<BB4i", 7, 4, 0, 1, 2, 3)
    path.write_bytes(("ply\nformat binary_little_endian 1.0\n" + _PLY_HEADER).encode() + body)


def _glb_bytes(doc: dict, bin_chunk: bytes) -> bytes:
    """A glTF 2.0 GLB container (JSON + BIN chunks, 4-byte aligned)."""
    j = json.dumps(doc).encode("utf-8")
    j += b" " * ((4 - len(j) % 4) % 4)
    b = bin_chunk + b"\0" * ((4 - len(bin_chunk) % 4) % 4)
    return (b"glTF" + struct.pack("<II", 2, 12 + 8 + len(j) + 8 + len(b))
            + struct.pack("<II", len(j), 0x4E4F534A) + j
            + struct.pack("<II", len(b), 0x004E4942) + b)


def _write_glb(path):
    """u16-indexed TRIANGLES under a rotated and translated node, with a
    named material."""
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = SQUARE.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [5.0, 0.0, 0.0],
                   "rotation": [0.0, 0.0, 0.7071067811865476, 0.7071067811865476]}],
        "materials": [{"name": "brick"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                    "material": 0}]}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    path.write_bytes(_glb_bytes(doc, blob))


def _write_gltf_data_uri(path):
    """A base64 data: buffer drawn as a TRIANGLE_STRIP and a TRIANGLE_FAN."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    blob = verts.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0}, {"mesh": 1}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "mode": 5}]},
                   {"primitives": [{"attributes": {"POSITION": 0}, "mode": 6}]}],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode("ascii")}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(blob)}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 4,
                       "type": "VEC3"}],
    }
    path.write_text(json.dumps(doc))


def _write_off(path):
    path.write_text("OFF\n# synthetic\n4 1 4\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")


TRIS = [[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 0, 1], [0, 1, 1]]]
WRITERS = {
    "stl_binary": ("m.stl", lambda p: _write_binary_stl(p, TRIS), 2),
    "stl_ascii": ("m.stl", lambda p: _write_ascii_stl(p, TRIS), 2),
    "ply_ascii": ("m.ply", _write_ascii_ply, 2),
    "ply_binary": ("m.ply", _write_binary_ply, 2),
    "glb_node_transform": ("m.glb", _write_glb, 2),
    "gltf_data_uri": ("m.gltf", _write_gltf_data_uri, 4),
    "off": ("m.off", _write_off, 2),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_interchange_formats_match_jax(tmp_path, kind):
    name, write, ntris = WRITERS[kind]
    path = tmp_path / name
    write(path)
    mesh = _assert_same_mesh(path)
    assert mesh.num_triangles == ntris


def test_glb_node_transform_and_material(tmp_path):
    """The GLB node's rotation and translation reach the vertices, and its
    primitive's material name the faces."""
    path = tmp_path / "m.glb"
    _write_glb(path)
    mesh = port_objloader.load_mesh(str(path))
    assert mesh.face_materials == ["brick", "brick"]
    np.testing.assert_allclose(mesh.vertices[mesh.faces[0]],
                               [[5, 0, 0], [5, 1, 0], [4, 1, 0]], atol=1e-6)


@pytest.mark.parametrize("ext", [".fbx", ".3ds", ""])
def test_unknown_extension_error_matches_jax(tmp_path, ext):
    path = tmp_path / f"model{ext}"
    path.write_text("x")
    with pytest.raises(ValueError) as want:
        jax_objloader.load_mesh(str(path))
    with pytest.raises(ValueError) as got:
        port_objloader.load_mesh(str(path))
    assert str(got.value) == str(want.value)
    assert "supported formats" in str(got.value)


def test_room1_render_matches_jax(assets_dir):
    """A small speaker render of room1.dxf with mat.json, each package on
    its own scene and trace, within -60 dB of peak (forgiving single-bin
    displacement, as tests/test_torch_render.py)."""
    model = str(assets_dir / "test_models" / "room1.dxf")
    mat = str(assets_dir / "materials" / "mat.json")
    doc = json.dumps({
        "rays": 128, "reflections": 5, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [3.013, -60.017, 10.021],
        "mic_position": [-8.031, -80.989, 12.007],
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
        "filter": "onepass", "trim_predelay": False, "trim_tail": False,
    })
    dirs = random_directions(128, seed=5)
    want, _ = jax_render.render_fused(jax_load_scene(model, mat), jax_parse_config(doc), dirs)
    got, _ = port_render.render_fused(port_compile.load_scene(model, mat),
                                      port_parse_config(doc), dirs, device="cpu")
    want = np.asarray(want, np.float64)
    got = got.astype(np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    peak = np.abs(want).max()
    assert peak > 0
    errs = [np.abs(got - np.roll(want, s, axis=-1)) for s in (0, 1, -1)]
    err = np.minimum(np.minimum(errs[0], errs[1]), errs[2]).max() / peak
    assert err < 1e-3, f"max error {err:.2e} exceeds -60 dB"
