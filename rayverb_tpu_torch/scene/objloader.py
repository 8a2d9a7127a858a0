"""Wavefront OBJ/MTL import.

The reference delegates mesh import to Assimp with triangulation
(reference rayverb/rayverb.cpp:447-461) and groups faces into per-material
meshes. This is a from-scratch OBJ/MTL reader producing the same logical
result: a flat list of triangles, each carrying the *material name* active
when its face was declared. Polygon faces are fan-triangulated, matching
Assimp's aiProcess_Triangulate behaviour on the convex faces found in the
demo corpus.

``load_obj`` prefers the port's native C++ parser (native/objparse.cpp,
the port's copy of the JAX package's), which this module's pure-Python
reader specifies; RAYVERB_NO_NATIVE=1 takes the Python reader.
``load_mesh`` dispatches on the extension to the port's DXF, STL, PLY,
glTF/GLB and OFF readers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RawMesh:
    """Triangle soup with per-triangle material names.

    vertices: (V, 3) float32
    faces:    (T, 3) int64 indices into vertices
    face_materials: length-T list of material names ('' when no usemtl seen)
    """

    vertices: np.ndarray
    faces: np.ndarray
    face_materials: list = field(default_factory=list)

    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])


def _parse_index(token: str, nverts: int) -> int:
    """Resolve an OBJ face index token ('3', '3/1', '3//2', '-1') to 0-based."""
    head = token.split("/", 1)[0]
    idx = int(head)
    if idx > 0:
        return idx - 1
    if idx < 0:
        return nverts + idx
    raise ValueError("OBJ face index 0 is invalid")


def load_obj_python(path: str) -> RawMesh:
    """Parse an OBJ file into a :class:`RawMesh` (pure-Python reference
    implementation — the semantic spec for the native importer).

    Only geometry statements are honoured (v, f, usemtl); texture/normal
    indices inside face tokens are ignored, as are smoothing groups, lines
    and points — the raytracer consumes pure triangle geometry.
    """
    vertices: list = []
    faces: list = []
    face_materials: list = []
    current_material = ""

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                vertices.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif tag == "usemtl":
                current_material = parts[1] if len(parts) > 1 else ""
            elif tag == "f" and len(parts) >= 4:
                nverts = len(vertices)
                idx = [_parse_index(tok, nverts) for tok in parts[1:]]
                # Fan triangulation (convex polygons), like Assimp's
                # aiProcess_Triangulate on the demo corpus.
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    face_materials.append(current_material)

    if not vertices or not faces:
        raise ValueError(f"OBJ file {path!r} contains no triangles")

    return RawMesh(
        vertices=np.asarray(vertices, dtype=np.float32),
        faces=np.asarray(faces, dtype=np.int64),
        face_materials=face_materials,
    )


def load_obj(path: str) -> RawMesh:
    """Parse an OBJ file, preferring the native C++ parser
    (rayverb_tpu/scene/objloader.py:99-106); the pure-Python reader when
    RAYVERB_NO_NATIVE is set or the parser cannot be built."""
    if not os.environ.get("RAYVERB_NO_NATIVE"):
        from ..native import load_obj_native

        mesh = load_obj_native(path)
        if mesh is not None:
            return mesh
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return load_obj_python(path)


def load_mesh(path: str) -> RawMesh:
    """Load a 3D model: OBJ (+MTL), DXF (3DFACE), STL, PLY, glTF/GLB, or OFF
    (rayverb_tpu/scene/objloader.py:118-153).

    The reference accepts any Assimp-supported format
    (cmd/parallel_raytrace.1.md:36-39); OBJ + DXF cover its entire demo
    corpus (room1-3.dxf included), and STL/PLY/glTF/OFF cover the common
    interchange formats beyond it. Other extensions raise a clear error so
    callers can convert.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".dxf":
        from .dxfloader import load_dxf

        return load_dxf(path)
    if ext == ".stl":
        from .stlply import load_stl

        return load_stl(path)
    if ext == ".ply":
        from .stlply import load_ply

        return load_ply(path)
    if ext in (".gltf", ".glb"):
        from .gltf import load_gltf

        return load_gltf(path)
    if ext == ".off":
        from .gltf import load_off

        return load_off(path)
    raise ValueError(
        f"Unsupported model format {ext!r}; supported formats: "
        ".obj, .dxf, .stl, .ply, .gltf, .glb, .off"
    )
