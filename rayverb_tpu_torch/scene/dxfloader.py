"""AutoCAD DXF (R12) mesh importer (the port's own copy of
rayverb_tpu/scene/dxfloader.py: host numpy, no device work).

The reference imports any Assimp-supported format
(rayverb/rayverb.cpp:447-461); its demo corpus ships three DXF rooms
(demo/assets/test_models/room{1,2,3}.dxf) exported by PolyTrans as 3DFACE
entities with "Layer names derived from surface (material) names". This
importer covers that subset: 3DFACE quads/triangles, with the entity's
layer (group 8) as the face's material name — the same name Assimp's DXF
reader reports, so JSON material matching behaves identically (unmatched
names fall to the default surface, rayverb.cpp:336-341).

DXF is a flat group-code/value pair stream:
    0\n3DFACE\n 8\n<layer>\n 10\n<x1>\n 20\n<y1>\n 30\n<z1>\n 11\n<x2>...
Corners 3 and 4 coincide for triangles; distinct corners make a quad,
triangulated here as (0,1,2) + (0,2,3) — Assimp's aiProcess_Triangulate
fan order.
"""

from __future__ import annotations

import numpy as np

from .objloader import RawMesh


def load_dxf(path: str) -> RawMesh:
    with open(path, "r", errors="replace") as fh:
        lines = fh.read().splitlines()
    if len(lines) % 2:
        lines = lines[:-1]

    vertices: list = []
    faces: list = []
    materials: list = []

    i = 0
    n = len(lines)
    while i + 1 < n:
        code = lines[i].strip()
        value = lines[i + 1].strip()
        i += 2
        if code != "0" or value != "3DFACE":
            continue
        # collect this entity's groups until the next 0 group
        layer = ""
        coords = {}
        while i + 1 < n:
            code = lines[i].strip()
            value = lines[i + 1].strip()
            if code == "0":
                break
            i += 2
            if code == "8":
                layer = value
            else:
                try:
                    g = int(code)
                except ValueError:
                    continue
                if 10 <= g <= 13 or 20 <= g <= 23 or 30 <= g <= 33:
                    try:
                        coords[g] = float(value)
                    except ValueError as e:
                        raise ValueError(
                            f"DXF file {path!r}: bad coordinate {value!r}"
                        ) from e
        try:
            corners = [
                (coords[10 + k], coords[20 + k], coords[30 + k])
                for k in range(4)
                if 10 + k in coords
            ]
        except KeyError as e:
            raise ValueError(
                f"DXF file {path!r}: incomplete 3DFACE entity"
            ) from e
        if len(corners) < 3:
            raise ValueError(f"DXF file {path!r}: 3DFACE with <3 corners")
        base = len(vertices)
        vertices.extend(corners)
        faces.append((base, base + 1, base + 2))
        materials.append(layer)
        if len(corners) == 4 and corners[3] != corners[2]:
            faces.append((base, base + 2, base + 3))
            materials.append(layer)

    if not faces:
        raise ValueError(f"DXF file {path!r} contains no 3DFACE entities")
    return RawMesh(
        vertices=np.asarray(vertices, np.float32),
        faces=np.asarray(faces, np.int64),
        face_materials=materials,
    )
