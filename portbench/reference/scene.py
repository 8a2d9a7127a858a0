"""The reference's own scene input: a Wavefront OBJ reader and the materials
table, written from the file formats and the published raytracer's rules
(reuk/parallel-reverb-raytracer, rayverb.cpp:296-507), with nothing taken
from the program under test.

  - ``v`` lines are vertices, ``usemtl`` sets the material of the faces that
    follow, ``f`` lines are polygons fan-triangulated from their first
    vertex (1-based indices, negative ones count back from the end)
  - surface 0 is the default surface; named materials follow in sorted-name
    order; a face whose material has no entry takes surface 0
"""

from __future__ import annotations

import json

import numpy as np

DEFAULT_SPECULAR = (0.92, 0.92, 0.93, 0.93, 0.94, 0.95, 0.95, 0.95)
DEFAULT_DIFFUSE = (0.50, 0.90, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95)


def read_obj(path: str):
    """(vertices (V, 3) float32, faces (T, 3) int64, material name per face)."""
    verts, faces, mats = [], [], []
    material = ""
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "usemtl":
                material = parts[1] if len(parts) > 1 else ""
            elif parts[0] == "f" and len(parts) >= 4:
                n = len(verts)
                idx = []
                for tok in parts[1:]:
                    k = int(tok.split("/", 1)[0])
                    idx.append(k - 1 if k > 0 else n + k)
                for j in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[j], idx[j + 1]))
                    mats.append(material)
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int64), mats)


def read_materials(path: str):
    """(names, specular (S, 8) float32, diffuse (S, 8) float32), row 0 the
    default surface."""
    with open(path) as fh:
        doc = json.load(fh)
    names = sorted(doc)
    spec = [DEFAULT_SPECULAR] + [doc[k]["specular"] for k in names]
    diff = [DEFAULT_DIFFUSE] + [doc[k]["diffuse"] for k in names]
    return names, np.asarray(spec, np.float32), np.asarray(diff, np.float32)


def load(obj_path: str, materials_path: str) -> dict:
    """Triangles of a scene: v0, v1, v2 (T, 3) float32, surface (T,) int64,
    specular and diffuse (S, 8) float32, bounds (2, 3) float32."""
    verts, faces, mats = read_obj(obj_path)
    names, spec, diff = read_materials(materials_path)
    row = {name: i + 1 for i, name in enumerate(names)}
    tri = verts[faces]  # (T, 3, 3)
    flat = tri.reshape(-1, 3)
    return {
        "v0": tri[:, 0].copy(),
        "v1": tri[:, 1].copy(),
        "v2": tri[:, 2].copy(),
        "surface": np.asarray([row.get(m, 0) for m in mats], np.int64),
        "specular": spec,
        "diffuse": diff,
        "bounds": np.stack([flat.min(axis=0), flat.max(axis=0)]),
    }
