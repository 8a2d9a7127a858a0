"""STL and PLY mesh import (the port's own copy of
rayverb_tpu/scene/stlply.py: host numpy, no device work).

The reference accepts any Assimp-supported model format
(reference cmd/parallel_raytrace.1.md:36-39); its demo corpus is OBJ+DXF,
but Assimp's most common interchange formats beyond those are STL and PLY.
These are from-scratch readers producing the same :class:`RawMesh` contract
as the OBJ importer: a flat triangle soup with per-triangle material names.
Neither format carries material *names* (STL has none at all; PLY's
optional per-face colors have no analog in the material JSON), so every
face maps to '' -> the default surface at index 0, exactly Assimp's
unmatched-material behaviour in the reference (rayverb/rayverb.cpp:336-341).

Supported encodings:
  - STL: binary (84-byte header + 50-byte records) and ASCII (`solid`/
    `facet`/`vertex`), auto-detected by record arithmetic, not by the
    `solid` prefix (binary exporters routinely write it too)
  - PLY: `format ascii 1.0` and `format binary_little_endian 1.0`,
    arbitrary extra vertex properties (skipped), list-typed face property
    (`vertex_indices`/`vertex_index`), polygon faces fan-triangulated like
    Assimp's aiProcess_Triangulate
"""

from __future__ import annotations

import struct

import numpy as np

from .objloader import RawMesh


def _mesh_from_triangles(tris: np.ndarray, path: str, what: str) -> RawMesh:
    """(T, 3, 3) float32 corner array -> RawMesh (3T indexed vertices)."""
    if tris.size == 0:
        raise ValueError(f"{what} file {path!r} contains no triangles")
    t = tris.shape[0]
    return RawMesh(
        vertices=tris.reshape(t * 3, 3).astype(np.float32),
        faces=np.arange(t * 3, dtype=np.int64).reshape(t, 3),
        face_materials=[""] * t,
    )


def load_stl(path: str) -> RawMesh:
    """Read a binary or ASCII STL file as a triangle soup."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) >= 84:
        (ntri,) = struct.unpack_from("<I", data, 80)
        if len(data) == 84 + 50 * ntri and ntri > 0:
            rec = np.frombuffer(
                data,
                dtype=np.dtype(
                    [
                        ("normal", "<f4", (3,)),
                        ("verts", "<f4", (3, 3)),
                        ("attr", "<u2"),
                    ],
                    align=False,
                ),
                count=ntri,
                offset=84,
            )
            return _mesh_from_triangles(np.array(rec["verts"]), path, "STL")

    # ASCII: sequence of `facet` blocks, 3+ `vertex x y z` lines each
    # (facets with >3 vertices are non-standard; fan-triangulate anyway)
    tris: list = []
    current: list = []
    try:
        text = data.decode("ascii", errors="replace")
    except Exception as e:  # pragma: no cover - decode never raises here
        raise ValueError(f"STL file {path!r}: cannot decode as ASCII") from e
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0].lower()
        if tag == "vertex":
            if len(parts) < 4:
                raise ValueError(f"STL file {path!r}: malformed vertex line")
            current.append(
                (float(parts[1]), float(parts[2]), float(parts[3]))
            )
        elif tag == "endfacet":
            for k in range(1, len(current) - 1):
                tris.append((current[0], current[k], current[k + 1]))
            current = []
    return _mesh_from_triangles(np.asarray(tris, np.float32), path, "STL")


_PLY_SCALARS = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _ply_header(data: bytes, path: str):
    """Parse the PLY header: (fmt, elements, body_offset) where elements is
    a list of (name, count, properties) and each property is either
    ('scalar', name, dtype) or ('list', name, count_dtype, item_dtype)."""
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"PLY file {path!r}: missing ply/end_header")
    nl = data.find(b"\n", end)
    body = nl + 1
    fmt = None
    elements: list = []
    for raw in data[:end].decode("ascii", errors="replace").splitlines():
        parts = raw.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise ValueError(
                    f"PLY file {path!r}: property before any element"
                )
            props = elements[-1][2]
            if parts[1] == "list":
                props.append(
                    ("list", parts[4],
                     _PLY_SCALARS[parts[2]], _PLY_SCALARS[parts[3]])
                )
            else:
                props.append(("scalar", parts[2], _PLY_SCALARS[parts[1]]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(
            f"PLY file {path!r}: unsupported format {fmt!r} (supported: "
            "ascii, binary_little_endian)"
        )
    return fmt, elements, body


def load_ply(path: str) -> RawMesh:
    """Read an ASCII or binary-little-endian PLY file."""
    with open(path, "rb") as fh:
        data = fh.read()
    fmt, elements, offset = _ply_header(data, path)

    vertices = None
    faces: list = []
    if fmt == "ascii":
        lines = iter(
            data[offset:].decode("ascii", errors="replace").splitlines()
        )
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                for line in lines:
                    if line.split():
                        rows.append(line.split())
                        break
                else:
                    raise ValueError(f"PLY file {path!r}: truncated body")
            if name == "vertex":
                cols = {p[1]: i for i, p in enumerate(props)}
                try:
                    sel = [cols["x"], cols["y"], cols["z"]]
                except KeyError:
                    raise ValueError(
                        f"PLY file {path!r}: vertex element lacks x/y/z"
                    ) from None
                vertices = np.asarray(
                    [[float(r[i]) for i in sel] for r in rows], np.float32
                )
            elif name == "face":
                li = next(
                    (i for i, p in enumerate(props) if p[0] == "list"
                     and p[1] in ("vertex_indices", "vertex_index")),
                    None,
                )
                if li is None:
                    raise ValueError(
                        f"PLY file {path!r}: face element lacks "
                        "vertex_indices"
                    )
                # scalar properties before the list occupy one column each
                lead = sum(1 for p in props[:li] if p[0] == "scalar")
                for r in rows:
                    n = int(r[lead])
                    faces.append([int(x) for x in r[lead + 1 : lead + 1 + n]])
    else:
        pos = offset
        for name, count, props in elements:
            want_v = name == "vertex"
            want_f = name == "face"
            # fast path: fixed-size scalar-only elements parse as one view
            if all(p[0] == "scalar" for p in props):
                dt = np.dtype(
                    [(f"c{i}", "<" + p[2]) for i, p in enumerate(props)]
                )
                if want_v:
                    rec = np.frombuffer(data, dt, count=count, offset=pos)
                    cols = {p[1]: f"c{i}" for i, p in enumerate(props)}
                    try:
                        vertices = np.stack(
                            [rec[cols[a]] for a in "xyz"], axis=1
                        ).astype(np.float32)
                    except KeyError:
                        raise ValueError(
                            f"PLY file {path!r}: vertex element lacks x/y/z"
                        ) from None
                pos += dt.itemsize * count
                continue
            # list-bearing element: walk records (face counts vary per row)
            for _ in range(count):
                vals_idx = None
                for p in props:
                    if p[0] == "scalar":
                        pos += np.dtype(p[2]).itemsize
                    else:
                        cdt = np.dtype("<" + p[2])
                        n = int(
                            np.frombuffer(data, cdt, count=1, offset=pos)[0]
                        )
                        pos += cdt.itemsize
                        idt = np.dtype("<" + p[3])
                        vals = np.frombuffer(data, idt, count=n, offset=pos)
                        pos += idt.itemsize * n
                        if p[1] in ("vertex_indices", "vertex_index"):
                            vals_idx = [int(x) for x in vals]
                if want_f and vals_idx is not None:
                    faces.append(vals_idx)

    if vertices is None or not faces:
        raise ValueError(f"PLY file {path!r} contains no triangles")
    tri_faces: list = []
    for poly in faces:
        for k in range(1, len(poly) - 1):
            tri_faces.append((poly[0], poly[k], poly[k + 1]))
    return RawMesh(
        vertices=vertices,
        faces=np.asarray(tri_faces, np.int64),
        face_materials=[""] * len(tri_faces),
    )
