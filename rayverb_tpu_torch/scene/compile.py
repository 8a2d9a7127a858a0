"""Scene compiler: mesh + materials -> dense arrays for the trace.

The reference keeps triangles as index triples into a shared vertex array and
gathers vertices inside the device kernel (rayverb/kernel.cpp:100-106). The
compiler instead pre-gathers each triangle's vertices into a dense (T, 3, 3)
array and precomputes the edge vectors and normals the sweep needs (a copy of
rayverb_tpu/scene/compile.py, so that this package stands alone).

Parity notes (reference rayverb/rayverb.cpp:296-507):
  - unmatched mesh materials map to the default surface at index 0
  - validity semantics match `SceneData::valid` (rayverb.cpp:463-502),
    including the quirk of only checking the first 3 bands of each surface
  - the triangle count is padded with degenerate (all-zero) triangles, which
    can never intersect (zero-area => |det| < EPSILON), so padding is
    results-invisible
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import profiling
from .materials import SurfaceSet, load_materials
from .objloader import RawMesh, load_mesh


class SceneError(ValueError):
    """Raised when a scene fails validity checks."""


@dataclass(frozen=True)
class Scene:
    """Compiled, device-ready scene.

    All arrays are float32/int32 and padded to ``padded_triangles`` rows;
    rows >= ``num_triangles`` are degenerate and never hit.
    """

    tri_verts: np.ndarray     # (T, 3, 3)  v0, v1, v2 per triangle
    tri_surface: np.ndarray   # (T,)       surface row per triangle
    specular: np.ndarray      # (S, 8)
    diffuse: np.ndarray       # (S, 8)
    num_triangles: int        # valid triangle count (pre-padding)

    @property
    def padded_triangles(self) -> int:
        return int(self.tri_verts.shape[0])

    @property
    def v0(self) -> np.ndarray:
        return self.tri_verts[:, 0]

    @property
    def e0(self) -> np.ndarray:
        """First edge v1 - v0 (kernel.cpp:65)."""
        return self.tri_verts[:, 1] - self.tri_verts[:, 0]

    @property
    def e1(self) -> np.ndarray:
        """Second edge v2 - v0 (kernel.cpp:66)."""
        return self.tri_verts[:, 2] - self.tri_verts[:, 0]

    @property
    def normals(self) -> np.ndarray:
        """Unnormalised face normals cross(e0, e1) (kernel.cpp:109-116)."""
        return np.cross(self.e0, self.e1)

    @property
    def bounds(self) -> np.ndarray:
        """(2, 3) min/max corner over real (non-padding) vertices
        (rayverb.cpp:195-227)."""
        # reduced along the rows of a (3, V) copy: numpy reduces axis 0 of
        # the (V, 3) layout ~20x slower (25 ms at 100k triangles)
        v = np.ascontiguousarray(self.tri_verts[: self.num_triangles].reshape(-1, 3).T)
        return np.stack([v.min(axis=1), v.max(axis=1)])

    def inside(self, point) -> bool:
        """Is ``point`` inside the axis-aligned bounds (rayverb.cpp:230-239)?"""
        p = np.asarray(point, dtype=np.float32)
        lo, hi = self.bounds
        return bool(np.all((lo <= p) & (p <= hi)))


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def compile_scene(
    mesh: RawMesh,
    surfaces: SurfaceSet,
    *,
    pad_to: int = 8,
    verbose: bool = False,
) -> Scene:
    """Bind mesh faces to surface rows and emit dense arrays."""
    tri_surface = np.asarray(
        [surfaces.index_of(name) for name in mesh.face_materials],
        dtype=np.int32,
    )
    if verbose:
        import sys

        for name in sorted(set(mesh.face_materials)):
            row = surfaces.index_of(name)
            print(
                f"material {name!r} -> surface row {row}"
                + (" (default)" if row == 0 else ""),
                file=sys.stderr,
            )
        print(f"Loaded 3D model with {mesh.num_triangles} triangles", file=sys.stderr)

    nt = mesh.num_triangles
    if nt == 0 or mesh.vertices.shape[0] == 0:
        raise SceneError("scene has no geometry")
    if mesh.faces.min() < 0 or mesh.faces.max() >= mesh.vertices.shape[0]:
        raise SceneError("triangle vertex index out of range")
    if tri_surface.max(initial=0) >= surfaces.num_surfaces:
        raise SceneError("triangle surface index out of range")
    # Reference checks only the first 3 bands (rayverb.cpp:467-474).
    for arr, what in ((surfaces.specular, "specular"), (surfaces.diffuse, "diffuse")):
        head = arr[:, :3]
        if np.any(head < 0) or np.any(head > 1):
            raise SceneError(f"surface {what} coefficients out of [0, 1]")

    padded = _round_up(nt, pad_to)
    tri_verts = np.zeros((padded, 3, 3), dtype=np.float32)
    tri_verts[:nt] = mesh.vertices[mesh.faces]
    surface_idx = np.zeros((padded,), dtype=np.int32)
    surface_idx[:nt] = tri_surface

    return Scene(
        tri_verts=tri_verts,
        tri_surface=surface_idx,
        specular=surfaces.specular.astype(np.float32),
        diffuse=surfaces.diffuse.astype(np.float32),
        num_triangles=nt,
    )


def load_scene(
    model_path: str,
    material_path: str,
    *,
    pad_to: int = 8,
    verbose: bool = False,
) -> Scene:
    """Load + compile a scene from files (the reference's SceneData ctor,
    rayverb.cpp:299-302): the one-time span rv.load_scene, with rv.obj_parse
    and rv.scene_compile (utils.profiling)."""
    with profiling.once("rv.load_scene"):
        with profiling.once("rv.obj_parse"):
            mesh = load_mesh(model_path)
        surfaces = load_materials(material_path)
        with profiling.once("rv.scene_compile"):
            return compile_scene(mesh, surfaces, pad_to=pad_to, verbose=verbose)
