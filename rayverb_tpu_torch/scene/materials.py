"""Material (surface) parsing from the JSON materials file.

Mirrors the reference semantics:
  - each entry maps a material name to {"specular": [8], "diffuse": [8]}
    (reference rayverb/rayverb.cpp:304-327, config.h:261-283)
  - surface index 0 is a hard-coded default used for any mesh material whose
    name has no entry in the JSON (rayverb.cpp:336-341, 369-372)
  - named surfaces are appended in sorted-name order, matching the ordered
    std::map iteration in the reference (rayverb.cpp:348-354)
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..constants import NUM_BANDS

# Default surface used for unmatched materials (rayverb.cpp:336-341).
DEFAULT_SPECULAR = (0.92, 0.92, 0.93, 0.93, 0.94, 0.95, 0.95, 0.95)
DEFAULT_DIFFUSE = (0.50, 0.90, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95)


class MaterialError(ValueError):
    """Raised when the materials JSON is malformed."""


def _band_array(value, *, key: str, name: str) -> np.ndarray:
    if (
        not isinstance(value, (list, tuple))
        or len(value) != NUM_BANDS
        or not all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in value)
    ):
        raise MaterialError(
            f"material {name!r}: {key!r} must be an array of {NUM_BANDS} numbers"
        )
    return np.asarray(value, dtype=np.float32)


@dataclass(frozen=True)
class SurfaceSet:
    """Compiled surface table.

    specular / diffuse: (S, 8) float32, row 0 = default surface.
    index_of: material name -> row index (unmatched names -> 0).
    """

    specular: np.ndarray
    diffuse: np.ndarray
    names: tuple

    def index_of(self, name: str) -> int:
        try:
            # +1 for the default surface at row 0.
            return self.names.index(name) + 1
        except ValueError:
            return 0

    @property
    def num_surfaces(self) -> int:
        return int(self.specular.shape[0])


def parse_materials(text: str) -> SurfaceSet:
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise MaterialError(f"failed to parse materials JSON: {e}") from e
    if not isinstance(doc, dict):
        # reference: "Materials must be stored in a JSON object"
        # (rayverb.cpp:308-309)
        raise MaterialError("Materials must be stored in a JSON object")

    names = tuple(sorted(doc.keys()))
    specular = [np.asarray(DEFAULT_SPECULAR, dtype=np.float32)]
    diffuse = [np.asarray(DEFAULT_DIFFUSE, dtype=np.float32)]
    for name in names:
        entry = doc[name]
        if not isinstance(entry, dict):
            raise MaterialError(f"material {name!r} must be a JSON object")
        for key in ("specular", "diffuse"):
            if key not in entry:
                # reference RequiredValidator message (config.h:111)
                raise MaterialError(f"key {key} not found in config object")
        specular.append(_band_array(entry["specular"], key="specular", name=name))
        diffuse.append(_band_array(entry["diffuse"], key="diffuse", name=name))

    return SurfaceSet(
        specular=np.stack(specular),
        diffuse=np.stack(diffuse),
        names=names,
    )


def load_materials(path: str) -> SurfaceSet:
    with open(path, "r") as fh:
        return parse_materials(fh.read())
