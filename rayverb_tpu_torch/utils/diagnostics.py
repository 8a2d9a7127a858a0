"""Diagnostics: ray-path JSONL dumps (PyTorch counterpart of
rayverb_tpu/utils/diagnostics.py; phase timings are utils/profiling.py's
spans).

The reference hides its path dump behind a compile-time DIAGNOSTIC flag
(rayverb.h:19, helpers.cpp:16-60) writing `impulse.dump`: one JSON array
per ray of {"position": [x,y,z], "volume": mean-of-8-bands} over the
diffuse reflections. Here, as in the JAX package, it is a runtime option
with the same schema, which the same viewers read.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def dump_paths_arrays(path: str, positions, volumes) -> None:
    """positions (N, R, 3), volumes (N, R, 8) (tensors or arrays) -> JSONL
    file, one line per ray (print_diagnostic, helpers.cpp:28-58)."""
    positions = _host64(positions)
    mean_vol = _host64(volumes).mean(axis=-1)
    with open(path, "w") as fh:
        for ray_pos, ray_vol in zip(positions, mean_vol):
            line = [
                {"position": [float(c) for c in p], "volume": float(v)}
                for p, v in zip(ray_pos, ray_vol)
            ]
            fh.write(json.dumps(line) + "\n")


def dump_paths(path: str, nrays: int, nreflections: int, trace_outputs) -> None:
    """Dump from TraceOutputs (the diffuse population, like the reference's
    getRawDiffuse feed at cmd/main.cpp:271-278)."""
    dump_paths_arrays(
        path, trace_outputs.diffuse_position, trace_outputs.diffuse_volume
    )
