"""High-level engine API: the reference `Raytracer` class surface (PyTorch
counterpart of rayverb_tpu/engine.py).

RaytracerResults plus getRawDiffuse / getRawImages / getAllRaw with the
semantics of reference rayverb/rayverb.cpp:687-714, including the cross-ray
image-source deduplication keyed on surface-index chains
(rayverb.cpp:653-676), and the raw-impulse ``.npz`` files, whose keys are
the JAX package's, so that a file written by either package loads in the
other.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from .config.schema import OutputMode
from .device import resolve_device
from .ops.intersect import TriangleSoup, soup_from_scene
from .ops.trace import TraceOutputs, trace
from .scene.compile import Scene, load_scene
from .utils import profiling


@dataclass
class RaytracerResults:
    """Impulses plus the mic position they were traced against
    (rayverb.h:123-133). volume, position and time are tensors on the
    render's device or host numpy arrays (load_raw, the getters)."""

    volume: object    # (M, 8)
    position: object  # (M, 3)
    time: object      # (M,)
    mic: np.ndarray   # (3,)

    @property
    def num_impulses(self) -> int:
        return int(self.time.shape[0])


def _mix32_np(h):
    """The 32-bit finalizer of render._mix32 (the JAX package's
    engine._mix32_np), in numpy uint32."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x846CA68B)
    h = h ^ (h >> np.uint32(16))
    return h


def dedup_select(image_index: np.ndarray, remove_direct: bool):
    """Cross-ray image-source dedup (rayverb.cpp:653-676), index phase, on
    the host; the JAX package's engine.dedup_select, step for step.

    The reference inserts, per ray, every prefix of the 10-slot
    surface-index chain into an ordered map (first writer wins; identical
    chains produce identical impulses), admitting a prefix when it is the
    length-1 direct-path key or its last element is a real surface
    (non-zero); `removeDirect` erases the {0} key (rayverb.cpp:692-697).

    Prefix identity is a cumulative 64-bit hash of the chain (two mixed
    32-bit streams, the design of render.chain_hashes); a collision would
    merge two distinct early reflections (probability ~2^-64 per pair, the
    documented deviation shared with the fused path). The surviving unique
    chains are ordered lexicographically, shorter prefixes first: std::map
    iteration order.

    Takes the (N, S) index array and returns (ray_ids, slot_ids) of the
    surviving entries. Counters: dedup.images_in (the admitted entries)
    and dedup.images_kept (the survivors)."""
    idx = np.ascontiguousarray(np.asarray(image_index))
    n, s = idx.shape
    u = idx.astype(np.uint32)

    keys = np.empty((n, s), np.uint64)
    h1 = np.full(n, 0x9E3779B9, np.uint32)
    h2 = np.full(n, 0x85EBCA6B, np.uint32)
    for k in range(s):
        h1 = _mix32_np(h1 ^ u[:, k])
        h2 = _mix32_np((h2 + u[:, k]) ^ np.uint32(0x27D4EB2F))
        keys[:, k] = (h1.astype(np.uint64) << np.uint64(32)) | h2
    keep = np.ones((n, s), dtype=bool)
    keep[:, 1:] = idx[:, 1:] != 0
    if remove_direct:
        keep[:, 0] = False

    # one flat unique over the hashed keys; dropped entries get a sentinel
    # key whose group is discarded by the keep test on its first index
    flat_keys = np.where(keep, keys, np.uint64(0xFFFFFFFFFFFFFFFF)).ravel()
    _, first = np.unique(flat_keys, return_index=True)
    first = first[keep.ravel()[first]]
    profiling.count("dedup.images_in", int(np.count_nonzero(keep)))
    profiling.count("dedup.images_kept", int(first.size))
    ray_ids = first // s
    slot_ids = first % s
    if first.size == 0:
        return ray_ids, slot_ids

    # the reference's map key order: lexicographic over variable-length
    # chains, shorter prefixes first (padding -1 sorts below any index)
    m = first.size
    chains = np.full((m, s), -1, dtype=np.int64)
    for j in range(s):
        sel = slot_ids >= j
        chains[sel, j] = idx[ray_ids[sel], j]
    order = np.lexsort(chains.T[::-1])
    return ray_ids[order], slot_ids[order]


def _select_images(outputs: TraceOutputs, remove_direct: bool):
    """(volume (K, 8), position (K, 3), time (K,)) of the deduplicated
    image sources, on the outputs' device; only the (N, S) index table
    crosses to the host (span rv.dedup, its wait rv.sync site
    dedup_index)."""
    with profiling.span("rv.dedup"):
        with profiling.span("rv.sync", site="dedup_index"):
            index = outputs.image_index.cpu().numpy()
        sel_r, sel_s = dedup_select(index, remove_direct)
        dev = outputs.image_time.device
        r = torch.from_numpy(sel_r).to(dev)
        s = torch.from_numpy(sel_s).to(dev)
        return outputs.image_volume[r, s], outputs.image_position[r, s], outputs.image_time[r, s]


def dedup_images(outputs: TraceOutputs, remove_direct: bool):
    """Deduplicated image-source impulses as host arrays:
    (volume (K, 8), position (K, 3), time (K,)) float32."""
    return tuple(
        x.cpu().numpy().astype(np.float32) for x in _select_images(outputs, remove_direct)
    )


def assemble_population(outputs: TraceOutputs, mode: OutputMode, remove_direct: bool):
    """Device-resident population for the pipeline: (volume (M, 8),
    position (M, 3), time (M,)) tensors on the outputs' device, the diffuse
    rows (ray-major) before the deduplicated images; only the (N, S)
    image-index table crosses to the host. ``mode`` is an OutputMode
    (cmd/main.cpp:255-269). Counter population.rows: the diffuse rows and
    image slots the mode takes in."""
    parts = []
    if mode in (OutputMode.ALL, OutputMode.DIFFUSE_ONLY):
        n, r = outputs.diffuse_time.shape
        profiling.count("population.rows", n * r)
        parts.append(
            (
                outputs.diffuse_volume.reshape(n * r, -1),
                outputs.diffuse_position.reshape(n * r, 3),
                outputs.diffuse_time.reshape(n * r),
            )
        )
    if mode in (OutputMode.ALL, OutputMode.IMAGE_ONLY):
        profiling.count("population.rows", outputs.image_index.numel())
        parts.append(_select_images(outputs, remove_direct))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts], dim=0) for i in range(3))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_raw(path: str, results: RaytracerResults) -> None:
    """Persist raw impulses to .npz (the JAX package's keys: volume,
    position, time, mic, float32), so attenuation and filtering can be run
    again without tracing."""
    np.savez_compressed(
        path,
        volume=_host(results.volume).astype(np.float32),
        position=_host(results.position).astype(np.float32),
        time=_host(results.time).astype(np.float32),
        mic=_host(results.mic).astype(np.float32),
    )


def load_raw(path: str) -> RaytracerResults:
    """Inverse of save_raw (host numpy arrays)."""
    with np.load(path) as z:
        return RaytracerResults(
            volume=z["volume"], position=z["position"], time=z["time"], mic=z["mic"],
        )


class Raytracer:
    """Host orchestration mirroring the reference Raytracer
    (rayverb.h:136-220) on ``device`` (None: the card). ray_chunk None
    plans the trace's chunks from its memory (trace.trace). Each Raytracer
    builds its scene's sweep table (span rv.sweep_table, attribute hit
    false; counter sweep_table.builds)."""

    def __init__(
        self,
        nreflections: int,
        scene: Scene | str,
        material_path: str | None = None,
        *,
        verbose: bool = False,
        ray_chunk: int | None = None,
        impl: str = "auto",
        device=None,
    ):
        if isinstance(scene, str):
            if material_path is None:
                raise ValueError("material_path required when loading from file")
            scene = load_scene(scene, material_path, verbose=verbose)
        self.nreflections = int(nreflections)
        self.scene = scene
        self.device = resolve_device(device)
        with profiling.span("rv.sweep_table", hit=False):
            self.soup: TriangleSoup = soup_from_scene(scene, device=self.device)
        profiling.count("sweep_table.builds")
        self.verbose = verbose
        self.ray_chunk = ray_chunk
        self.impl = impl
        self._outputs: TraceOutputs | None = None
        self._mic: np.ndarray | None = None

    # -- reference API ----------------------------------------------------
    def raytrace(self, micpos, source, directions, verbose: bool | None = None):
        """Run the trace (rayverb.cpp:538-685), storing raw results."""
        verbose = self.verbose if verbose is None else verbose
        micpos = np.asarray(micpos, dtype=np.float32)
        source = np.asarray(source, dtype=np.float32)
        if verbose:
            self._bounds_warnings(micpos, source)
        self._outputs = trace(
            self.soup,
            micpos,
            source,
            directions,
            self.nreflections,
            ray_chunk=self.ray_chunk,
            impl=self.impl,
        )
        self._mic = micpos
        return self._outputs

    def _bounds_warnings(self, micpos, source):
        """Mic/source outside-model warnings (rayverb.cpp:547-583)."""
        lo, hi = self.scene.bounds
        for name, p in (("microphone", micpos), ("source", source)):
            if not bool(np.all((lo <= p) & (p <= hi))):
                print(
                    f"WARNING: {name} position may be outside model: "
                    f"{p.tolist()} not in [{lo.tolist()}, {hi.tolist()}]",
                    file=sys.stderr,
                )

    @property
    def outputs(self) -> TraceOutputs:
        if self._outputs is None:
            raise RuntimeError("raytrace() has not been run")
        return self._outputs

    def get_raw_diffuse(self) -> RaytracerResults:
        """(rayverb.cpp:687-690): all N*R diffuse impulses, zeros included,
        as host arrays."""
        o = self.outputs
        n, r = o.diffuse_time.shape
        return RaytracerResults(
            volume=o.diffuse_volume.reshape(n * r, -1).cpu().numpy(),
            position=o.diffuse_position.reshape(n * r, 3).cpu().numpy(),
            time=o.diffuse_time.reshape(n * r).cpu().numpy(),
            mic=self._mic,
        )

    def get_raw_images(self, remove_direct: bool) -> RaytracerResults:
        """(rayverb.cpp:692-706): deduplicated image-source impulses, as
        host arrays."""
        vol, pos, tim = dedup_images(self.outputs, remove_direct)
        return RaytracerResults(volume=vol, position=pos, time=tim, mic=self._mic)

    def get_all_raw(self, remove_direct: bool) -> RaytracerResults:
        """(rayverb.cpp:708-714): diffuse followed by images."""
        d = self.get_raw_diffuse()
        i = self.get_raw_images(remove_direct)
        return RaytracerResults(
            volume=np.concatenate([d.volume, i.volume], axis=0),
            position=np.concatenate([d.position, i.position], axis=0),
            time=np.concatenate([d.time, i.time], axis=0),
            mic=self._mic,
        )
