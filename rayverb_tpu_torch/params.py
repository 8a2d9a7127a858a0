"""State carried across from the JAX package.

The system has no weights: its state is the compiled scene. These are the
fields of the JAX ``TriangleSoup`` (rayverb_tpu/ops/intersect.py:31-72):
triangle geometry, surface tables and the sweep kernel's packed Woop table
with its block AABBs. ``soup_from_numpy`` builds the port's soup from them
as numpy arrays (deriving from the block AABBs the superblocks' boxes of
the order kernel's cull), so a soup built by either package can be handed
to the other and compared byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.intersect import SWEEP_BLOCK, TriangleSoup, super_aabb

SOUP_FIELDS = (
    "v0", "e0", "e1", "normal", "surface", "specular", "diffuse",
    "packed", "block_aabb", "bounds",
)


def soup_from_numpy(*, device=None, **fields) -> TriangleSoup:
    """TriangleSoup on ``device`` (None: the card, device.resolve_device)
    from the soup's numpy fields (float32, surface integer). Checks the
    sweep table's shape against SWEEP_BLOCK."""
    missing = set(SOUP_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing soup fields: {sorted(missing)}")
    dev = resolve_device(device)
    packed = np.asarray(fields["packed"], np.float32)
    aabb = np.asarray(fields["block_aabb"], np.float32)
    if packed.ndim != 2 or packed.shape[1] != 16:
        raise ValueError(f"packed must be (Tp, 16), got {packed.shape}")
    if aabb.shape != (packed.shape[0] // SWEEP_BLOCK, 8) or (
        packed.shape[0] % SWEEP_BLOCK
    ):
        raise ValueError(
            f"block_aabb {aabb.shape} does not match packed {packed.shape} "
            f"in blocks of {SWEEP_BLOCK}"
        )

    def f32(name):
        return torch.from_numpy(np.array(fields[name], np.float32)).to(dev)

    # checked here once: the order kernel reads the boxes as float4 on
    # every call (intersect_cuda.block_order_cuda)
    boxes = torch.from_numpy(super_aabb(aabb)).to(dev)
    if boxes.data_ptr() % 16:
        raise ValueError("super_aabb must be 16-byte aligned")
    return TriangleSoup(
        v0=f32("v0"),
        e0=f32("e0"),
        e1=f32("e1"),
        normal=f32("normal"),
        surface=torch.from_numpy(
            np.asarray(fields["surface"]).astype(np.int64)
        ).to(dev),
        specular=f32("specular"),
        diffuse=f32("diffuse"),
        packed=f32("packed"),
        block_aabb=f32("block_aabb"),
        bounds=f32("bounds"),
        super_aabb=boxes,
    )


def soup_to_numpy(soup: TriangleSoup) -> dict:
    """The soup's fields as host numpy arrays (surface as int32, as in the
    JAX package)."""
    out = {k: getattr(soup, k).cpu().numpy() for k in SOUP_FIELDS}
    out["surface"] = out["surface"].astype(np.int32)
    return out
