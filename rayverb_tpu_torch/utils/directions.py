"""Ray-direction generation (numpy), a copy of rayverb_tpu/utils/directions.py
(:26-79) without its JAX variant, and ``sphere_point`` and the Morton ray
order (``morton_order_torch``) on tensors.

The reference draws uniform sphere points via the z/theta parameterisation
with a wall-clock-seeded std RNG (reference rayverb/helpers.cpp:62-81). Here
the generator is a numpy ``default_rng`` with an explicit seed, so the same
seed gives the same directions, bit for bit, as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 3x10-bit quantized coordinates into 30-bit Morton codes.
    q: (T, 3) uint32 in [0, 1024). (A copy of rayverb_tpu/ops/intersect.py:78.)"""

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def sphere_point(z, theta):
    """Point on the unit sphere from z in [-1,1], theta in [-pi,pi]
    (helpers.cpp:62-67; rayverb_tpu/utils/directions.py:19), on tensors:
    (..., 3) from (...) each."""
    z = torch.as_tensor(z)
    theta = torch.as_tensor(theta)
    zt = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([zt * torch.cos(theta), zt * torch.sin(theta), z], dim=-1)


def random_directions(num: int, seed: int | None = None) -> np.ndarray:
    """(num, 3) float32 uniformly distributed unit vectors
    (helpers.cpp:69-81, made deterministic)."""
    rng = np.random.default_rng(0 if seed is None else seed)
    z = rng.uniform(-1.0, 1.0, num)
    theta = rng.uniform(-np.pi, np.pi, num)
    zt = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack(
        [zt * np.cos(theta), zt * np.sin(theta), z], axis=-1
    ).astype(np.float32)


def uniform_directions(num: int) -> np.ndarray:
    """(num, 3) float32 deterministic quasi-uniform directions via the
    Fibonacci sphere lattice (the reference's undefined
    `getUniformDirections`, helpers.h:30)."""
    i = np.arange(num, dtype=np.float64) + 0.5
    z = 1.0 - 2.0 * i / num
    theta = np.pi * (1.0 + 5.0**0.5) * i
    zt = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack(
        [zt * np.cos(theta), zt * np.sin(theta), z], axis=-1
    ).astype(np.float32)


def morton_order(directions: np.ndarray) -> np.ndarray:
    """The permutation of morton_sort: indices that order unit directions
    along a Morton (Z-order) curve (stable). The renders take the same
    permutation from morton_order_torch, on the directions' device."""
    d = np.asarray(directions, np.float32)
    q = np.clip((d + 1.0) * 0.5 * 1023.0, 0, 1023).astype(np.uint32)
    return np.argsort(_morton3(q), kind="stable")


def morton_sort(directions: np.ndarray) -> np.ndarray:
    """Reorder unit directions along a Morton (Z-order) curve so that
    consecutive rays point into nearby solid angles. Ray order carries no
    meaning; neighbouring rays in one thread block then share the triangle
    tiles they need, which is what the sweep kernel's tile skip feeds on."""
    d = np.asarray(directions, np.float32)
    return d[morton_order(d)]


def _spread10(x: torch.Tensor) -> torch.Tensor:
    """_morton3's bit spread of 10-bit values, on int64 tensors."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_keys(directions) -> torch.Tensor:
    """morton_order's 30-bit Morton codes of (..., 3) unit directions, as
    (...) int64 on their device: the same float32 quantisation, truncated,
    and the same interleave, so the same keys bit for bit."""
    d = torch.as_tensor(directions, dtype=torch.float32)
    q = torch.clamp((d + 1.0) * 0.5 * 1023.0, 0, 1023).to(torch.int64)
    return _spread10(q[..., 0]) | (_spread10(q[..., 1]) << 1) | (_spread10(q[..., 2]) << 2)


def morton_order_torch(directions) -> torch.Tensor:
    """morton_order on the directions' device: for (N, 3) directions the
    same (N,) int64 permutation. For (B, N, 3) ray sets, the permutation of
    their (B * N, 3) rows, pair-major, each set in its own Morton order:
    morton_order of each set, offset by b * N and concatenated, taken in
    one stable sort of (b << 32) | key."""
    key = morton_keys(directions)
    if key.ndim == 2:
        pair = torch.arange(key.shape[0], device=key.device)
        key = ((pair[:, None] << 32) | key).reshape(-1)
    return torch.argsort(key, stable=True)
