"""Ray directions of the PyTorch port vs the JAX package: the same seed
gives the same directions, bit for bit; and the renders' Morton order on
tensors against the numpy one."""

import numpy as np
import pytest
import torch

from rayverb_tpu.utils import directions as jax_dirs
from rayverb_tpu_torch.utils import directions as port_dirs


@pytest.mark.parametrize("num, seed", [(1, 0), (777, 7), (4096, None), (50000, 123)])
def test_random_directions_bit_identical(num, seed):
    want = jax_dirs.random_directions(num, seed=seed)
    got = port_dirs.random_directions(num, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("num", [1, 300, 4096])
def test_uniform_directions_bit_identical(num):
    assert (
        port_dirs.uniform_directions(num).tobytes()
        == jax_dirs.uniform_directions(num).tobytes()
    )


@pytest.mark.parametrize("num, seed", [(300, 3), (5000, 11)])
def test_morton_sort_bit_identical(num, seed):
    d = jax_dirs.random_directions(num, seed=seed)
    assert port_dirs.morton_sort(d).tobytes() == jax_dirs.morton_sort(d).tobytes()


def test_morton_codes_match_sweep_table_codes(rng):
    """The port's own copy of _morton3 equals the JAX sweep table's."""
    from rayverb_tpu.ops.intersect import _morton3 as jax_morton3

    q = rng.integers(0, 1024, size=(1000, 3)).astype(np.uint32)
    np.testing.assert_array_equal(port_dirs._morton3(q), jax_morton3(q))


# ---------------------------------------------------------------------------
# the renders' Morton order, made on the directions' device, against the
# numpy permutation the tools and the JAX package use
# ---------------------------------------------------------------------------

def _edge_directions() -> np.ndarray:
    """The six axis directions, then coordinates at and one float32 step
    either side of the quantisation edges k / 1023 * 2 - 1 (k = 0..1023,
    so d = -1, 1 and the cells around 0), each row repeated twice."""
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    edges = (np.arange(1024, dtype=np.float32) / np.float32(1023.0)) * 2 - 1
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(-2)),
                            np.nextafter(edges, np.float32(2)),
                            np.float32([-1, 0, 1, -0.0])])
    rng = np.random.default_rng(3)
    coords = rng.choice(edges, size=(4000, 3)).astype(np.float32)
    return np.concatenate([axes, coords, coords, axes])


def _many_repeats() -> np.ndarray:
    """3,000 rays drawn from 40 directions: long runs of equal keys."""
    d = port_dirs.random_directions(40, seed=9)
    return d[np.random.default_rng(4).integers(0, 40, 3000)]


@pytest.mark.parametrize("case", ["random_2047", "random_2048", "random_100000",
                                  "edges", "repeats"])
def test_morton_order_torch_equals_numpy(case):
    """morton_order_torch gives morton_order's permutation exactly (a
    stable sort of the same keys), and its keys are _morton3's."""
    if case.startswith("random"):
        d = port_dirs.random_directions(int(case.split("_")[1]), seed=17)
    else:
        d = _edge_directions() if case == "edges" else _many_repeats()
    want = port_dirs.morton_order(d)
    got = port_dirs.morton_order_torch(torch.from_numpy(d))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    q = np.clip((d + 1.0) * 0.5 * 1023.0, 0, 1023).astype(np.uint32)
    np.testing.assert_array_equal(port_dirs.morton_keys(d).numpy(),
                                  port_dirs._morton3(q).astype(np.int64))


@pytest.mark.parametrize("pairs, rays", [(1, 2048), (3, 2048), (5, 777)])
def test_morton_order_torch_pair_major(pairs, rays):
    """(B, N, 3) ray sets: the (B * N,) permutation is each set's numpy
    order, offset by its first row, stacked in pair order."""
    d = np.stack([port_dirs.random_directions(rays, seed=s) for s in range(pairs)])
    d[-1, : rays // 2] = d[-1, 0]  # equal keys within a set, and across sets
    d[0, :10] = d[-1, 0]
    want = np.concatenate([port_dirs.morton_order(x) + b * rays for b, x in enumerate(d)])
    got = port_dirs.morton_order_torch(torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rays", [2047, 2048, 5000])
def test_ray_schedule_orders_from_2048_rays(rays):
    """render.ray_schedule takes the Morton order from 4 x RAY_BLOCK_SORT
    rays per set (None below), on tensors, single and batched."""
    from rayverb_tpu_torch.ops.render import RAY_BLOCK_SORT, ray_schedule

    assert 4 * RAY_BLOCK_SORT == 2048
    d = np.stack([port_dirs.random_directions(rays, seed=s) for s in (1, 2)])
    order, _ = ray_schedule(torch.from_numpy(d[0]), 32)
    orders, _ = ray_schedule(torch.from_numpy(d), 32)
    if rays < 2048:
        assert order is None and orders is None
        return
    np.testing.assert_array_equal(order.numpy(), port_dirs.morton_order(d[0]))
    np.testing.assert_array_equal(orders.numpy(), np.concatenate(
        [port_dirs.morton_order(x) + b * rays for b, x in enumerate(d)]))
