"""Ray directions of the PyTorch port vs the JAX package: the same seed
gives the same directions, bit for bit."""

import numpy as np
import pytest

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
