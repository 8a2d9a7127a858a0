"""On the card: the renders' Morton ray order, made by torch ops on the
CUDA device (a CUB radix sort), is the numpy morton_order's permutation
exactly, at the north star's million rays and at batched datagen's 64 ray
sets of 4,096. This file imports no JAX; on the card run

    python -m pytest --noconftest -m card tests/test_torch_directions_card.py

Each test skips without a CUDA card."""

import numpy as np
import pytest
import torch

from rayverb_tpu_torch.utils.directions import morton_order, morton_order_torch, random_directions


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this holds the CUDA sort to the host's")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("pairs, rays", [(None, 1 << 20), (64, 4096)])
def test_cuda_morton_order_equals_numpy(card, pairs, rays):
    if pairs is None:
        d = random_directions(rays, seed=29)
        want = morton_order(d)
    else:
        d = np.stack([random_directions(rays, seed=s) for s in range(pairs)])
        want = np.concatenate([morton_order(x) + b * rays for b, x in enumerate(d)])
    got = morton_order_torch(torch.from_numpy(d).to(card))
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
