"""The port's public names against the JAX package's: the top-level and
``parallel`` exports, ``utils.sphere_point`` and
``ops.intersect.soup_from_arrays``."""

import numpy as np
import torch

import rayverb_tpu
import rayverb_tpu.parallel
import rayverb_tpu_torch
import rayverb_tpu_torch.parallel
from rayverb_tpu.ops import intersect as jax_intersect
from rayverb_tpu.utils import sphere_point as jax_sphere_point
from rayverb_tpu_torch.ops import intersect as port_intersect
from rayverb_tpu_torch.params import SOUP_FIELDS, soup_to_numpy
from rayverb_tpu_torch.utils import sphere_point


def _exported(module):
    return {name for name in dir(module) if not name.startswith("_")} - {
        "annotations", "datagen", "sharded"}


def test_top_level_all_matches_jax():
    assert set(rayverb_tpu_torch.__all__) == set(rayverb_tpu.__all__)
    for name in rayverb_tpu_torch.__all__:
        assert hasattr(rayverb_tpu_torch, name), name


def test_parallel_exports_match_jax():
    assert _exported(rayverb_tpu_torch.parallel) == _exported(rayverb_tpu.parallel)
    assert set(rayverb_tpu_torch.parallel.__all__) == _exported(rayverb_tpu.parallel)
    assert {"make_mesh", "shard_rays", "render_fused_sharded"} <= set(
        rayverb_tpu_torch.parallel.__all__)


def test_sphere_point_matches_jax():
    rng = np.random.default_rng(11)
    z = rng.uniform(-1.0, 1.0, (7, 33)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (7, 33)).astype(np.float32)
    want = np.asarray(jax_sphere_point(z, theta))
    got = sphere_point(torch.from_numpy(z), torch.from_numpy(theta))
    assert got.shape == (7, 33, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_soup_from_arrays_matches_jax(large_square_scene):
    s = large_square_scene
    arrays = (s.v0, s.e0, s.e1, s.tri_surface, s.specular, s.diffuse)
    want = jax_intersect.soup_from_arrays(*arrays)
    got = soup_to_numpy(port_intersect.soup_from_arrays(*arrays, device="cpu"))
    for field in SOUP_FIELDS:
        w = np.asarray(getattr(want, field))
        assert got[field].dtype == w.dtype, field
        np.testing.assert_array_equal(got[field], w, err_msg=field)
    assert got["packed"].tobytes() == np.asarray(want.packed).tobytes()
    assert got["block_aabb"].tobytes() == np.asarray(want.block_aabb).tobytes()


def test_soup_from_scene_is_soup_from_arrays(large_square_scene):
    s = large_square_scene
    a = soup_to_numpy(port_intersect.soup_from_scene(s, device="cpu"))
    b = soup_to_numpy(port_intersect.soup_from_arrays(
        s.v0, s.e0, s.e1, s.tri_surface, s.specular, s.diffuse, device="cpu"))
    for field in SOUP_FIELDS:
        assert a[field].tobytes() == b[field].tobytes(), field
