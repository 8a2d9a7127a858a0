"""Closest-hit sweep of the PyTorch port vs the JAX package.

The port's plain sweep (the CUDA kernel's plain version, same arithmetic)
is held against the Pallas kernel in interpret mode and against the XLA
Moller-Trumbore sweep with the tolerance of tests/test_intersect_pallas.py:
hit flags and triangle indices equal, t within rtol=1e-5. The CUDA kernel
itself runs only on a GPU; chip_smoke.py holds it against the plain
version there, bit for bit."""

import sys

import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene as jax_load_scene
from rayverb_tpu.ops import intersect as jax_isect
from rayverb_tpu.ops.intersect_pallas import closest_hit_pallas
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.params import SOUP_FIELDS, soup_from_numpy, soup_to_numpy
from rayverb_tpu_torch.scene import load_scene as port_load_scene

torch.set_num_threads(1)

SCENES = ["large_square", "bedroom", "random_pillars", "vault"]


def _scene(assets_dir, name):
    return jax_load_scene(
        str(assets_dir / "test_models" / f"{name}.obj"),
        str(assets_dir / "materials" / "mat.json"),
    )


def _rays(rng, n, center, spread):
    o = (rng.uniform(-spread, spread, (n, 3)) + center).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_hits_agree(got, ref_hit, ref_t, ref_index, rtol):
    hit = np.asarray(ref_hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(
        got.t.numpy()[hit], np.asarray(ref_t)[hit], rtol=rtol
    )
    np.testing.assert_array_equal(
        got.index.numpy()[hit], np.asarray(ref_index)[hit]
    )


@pytest.mark.parametrize("name", SCENES)
def test_sweep_table_byte_equal(assets_dir, name):
    scene = _scene(assets_dir, name)
    jp, ja = jax_isect.build_sweep_table(scene.v0, scene.e0, scene.e1)
    pp, pa = port_isect.build_sweep_table(scene.v0, scene.e0, scene.e1)
    assert pp.tobytes() == jp.tobytes() and pp.shape == jp.shape
    assert pa.tobytes() == ja.tobytes() and pa.shape == ja.shape


@pytest.mark.parametrize("name", SCENES)
def test_soup_from_scene_byte_equal(assets_dir, name):
    scene = _scene(assets_dir, name)
    want = jax_isect.soup_from_scene(scene)
    got = soup_to_numpy(port_isect.soup_from_scene(scene, device="cpu"))
    for field in SOUP_FIELDS:
        w = np.asarray(getattr(want, field))
        assert got[field].dtype == w.dtype, field
        assert got[field].shape == w.shape, field
        assert got[field].tobytes() == w.tobytes(), field


def test_soup_carried_across_from_jax(assets_dir):
    """The JAX soup's fields, handed over as numpy, make the same soup as
    the port's own soup_from_scene."""
    scene = _scene(assets_dir, "random_pillars")
    jsoup = jax_isect.soup_from_scene(scene)
    carried = soup_from_numpy(
        device="cpu", **{k: np.asarray(getattr(jsoup, k)) for k in SOUP_FIELDS}
    )
    own = port_isect.soup_from_scene(scene, device="cpu")
    for field in SOUP_FIELDS:
        assert torch.equal(getattr(carried, field), getattr(own, field)), field


def test_port_scene_loader_matches(assets_dir):
    """The port's pure-Python OBJ path compiles the same scene arrays."""
    for name in ("bedroom", "vault"):
        want = _scene(assets_dir, name)
        got = port_load_scene(
            str(assets_dir / "test_models" / f"{name}.obj"),
            str(assets_dir / "materials" / "mat.json"),
        )
        np.testing.assert_array_equal(got.tri_verts, want.tri_verts)
        np.testing.assert_array_equal(got.tri_surface, want.tri_surface)
        np.testing.assert_array_equal(got.specular, want.specular)


@pytest.mark.parametrize(
    "name, center, spread, n",
    [("large_square", [0.0, 10.0, 0.0], 5.0, 7),
     ("large_square", [0.0, 10.0, 0.0], 5.0, 300),
     ("random_pillars", None, 3.0, 300)],
)
def test_plain_matches_pallas_interpret(assets_dir, rng, name, center, spread, n):
    scene = _scene(assets_dir, name)
    if center is None:
        center = scene.bounds.mean(axis=0)
    o, d = _rays(rng, n, np.asarray(center, np.float32), spread)
    ref = closest_hit_pallas(o, d, jax_isect.soup_from_scene(scene), interpret=True)
    got = port_isect.closest_hit(
        torch.from_numpy(o), torch.from_numpy(d),
        port_isect.soup_from_scene(scene, device="cpu"), impl="plain",
    )
    _assert_hits_agree(got, ref.hit, ref.t, ref.index, rtol=1e-5)


@pytest.mark.parametrize("name, spread", [("large_square", 5.0), ("random_pillars", 3.0)])
def test_plain_matches_xla(assets_dir, rng, name, spread):
    scene = _scene(assets_dir, name)
    center = scene.bounds.mean(axis=0)
    o, d = _rays(rng, 400, center, spread)
    ref = jax_isect.closest_hit_xla(o, d, jax_isect.soup_from_scene(scene))
    got = port_isect.closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), port_isect.soup_from_scene(scene, device="cpu")
    )
    _assert_hits_agree(got, ref.hit, ref.t, ref.index, rtol=1e-5)


def test_t_max_is_inclusive(assets_dir, rng):
    """A hit exactly at t_max is kept; a bound just below it drops it
    (the XLA sweep's t <= t_max)."""
    scene = _scene(assets_dir, "random_pillars")
    soup = port_isect.soup_from_scene(scene, device="cpu")
    o, d = _rays(rng, 200, scene.bounds.mean(axis=0), 3.0)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    free = port_isect.closest_hit(o, d, soup)
    assert bool(free.hit.any())
    t = torch.where(free.hit, free.t, 1.0)
    at = port_isect.closest_hit(o, d, soup, t_max=t)
    assert torch.equal(at.hit, free.hit)
    assert torch.equal(at.index[free.hit], free.index[free.hit])
    below = port_isect.closest_hit(o, d, soup, t_max=torch.nextafter(t, torch.zeros_like(t)))
    # only another triangle strictly nearer could still be found: none is
    assert not bool(below.hit[free.hit].any())


def test_decide_verdicts_match(large_square_soup, large_square_scene, rng):
    """Any-hit rows (t_decide) give the same visibility verdict as the
    exact XLA sweep, as in test_decide_mode_verdicts_match."""
    soup = port_isect.soup_from_scene(large_square_scene, device="cpu")
    center = np.asarray(large_square_soup.bounds).mean(axis=0)
    o = (center + (rng.random((256, 3)) - 0.5) * 4.0).astype(np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mag = (0.5 + 4.0 * rng.random(256)).astype(np.float32)
    bound = mag * np.float32(1.001) + np.float32(0.01)
    ref = jax_isect.closest_hit_xla(o, d, large_square_soup, t_max=bound)
    got = port_isect.closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), soup,
        t_max=torch.from_numpy(bound), t_decide=torch.from_numpy(mag),
    )
    vis_ref = (~np.asarray(ref.hit)) | (np.asarray(ref.t) > mag)
    vis_got = (~got.hit.numpy()) | (got.t.numpy() > mag)
    np.testing.assert_array_equal(vis_got, vis_ref)


def test_decided_rows_stop_refining(assets_dir, rng):
    """A row whose running best drops below t_decide takes part in no
    further block: it executes no more pair tests than the exact row and
    its witness still lies before the threshold."""
    scene = _scene(assets_dir, "random_pillars")
    soup = port_isect.soup_from_scene(scene, device="cpu")
    o, d = _rays(rng, 300, scene.bounds.mean(axis=0), 3.0)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    inf = torch.full((300,), float("inf"))
    exact, ex_pairs = port_isect.closest_hit(o, d, soup, with_stats=True)
    decide = torch.where(exact.hit, exact.t * 1.5, 0.0)
    got, got_pairs = port_isect.closest_hit(
        o, d, soup, t_max=inf, t_decide=decide, with_stats=True
    )
    assert torch.equal(got.hit, exact.hit)
    assert bool((got.t[exact.hit] < decide[exact.hit]).all())
    assert bool((got_pairs <= ex_pairs).all())
    assert int(got_pairs.sum()) < int(ex_pairs.sum())


def test_cuda_impl_on_cpu_tensor_raises(large_square_scene):
    soup = port_isect.soup_from_scene(large_square_scene, device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    with pytest.raises(ValueError, match="CUDA"):
        port_isect.closest_hit(o, d, soup, impl="cuda")
    with pytest.raises(ValueError):
        port_isect.closest_hit(o, d, soup, impl="pallas")


def test_intersect_cuda_imports_without_nvcc():
    """Importing the kernel's wrapper builds nothing and needs no nvcc."""
    import importlib

    mod = importlib.import_module("rayverb_tpu_torch.ops.intersect_cuda")
    assert mod._fn is None
    assert isinstance(mod.launches, int)
    assert "triton" not in sys.modules


def test_executed_pairs_bounded_by_issued(assets_dir, rng):
    scene = _scene(assets_dir, "random_pillars")
    soup = port_isect.soup_from_scene(scene, device="cpu")
    o, d = _rays(rng, 128, scene.bounds.mean(axis=0), 3.0)
    _, pairs = port_isect.closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), soup, with_stats=True
    )
    assert bool((pairs % port_isect.SWEEP_BLOCK == 0).all())
    assert int(pairs.max()) <= soup.num_padded
    assert int(pairs.sum()) > 0


def test_visible_matches_xla(large_square_scene, large_square_soup, rng):
    soup = port_isect.soup_from_scene(large_square_scene, device="cpu")
    center = np.asarray(large_square_soup.bounds).mean(axis=0)
    a = (center + (rng.random((200, 3)) - 0.5) * 6.0).astype(np.float32)
    b = (center + (rng.random((200, 3)) - 0.5) * 6.0).astype(np.float32)
    want = np.asarray(jax_isect.visible(a, b, large_square_soup, impl="xla"))
    got = port_isect.visible(torch.from_numpy(a), torch.from_numpy(b), soup).numpy()
    np.testing.assert_array_equal(got, want)
