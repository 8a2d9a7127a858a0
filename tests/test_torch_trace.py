"""The PyTorch port's trace vs the JAX package's.

Sort keys, shadow rows and chain hashes are bit-equal on the same inputs.
Whole traces are compared record by record:
  - against JAX trace_chunk(impl="xla") (Moller-Trumbore sweep): on the
    box (large_square) every record; on the bedroom the diffuse records.
    The bedroom's walls are fan-triangulated into overlapping coplanar
    triangles, where the XLA sweep and the Woop-row sweep of the kernel
    (and of its plain version here) round t differently and so break the
    lowest-index tie toward different triangles: image records there are
    compared against the Pallas kernel instead.
  - against JAX trace_chunk(impl="pallas") in interpret mode (the kernel's
    own arithmetic) on the bedroom: every record.
Tolerances: diffuse and image volumes atol 1e-6 (unit-scale gains);
diffuse positions atol 1e-4 m (0.1 mm: intersection points of equivalent
but differently rounded sweeps); image-source positions atol 1e-3 m (image
sources lie tens of metres out, mirrored through up to 8 planes in float32:
1 mm is ~1e-5 of their distance); times atol 1e-6 s; image triangle
indices equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayverb_tpu import load_scene
from rayverb_tpu.ops import intersect as jax_isect
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.ops import trace as jax_trace
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace

torch.set_num_threads(1)

# mic and source a hair off the box's symmetry planes (see
# tests/test_intersect_pallas.py::test_trace_with_pallas_impl_matches)
BOX = ("large_square", [0.013, 2.017, 0.021], [0.031, 1.989, 2.007])
BEDROOM = ("bedroom", [0.013, 0.017, 2.021], [0.031, -0.011, 0.007])

ATOL = {
    "diffuse_volume": 1e-6,
    "diffuse_position": 1e-4,
    "diffuse_time": 1e-6,
    "image_volume": 1e-6,
    "image_position": 1e-3,
    "image_time": 1e-6,
}


@pytest.fixture(scope="module")
def scenes(assets_dir):
    out = {}
    for name in ("large_square", "bedroom"):
        scene = load_scene(
            str(assets_dir / "test_models" / f"{name}.obj"),
            str(assets_dir / "materials" / "mat.json"),
        )
        out[name] = (
            scene,
            jax_isect.soup_from_scene(scene),
            port_isect.soup_from_scene(scene, device="cpu"),
        )
    return out


def _compare(want, got, fields):
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape, f
        if f == "image_index":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL[f], err_msg=f)


def _both(scenes, where, impl, nrays, nrefl, seed):
    name, mic, src = where
    _, jsoup, psoup = scenes[name]
    dirs = random_directions(nrays, seed=seed)
    mic = np.float32(mic)
    src = np.float32(src)
    want = jax_trace.trace_chunk(jsoup, mic, src, dirs, nreflections=nrefl, impl=impl)
    got = port_trace.trace_chunk(psoup, mic, src, dirs, nreflections=nrefl)
    return want, got


def test_trace_matches_xla_box(scenes):
    want, got = _both(scenes, BOX, "xla", 300, 6, 5)
    _compare(want, got, want._fields)
    assert int((got.image_index[:, 1:] != 0).sum()) > 50  # images exercised


def test_trace_diffuse_matches_xla_bedroom(scenes):
    want, got = _both(scenes, BEDROOM, "xla", 300, 4, 5)
    _compare(want, got, ["diffuse_volume", "diffuse_position", "diffuse_time"])


def test_trace_matches_pallas_interpret_bedroom(scenes):
    want, got = _both(scenes, BEDROOM, "pallas", 128, 4, 3)
    _compare(want, got, want._fields)
    assert int((got.image_index[:, 1:] != 0).sum()) > 20


def test_resort_is_invisible(scenes):
    """Sorting the bounce sweeps' rows by the mix6 key changes no record."""
    name, mic, src = BEDROOM
    _, _, psoup = scenes[name]
    dirs = random_directions(256, seed=9)
    a = port_trace.trace_chunk(psoup, mic, src, dirs, nreflections=12)
    b = port_trace.trace_chunk(psoup, mic, src, dirs, nreflections=12, resort=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_trace_without_resort_equals_default_and_jax(scenes):
    """The trace without its between-bounce resort: the resorted trace's
    records bit for bit, and JAX _trace_impl's with resort=False (on the
    XLA sweep; its resort needs the consume path) at the stated
    tolerances. The box's table is smaller than the 32 blocks from which
    renders resort, so the traces are asked for resort directly."""
    name, mic, src = BOX
    _, jsoup, psoup = scenes[name]
    nrays, nrefl = 512, 6
    dirs = random_directions(nrays, seed=3)
    mic, src = np.float32(mic), np.float32(src)

    def port(resort):
        return port_trace._trace_impl(psoup, mic, src, dirs, nreflections=nrefl,
                                      impl="plain", resort=resort)

    @jax.jit
    def run(soup, d):
        aux, images, _ = jax_trace._trace_impl(
            soup, mic, src, d, nreflections=nrefl, impl="xla",
            consume_row=jax_render._collect_row,
            aux0=jax_render._row_buffers(nrefl, d.shape[0]),
            nvalid=np.int32(d.shape[0]), resort=False,
        )
        return aux[:3], images

    got, default = port(False), port(True)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(default, f)), f
    rows, images = run(jsoup, jnp.asarray(dirs))
    diffuse = ("diffuse_volume", "diffuse_position", "diffuse_time")
    want = {f: np.moveaxis(np.asarray(r), 0, 1) for f, r in zip(diffuse, rows)}
    want.update({f: np.asarray(x) for f, x in
                 zip(("image_volume", "image_position", "image_time", "image_index"), images)})
    _compare(type(got)(**want), got, got._fields)
    assert int((got.image_index[:, 1:] != 0).sum()) > 50  # images exercised


def test_sweep_count_matches_closest_hit_calls(scenes, monkeypatch):
    name, mic, src = BOX
    _, _, psoup = scenes[name]
    calls = []
    real = port_trace.closest_hit
    monkeypatch.setattr(
        port_trace, "closest_hit", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    port_trace.trace_chunk(psoup, mic, src, random_directions(64, seed=1), nreflections=11)
    assert len(calls) == port_trace.sweep_count(11) == 23


def test_sort_keys_bit_equal(rng):
    n = 5000
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:7] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1], [1, 1, 1], [-1, -1, -1]]
    pos = rng.uniform(-3, 13, (n, 3)).astype(np.float32)
    lo = np.float32([-2.0, -1.0, 0.5])
    inv_span = (1.0 / np.float32([12.0, 7.5, 9.0])).astype(np.float32)
    want = np.asarray(jax_trace._dir_morton(jnp.asarray(d))).astype(np.int64)
    got = port_trace._dir_morton(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(
        jax_trace._ray_sort_key(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(inv_span))
    ).astype(np.int64)
    got = port_trace._ray_sort_key(
        torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(lo), torch.from_numpy(inv_span)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() > (1 << 31)  # the top bit is exercised
    for x in (0, 1, 0x1FF, 0x155, 0xABCD, 0xFFFF):
        xs = np.array([x], np.uint32)
        assert int(port_trace._spread9(torch.tensor([x]))[0]) == int(
            np.asarray(jax_trace._spread9(jnp.asarray(xs)))[0]
        )


def test_shadow_rows_bit_equal(rng):
    n = 1000
    mic = np.float32([0.5, 1.5, 2.0])
    inter = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.8
    mag = np.linalg.norm(inter - mic, axis=1).astype(np.float32)
    want = jax_trace._shadow_rows(
        jnp.asarray(mic), jnp.asarray(inter), jnp.asarray(alive), jnp.asarray(mag)
    )
    got = port_trace._shadow_rows(
        torch.from_numpy(mic), torch.from_numpy(inter), torch.from_numpy(alive), torch.from_numpy(mag)
    )
    # permutation, bounds and thresholds identical; directions within one
    # rounding of the normalisation
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_chain_hashes_bit_equal(rng):
    idx = rng.integers(0, 1 << 20, size=(500, 10)).astype(np.int32)
    idx[:, 5:] *= rng.random((500, 5)) < 0.5
    idx[0] = [0x7FFFFFFF, 0, 1, 2, 3, 4, 5, 6, 7, 8]
    w1, w2 = jax_render.chain_hashes(jnp.asarray(idx))
    g1, g2 = port_render.chain_hashes(torch.from_numpy(idx))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1).astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2).astype(np.int64))
