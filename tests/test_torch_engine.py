"""The port's engine (rayverb_tpu_torch/engine.py) and its dense trace
(ops/trace.py::trace) against the JAX package's.

- dedup_select: index for index on real trace image tables (both packages
  fed the same table), and the port's numpy chain hash against its
  render.chain_hashes
- assemble_population for the three output modes, on the same trace
  outputs: exact (gathers and concatenations of the same values)
- save_raw / load_raw: round trip, and files written by either package
  loaded by the other, exactly
- the dense trace: a chunked trace and a trace in Morton order equal the
  unchunked trace_chunk bit for bit; against JAX's trace with the
  tolerances of tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch

from rayverb_tpu import engine as je
from rayverb_tpu import load_scene
from rayverb_tpu.config.schema import OutputMode as JaxMode
from rayverb_tpu.ops import intersect as jax_isect
from rayverb_tpu.ops import trace as jax_trace
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch import engine as pe
from rayverb_tpu_torch.config.schema import OutputMode as PortMode
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace

torch.set_num_threads(1)

MIC = [0.013, 2.017, 0.021]
SRC = [0.031, 1.989, 2.007]
ATOL = {"volume": 1e-6, "position": 1e-4, "time": 1e-6}


@pytest.fixture(scope="module")
def box(assets_dir):
    scene = load_scene(
        str(assets_dir / "test_models" / "large_square.obj"),
        str(assets_dir / "materials" / "mat.json"),
    )
    return scene, jax_isect.soup_from_scene(scene), port_isect.soup_from_scene(scene, device="cpu")


@pytest.fixture(scope="module")
def jax_outputs(box):
    _, jsoup, _ = box
    dirs = random_directions(400, seed=4)
    return jax_trace.trace_chunk(jsoup, np.float32(MIC), np.float32(SRC), dirs,
                                 nreflections=8, impl="xla")


def _port_outputs(jout):
    """The JAX trace's outputs as the port's TraceOutputs (CPU tensors)."""
    fields = [torch.from_numpy(np.array(x)) for x in jout]
    fields[-1] = fields[-1].long()
    return port_trace.TraceOutputs(*fields)


@pytest.mark.parametrize("remove_direct", [False, True])
def test_dedup_select_matches_jax(jax_outputs, remove_direct):
    idx = np.asarray(jax_outputs.image_index)
    assert int((idx[:, 1:] != 0).sum()) > 100
    gr, gs = pe.dedup_select(idx.astype(np.int64), remove_direct)
    wr, ws = je.dedup_select(idx, remove_direct)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gs, ws)
    assert 0 < len(gr) < int((idx != 0).sum()) + len(idx)


def test_dedup_select_synthetic_duplicates():
    """Shared prefixes, repeated chains, zero slots after a real surface
    and an empty table."""
    idx = np.array([
        [0, 5, 7, 0, 0],
        [0, 5, 7, 0, 0],
        [0, 5, 8, 3, 0],
        [0, 2, 0, 9, 0],
        [0, 0, 0, 0, 0],
    ])
    for rd in (False, True):
        for g, w in zip(pe.dedup_select(idx, rd), je.dedup_select(idx, rd)):
            np.testing.assert_array_equal(g, w)
    r, s = pe.dedup_select(np.zeros((0, 10), np.int64), True)
    assert r.size == s.size == 0


def test_mix32_np_matches_chain_hashes(rng):
    idx = rng.integers(0, 5000, size=(64, 10))
    h1, h2 = port_render.chain_hashes(torch.from_numpy(idx))
    u = idx.astype(np.uint32)
    a = np.full(64, 0x9E3779B9, np.uint32)
    b = np.full(64, 0x85EBCA6B, np.uint32)
    for k in range(10):
        a = pe._mix32_np(a ^ u[:, k])
        b = pe._mix32_np((b + u[:, k]) ^ np.uint32(0x27D4EB2F))
        np.testing.assert_array_equal(a.astype(np.int64), h1[:, k].numpy())
        np.testing.assert_array_equal(b.astype(np.int64), h2[:, k].numpy())
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(pe._mix32_np(x), je._mix32_np(x))


@pytest.mark.parametrize("mode", ["all", "image_only", "diffuse_only"])
def test_assemble_population_matches_jax(jax_outputs, mode):
    got = pe.assemble_population(_port_outputs(jax_outputs), PortMode(mode), True)
    want = je.assemble_population(jax_outputs, JaxMode(mode), True)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_dedup_images_matches_jax(jax_outputs):
    got = pe.dedup_images(_port_outputs(jax_outputs), False)
    want = je.dedup_images(jax_outputs, False)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.tobytes() == w.tobytes()


def test_raw_files_cross_between_packages(tmp_path, rng):
    m = 77
    res = pe.RaytracerResults(
        volume=torch.from_numpy(rng.random((m, 8)).astype(np.float32)),
        position=torch.from_numpy(rng.random((m, 3)).astype(np.float32)),
        time=torch.from_numpy(rng.random(m).astype(np.float32)),
        mic=np.asarray(MIC),
    )
    port_file = str(tmp_path / "port.npz")
    pe.save_raw(port_file, res)
    back = pe.load_raw(port_file)
    assert back.num_impulses == m
    for k in ("volume", "position", "time"):
        assert back.__dict__[k].tobytes() == getattr(res, k).numpy().tobytes()
    assert back.mic.dtype == np.float32 and back.mic.tolist() == np.float32(MIC).tolist()
    by_jax = je.load_raw(port_file)
    jax_file = str(tmp_path / "jax.npz")
    je.save_raw(jax_file, by_jax)
    from_jax = pe.load_raw(jax_file)
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files) == ["mic", "position", "time", "volume"]
    for k in ("volume", "position", "time", "mic"):
        assert getattr(from_jax, k).tobytes() == getattr(back, k).tobytes()


def test_chunked_and_sorted_dense_trace_equal_unchunked(box):
    """Chunks (padded with +z rays), the Morton order and the per-bounce
    re-sort change no record: 2,100 rays (past 4 x RAY_BLOCK_SORT) traced
    in one pass, in chunks of 700, and with an explicit 4,096-ray chunk,
    against trace_chunk in the caller's order."""
    scene, _, psoup = box
    n = 2100
    assert n >= 4 * port_render.RAY_BLOCK_SORT
    dirs = random_directions(n, seed=12)
    ref = port_trace.trace_chunk(psoup, MIC, SRC, dirs, nreflections=5)
    for chunk in (None, 700, port_trace.DEFAULT_RAY_CHUNK):
        got = port_trace.trace(psoup, MIC, SRC, dirs, 5, ray_chunk=chunk)
        for name, a, b in zip(ref._fields, ref, got):
            assert a.shape == b.shape and torch.equal(a, b), (chunk, name)
    got = port_trace.trace(scene, MIC, SRC, dirs[:300], 5, ray_chunk=128, device="cpu")
    for a, b in zip(port_trace.trace_chunk(psoup, MIC, SRC, dirs[:300], nreflections=5), got):
        assert torch.equal(a, b)


def test_trace_plans_chunks_from_memory(box):
    nb = 32
    one = port_trace.trace_bytes(50_000, 128, nb)
    assert port_render.choose_ray_chunk(50_000, 128, nb, None, None,
                                        plan=port_trace.trace_bytes) == 50_000
    assert port_render.choose_ray_chunk(50_000, 128, nb, None, one,
                                        plan=port_trace.trace_bytes) == 50_000
    chunk = port_render.choose_ray_chunk(50_000, 128, nb, None, one // 3,
                                         plan=port_trace.trace_bytes)
    assert chunk == 16_384 and port_trace.trace_bytes(chunk, 128, nb) <= one // 3
    # the dense outputs outweigh the fused render's rows per ray bounce
    assert one > 2 * 50_000 * 128 * 48
    with pytest.raises(ValueError, match="at least one ray"):
        port_trace.trace(box[2], MIC, SRC, np.zeros((0, 3)), 3)


def test_raytracer_matches_jax(box):
    """The Raytracer surface: getters against the JAX Raytracer on the same
    rays (trace tolerances of tests/test_torch_trace.py), on the CPU."""
    scene, _, _ = box
    dirs = random_directions(300, seed=6)
    jrt = je.Raytracer(6, scene, impl="xla")
    jrt.raytrace(MIC, SRC, dirs)
    prt = pe.Raytracer(6, scene, device="cpu")
    prt.raytrace(MIC, SRC, dirs)
    with pytest.raises(RuntimeError, match="raytrace"):
        pe.Raytracer(6, scene, device="cpu").outputs
    for getter in ("get_raw_diffuse", "get_raw_images", "get_all_raw"):
        args = () if getter == "get_raw_diffuse" else (True,)
        want = getattr(jrt, getter)(*args)
        got = getattr(prt, getter)(*args)
        assert got.num_impulses == want.num_impulses > 0, getter
        for k, tol in ATOL.items():
            g, w = getattr(got, k), getattr(want, k)
            assert isinstance(g, np.ndarray)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{getter} {k}")


def test_raytracer_from_files_and_default_device(assets_dir):
    obj = str(assets_dir / "test_models" / "large_square.obj")
    mat = str(assets_dir / "materials" / "mat.json")
    with pytest.raises(ValueError, match="material_path"):
        pe.Raytracer(3, obj)
    rt = pe.Raytracer(3, obj, mat, device="cpu")
    assert rt.device == torch.device("cpu") and rt.soup.v0.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pe.Raytracer(3, obj, mat)
