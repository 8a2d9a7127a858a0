"""Chunked renders of the PyTorch port: against its one-pass render, against
the JAX package's chunked render, and the memory rule that picks the chunk.

The JAX render chunks only above RAY_PROGRAM_LIMIT (65,536 rays), so its
own chunk test (tests/test_render_fused.py::test_chunked_matches_single)
renders 70 rays in one pass. Here the JAX limit is monkeypatched down
inside the test (a module global read at call time) so that both packages
really chunk: 2,500 rays, Morton-sorted (from 2,048 rays on) and cut into
chunks of 1,024 with a short last chunk.

Tolerances: -60 dB of peak against the JAX package (the criterion of
tests/test_torch_render.py); chunked against one pass, the diffuse bins sum
in another order, so 1e-5 of peak (float32 summation noise).
"""

import json

import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene
from rayverb_tpu.config.schema import parse_config as jax_parse_config
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.utils.directions import morton_sort, random_directions
from rayverb_tpu_torch.config.schema import parse_config as port_parse_config
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops.intersect import soup_from_scene

from test_torch_render import _assert_within_60db, _doc, feed_jax_trace

torch.set_num_threads(1)

NOISE = 1e-5  # of peak: float32 summation order


@pytest.fixture(scope="module")
def box(assets_dir):
    return load_scene(
        str(assets_dir / "test_models" / "large_square.obj"),
        str(assets_dir / "materials" / "mat.json"),
    )


def _config(rays, reflections=4, **extra):
    doc = _doc("large_square", "all", True, rays=rays, reflections=reflections)
    doc.update(extra)
    return json.dumps(doc)


def _close(got, want, tol):
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0
    assert np.abs(got.astype(np.float64) - want).max() <= tol * peak


@pytest.mark.parametrize("chunk", [1024, 700])
def test_chunked_matches_one_pass(box, chunk):
    text = _config(2500)
    dirs = random_directions(2500, seed=3)
    one, one_info = port_render.render_fused(box, port_parse_config(text), dirs, device="cpu")
    got, info = port_render.render_fused(
        box, port_parse_config(text), dirs, device="cpu", ray_chunk=chunk
    )
    assert one_info["chunks"] == 1 and one_info["ray_chunk"] == 2500
    assert info["chunks"] == -(-2500 // chunk) and info["ray_chunk"] == chunk
    assert info["predelay"] == one_info["predelay"]
    _close(got, one, NOISE)


def test_chunked_matches_jax_chunked(box, monkeypatch):
    """The chunk loop against JAX's: chunk k holds the rays of JAX's chunk k
    (the Morton-sorted rays cut in order), and the carried histogram, time
    bounds and the image dedup over all chunks give JAX's IR. Both renders
    bin the JAX trace's records of each chunk (feed_jax_trace): at 10,000
    diffuse rows the two traces' ulp-level time differences move several
    arrivals across bin edges (tests/test_torch_hrtf.py's docstring)."""
    monkeypatch.setattr(jax_render, "RAY_PROGRAM_LIMIT", 1024)
    text = _config(2500)
    dirs = random_directions(2500, seed=3)
    want, winfo = jax_render.render_fused(box, jax_parse_config(text), dirs, ray_chunk=1024)
    calls = []
    feed_jax_trace(monkeypatch, box, calls)
    got, ginfo = port_render.render_fused(
        box, port_parse_config(text), dirs, device="cpu", ray_chunk=1024
    )
    assert ginfo["chunks"] == 3
    assert [len(c) for c in calls] == [1024, 1024, 452]
    # the chunks leave the device's Morton order as tensors, in order
    assert all(isinstance(c, torch.Tensor) for c in calls)
    np.testing.assert_array_equal(torch.cat(calls).numpy(), morton_sort(dirs))
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))
    assert ginfo["predelay"] == pytest.approx(winfo["predelay"], rel=1e-6)


def test_hrtf_chunked_matches_one_pass(box):
    """HRTF: per-ear sorts, ITD-shifted time stats carried across chunks."""
    text = _config(600, attenuation_model={"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}})
    dirs = random_directions(600, seed=4)
    one, one_info = port_render.render_fused(box, port_parse_config(text), dirs, device="cpu")
    got, info = port_render.render_fused(
        box, port_parse_config(text), dirs, device="cpu", ray_chunk=256
    )
    assert info["chunks"] == 3
    assert info["predelay"] == one_info["predelay"]
    _close(got, one, NOISE)


def test_chunk_rule():
    rb = port_render.render_bytes
    assert rb(2, 16, 1024) > rb(1, 16, 1024) > 0
    assert rb(1000, 32, 32) > rb(1000, 16, 32)
    assert rb(1000, 16, 1024) > rb(1000, 16, 32)
    choose = port_render.choose_ray_chunk
    # explicit chunks always apply (at most the population)
    assert choose(5000, 16, 64, ray_chunk=1000) == 1000
    assert choose(500, 16, 64, ray_chunk=1000) == 500
    with pytest.raises(ValueError):
        choose(500, 16, 64, ray_chunk=0)
    # no budget (the CPU) or a fitting estimate: one pass
    assert choose(10**6, 16, 1024) == 10**6
    assert choose(10**6, 16, 1024, budget=rb(10**6, 16, 1024)) == 10**6
    # otherwise the largest power of two of rays that fits
    budget = rb(10**6, 16, 1024) // 3
    c = choose(10**6, 16, 1024, budget=budget)
    assert c & (c - 1) == 0
    assert rb(c, 16, 1024) <= budget < rb(2 * c, 16, 1024)
    assert choose(10, 16, 1024, budget=0) == 1
    assert port_render.memory_budget(torch.device("cpu")) is None


def test_render_chunks_when_the_estimate_does_not_fit(box, monkeypatch):
    """ray_chunk=None chunks by the memory rule: with a budget that holds
    256 rays but not 512, 600 rays render in 3 chunks of 256."""
    nblocks = soup_from_scene(box, device="cpu").block_aabb.shape[0]
    budget = port_render.render_bytes(256, 4, nblocks)
    monkeypatch.setattr(port_render, "memory_budget", lambda dev: budget)
    text = _config(600)
    dirs = random_directions(600, seed=5)
    got, info = port_render.render_fused(box, port_parse_config(text), dirs, device="cpu")
    assert (info["ray_chunk"], info["chunks"]) == (256, 3)
    one, _ = port_render.render_fused(
        box, port_parse_config(text), dirs, device="cpu", ray_chunk=600
    )
    _close(got, one, NOISE)
