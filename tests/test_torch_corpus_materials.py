"""The port's CLI against the JAX package's with each of the demo
corpus's five materials on small_square x near_c, on the CPU (the
criterion and the shared trace records: tests/test_torch_corpus_cli.py;
small_square x near_c x vault, which the corpus does not render, takes
the seed of small_square x near_c x mat), and what the two packages' own
traces of that combination differ by."""

import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene
from rayverb_tpu.ops.intersect import soup_from_scene as jax_soup_from_scene
from rayverb_tpu.ops.trace import trace_chunk as jax_trace_chunk
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch import gen
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace

import oracle
from test_torch_corpus_cli import RAYS, REFLECTIONS, cli_both, reduced_config
from test_torch_render import DB60, _assert_within_60db
from test_torch_trace import ATOL

torch.set_num_threads(1)

MAT = ("near_c", "small_square", "mat")
MATERIALS = ("mat", "vault", "damped", "bright", "brighter")


def _seed(material):
    combo = ("near_c", "small_square", material)
    return gen.COMBOS.index(combo if combo in gen.COMBOS else MAT)


@pytest.mark.parametrize("material", MATERIALS)
def test_material_cli_matches_jax(material, tmp_path, monkeypatch):
    got, want = cli_both(_seed(material), ("near_c", "small_square", material), tmp_path,
                         monkeypatch=monkeypatch)
    _assert_within_60db(got, want)


def _err(got, want):
    """_assert_within_60db's reading: max error over peak, forgiving a
    shift of one sample either way."""
    n = min(got.shape[1], want.shape[1])
    errs = [np.abs(got[:, :n] - np.roll(want, s, axis=-1)[:, :n]) for s in (0, 1, -1)]
    return float(np.minimum(np.minimum(errs[0], errs[1]), errs[2]).max() / np.abs(want).max())


def test_own_trace_difference_is_edge_verdicts_and_bin_edges(tmp_path, monkeypatch):
    """small_square x near_c x mat (source and mic on the plane x = 0) at
    its corpus seed. The two packages' traces of the same 256 rays agree
    on every diffuse record within tests/test_torch_trace.py's tolerances
    and differ in the image records of a few rays. On each of those the
    float64 oracle (tests/oracle.py) admits the image chains of one of the
    two, and it sides with each package at least once: the verdicts sit on
    triangle edges. On their own traces the CLIs differ by more than a
    tenth of the peak; with the JAX trace's image records on the disputed
    rays the rest of the difference is bin-edge flips of diffuse arrivals,
    over -60 dB at 256 rays; with its diffuse records too it is within
    -60 dB."""
    k = gen.COMBOS.index(MAT)
    _, doc = reduced_config(MAT, tmp_path)
    _, model, materials = gen.combo_paths(MAT)
    scene = load_scene(model, materials)
    dirs = random_directions(RAYS, seed=k)
    mic, src = np.float32(doc["mic_position"]), np.float32(doc["source_position"])
    jsoup = jax_soup_from_scene(scene)
    want = jax_trace_chunk(jsoup, mic, src, dirs, nreflections=REFLECTIONS)
    got = port_trace.trace_chunk(port_isect.soup_from_scene(scene, device="cpu"), mic, src,
                                 dirs, nreflections=REFLECTIONS)
    for f in ("diffuse_volume", "diffuse_position", "diffuse_time"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=ATOL[f], err_msg=f)
    wi, gi = np.asarray(want.image_index), got.image_index.numpy()
    rows = np.nonzero((wi != gi).any(axis=1))[0]
    assert 0 < len(rows) <= 0.1 * RAYS
    sides = {"port": 0, "jax": 0}
    for r in rows:
        _, images = oracle.trace(scene, mic, src, dirs[r : r + 1], REFLECTIONS)
        f64 = np.zeros_like(wi[r])
        f64[0] = wi[r, 0]
        for key in images:
            if key != (0,):
                f64[len(key)] = key[-1]
        sides["port"] += np.array_equal(gi[r], f64)
        sides["jax"] += np.array_equal(wi[r], f64)
    assert sides["port"] + sides["jax"] == len(rows)
    assert sides["port"] >= 1 and sides["jax"] >= 1

    own, jax_ir = cli_both(k, MAT, tmp_path, shared=False)
    real = port_render._trace_impl

    def disputed_from_jax(soup, mic, source, directions, *, nreflections, **kw):
        out = list(real(soup, mic, source, directions, nreflections=nreflections, **kw))
        w = jax_trace_chunk(jsoup, np.float32(mic), np.float32(source),
                            np.asarray(directions), nreflections=nreflections)
        w = [torch.from_numpy(np.array(x)) for x in (
            w.image_volume, w.image_position, w.image_time, w.image_index)]
        swap = (out[3] != w[3].long()).any(dim=1)
        for o, x in zip(out, w):
            o[swap] = x[swap].to(o.dtype)
        return tuple(out)

    monkeypatch.setattr(port_render, "_trace_impl", disputed_from_jax)
    images_swapped, _ = cli_both(k, MAT, tmp_path, shared=False)
    monkeypatch.undo()
    shared, _ = cli_both(k, MAT, tmp_path, monkeypatch=monkeypatch)
    assert _err(own, jax_ir) > 0.1
    assert DB60 < _err(images_swapped, jax_ir) < _err(own, jax_ir) / 4
    assert _err(shared, jax_ir) < DB60
