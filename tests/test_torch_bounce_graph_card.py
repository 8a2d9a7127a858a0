"""On the card: phase B of the trace by replay of one CUDA graph of its
bounce (ops/trace.py ``_BounceGraph``) against the eager loop
(``_trace_impl(..., bounce_graph=False)``): the same kernels in the same
order on the same data, so the histogram, the image slots and the IR are
bit for bit the eager loop's, and a stats call counts the same sweeps,
rows, pair tests, live rows, kept order entries and launches. This file imports no JAX; on the
card run

    python -m pytest --noconftest -m card tests/test_torch_bounce_graph_card.py

Each test skips without a CUDA card."""

import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from rayverb_tpu_torch.config.schema import load_config, parse_config
from rayverb_tpu_torch.constants import NUM_IMAGE_SOURCE
from rayverb_tpu_torch.ops import render, trace
from rayverb_tpu_torch.parallel import datagen
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils.directions import random_directions

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"
RAYS = 8192
# config 5 (BASELINE.json; portbench/traffic/datagen_config5.json) at 4 pairs
DATAGEN = {
    "rays": 4096, "reflections": 16, "sample_rate": 16000, "bit_depth": 16,
    "source_position": [0, 0, 0], "mic_position": [0, 0, 0],
    "attenuation_model": {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
    "trim_tail": False,
}
CASES = ("vault", "vault_hrtf", "stonehenge", "datagen")
COUNTERS = ("closest_hit.", "pair_tests.", "live_rows.", "order.", "launches.", "sort_keys.")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: phase B's CUDA graph runs on the card only")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _scene(obj, materials):
    return load_scene(str(ASSETS / "test_models" / obj), str(ASSETS / "materials" / materials))


def _case(name):
    """(module whose trace and trace-and-bin functions to spy, the name of
    the latter, the call, the reflections)."""
    if name == "datagen":
        scene = _scene("vault.obj", "vault.json")
        cfg = parse_config(json.dumps(DATAGEN))
        rng = np.random.default_rng(17)
        lo, hi = np.asarray(scene.bounds)
        sources = (lo + (hi - lo) * (0.2 + 0.6 * rng.random((4, 3)))).astype(np.float32)
        mics = (lo + (hi - lo) * (0.2 + 0.6 * rng.random((4, 3)))).astype(np.float32)
        dirs = np.stack([random_directions(cfg.rays, seed=100 + i) for i in range(4)])

        def call(stats):
            out = datagen.render_irs_batched(scene, cfg, sources, mics, dirs,
                                             device="cuda", stats=stats)
            return [out[0].cpu().numpy(), out[1].cpu().numpy()], out[2] if stats else {}

        return datagen, "_batched_trace_bin", call, cfg.reflections
    config, obj, materials, reflections = {
        "vault": ("vault.json", "vault.obj", "vault.json", 128),
        "vault_hrtf": ("hrtf_vault.json", "vault.obj", "vault.json", 128),
        "stonehenge": ("stonehenge.json", "stonehenge.obj", "mat.json", 64),
    }[name]
    scene = _scene(obj, materials)
    cfg = dataclasses.replace(load_config(str(ASSETS / "configs" / config)),
                              reflections=reflections)
    dirs = random_directions(RAYS, seed=23)

    def call(stats):
        channels, info = render.render_fused(scene, cfg, dirs, device="cuda", stats=stats)
        return [channels], info

    return render, "_fused_trace_bin", call, reflections


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x.clone()]
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _flat(item)]
    return []


def _run(monkeypatch, name, stats, graph):
    """The case's outputs (the trace-and-bin tensors: histogram, time
    stats, image slots; then the IRs) and its info, with phase B graphed
    or eager."""
    module, binner, call, reflections = _case(name)
    kept = []
    real = getattr(module, binner)

    def spy(*a, **k):
        out = real(*a, **k)
        kept.extend(_flat(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(module, binner, spy)
        if not graph:
            m.setattr(module, "_trace_impl",
                      functools.partial(trace._trace_impl, bounce_graph=False))
        outs, info = call(stats)
    torch.cuda.synchronize()
    return kept, outs, info, reflections


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_graph_equals_eager(card, monkeypatch, name):
    engaged = []
    rule = trace._graph_engages
    monkeypatch.setattr(trace, "_graph_engages", lambda *a: engaged.append(rule(*a)) or engaged[-1])
    kept, outs, _, _ = _run(monkeypatch, name, False, graph=True)
    assert engaged and all(engaged)
    want_kept, want_outs, _, _ = _run(monkeypatch, name, False, graph=False)
    assert len(kept) == len(want_kept) > 0
    for got, want in zip(kept, want_kept):
        assert torch.equal(got, want)
    for got, want in zip(outs, want_outs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_graph_counts_what_eager_counts(card, monkeypatch, name):
    _, _, info, reflections = _run(monkeypatch, name, True, graph=True)
    _, _, want_info, _ = _run(monkeypatch, name, True, graph=False)
    got, want = info["timings"]["counters"], want_info["timings"]["counters"]
    diffuse = reflections - (NUM_IMAGE_SOURCE - 1)
    assert got["bounces.graph"] == diffuse
    assert got["bounces.eager"] == reflections - diffuse
    assert want["bounces.graph"] == 0 and want["bounces.eager"] == reflections
    names = [k for k in want if k.startswith(COUNTERS)]
    assert "launches.closest_hit_sweep" in names and "pair_tests.shadow" in names
    assert "launches.ray_keys" in names and "sort_keys.fused" in names
    assert {k: got[k] for k in names} == {k: want[k] for k in names}
