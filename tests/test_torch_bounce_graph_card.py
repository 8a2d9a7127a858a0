"""On the card: both phases of the trace by replay of a CUDA graph of their
bounce (ops/trace.py ``_BounceGraph``: phase A's fixed-shape image bounce,
phase B's diffuse bounce), against the same bounces run without a graph
(``_EagerGraph``) and against the eager loops
(``_trace_impl(..., bounce_graph=False)``, whose phase A compacts the rays
at its image gate).

Without a graph the replayed kernels run in the same order on the same
data, so every output and every counter is the graph's. The eager loops'
phase B is the same again. Their phase A takes the same float32
operations on every live element and the same bounce sweeps (bounce 0's
rows unsorted in both), while the fixed-shape image sweeps hold the gated
rays' validation rows first in fixed regions and park the other rows
dead. So the histogram, the image slots and the IR are bit for bit the
eager loops', and phase A counts the same sweeps, live rows, bounce pair
tests and sweep and order launches; its rows and order entries are those
of the fixed regions, and its shadow and segment pair tests are at most
the eager ones (a sweep of more groups takes fewer table slices, and the
segment region's last group holds no live visibility row). This file
imports no JAX; on the card run

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
from rayverb_tpu_torch.ops import intersect, render, trace
from rayverb_tpu_torch.parallel import datagen
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
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
CASES = ("vault", "vault_hrtf", "stonehenge", "datagen", "corpus_room")
COUNTERS = ("closest_hit.", "pair_tests.", "live_rows.", "order.", "launches.", "sort_keys.")
# phase A's counters that its graph counts as the eager loop does
SAME_IN_PHASE_A = ("closest_hit.calls", "live_rows.", "launches.closest_hit",
                   "pair_tests.bounce", "sort_keys.plain")
STAGES = ("rv.phase_a", "rv.phase_b")


class _EagerGraph(trace._BounceGraph):
    """The runner without a graph: nothing is captured, and each step runs
    the bounce on the static state into fixed row buffers."""

    def _capture(self):
        pass

    def _replay(self):
        row = self.chain()
        if self.row is None:
            self.row = tuple(torch.empty_like(x) for x in row)
        for buf, x in zip(self.row, row):
            buf.copy_(x)


def _counts():
    """The host counters and the call's sweep accumulator now, by name."""
    out = dict(profiling.host_counts())
    sums = profiling.pair_sums()
    if sums is not None:
        sums = sums.tolist()
        out.update((f"pair_tests.{k}", v) for k, v in zip(profiling.PAIR_KINDS, sums))
        out.update((f"live_rows.{k}", v)
                   for k, v in zip(profiling.PAIR_KINDS, sums[profiling.LIVE_ROWS:]))
        out["order.entries_kept"] = sums[profiling.ORDER_ENTRIES]
        out["order.entries"] = sums[profiling.ORDER_ENTRIES + 1]
    return out


class _StageSpy:
    """A stage span (profiling.phase) that keeps, for STAGES, what each
    counter added inside it into ``stages``."""

    def __init__(self, stages, real, name, **attrs):
        self.stages, self.name, self.span = stages, name, real(name, **attrs)

    def __enter__(self):
        out = self.span.__enter__()
        self.before = _counts() if self.name in STAGES else None
        return out

    def __exit__(self, *exc):
        if self.before is not None:
            after = _counts()
            self.stages[self.name] = {k: v - self.before.get(k, 0) for k, v in after.items()
                                      if k.startswith(COUNTERS)}
        return self.span.__exit__(*exc)


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
        # the corpus's smallest room (6 triangles, one table block: no resort)
        "corpus_room": ("near_c.json", "small_square.obj", "mat.json", 128),
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
    stats, image slots; then the IRs), its info, its reflections, and what
    each stage span added to the counters (in a stats call): ``graph``
    True runs both phases by their graphs, "runner" their bounces without
    a graph, False the eager loops."""
    module, binner, call, reflections = _case(name)
    kept = []
    real = getattr(module, binner)
    stages = {}

    def spy(*a, **k):
        out = real(*a, **k)
        kept.extend(_flat(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(module, binner, spy)
        m.setattr(profiling, "phase", functools.partial(_StageSpy, stages, profiling.phase))
        if not graph:
            m.setattr(module, "_trace_impl",
                      functools.partial(trace._trace_impl, bounce_graph=False))
        elif graph == "runner":
            m.setattr(trace, "_BounceGraph", _EagerGraph)
        outs, info = call(stats)
    torch.cuda.synchronize()
    return kept, outs, info, reflections, stages


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_graph_equals_eager(card, monkeypatch, name):
    engaged = []
    for rule_name in ("_graph_engages", "_image_graph_engages"):
        rule = getattr(trace, rule_name)
        monkeypatch.setattr(trace, rule_name,
                            lambda *a, rule=rule: engaged.append(rule(*a)) or engaged[-1])
    kept, outs, _, _, _ = _run(monkeypatch, name, False, graph=True)
    assert len(engaged) >= 2 and all(engaged)
    want_kept, want_outs, _, _, _ = _run(monkeypatch, name, False, graph=False)
    assert len(kept) == len(want_kept) > 0
    for got, want in zip(kept, want_kept):
        assert torch.equal(got, want)
    for got, want in zip(outs, want_outs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_graph_counts_what_its_bounces_count_without_it(card, monkeypatch, name):
    """Both phases' graphs against their bounces run without a graph: the
    same outputs, and every counter, in each stage and in the call."""
    kept, outs, info, reflections, stages = _run(monkeypatch, name, True, graph=True)
    want_kept, want_outs, want_info, _, want_stages = _run(monkeypatch, name, True,
                                                           graph="runner")
    for got, want in zip(kept, want_kept):
        assert torch.equal(got, want)
    for got, want in zip(outs, want_outs):
        np.testing.assert_array_equal(got, want)
    got, want = info["timings"]["counters"], want_info["timings"]["counters"]
    assert got["bounces.graph"] == want["bounces.graph"] == reflections
    assert got["bounces.image_graph"] == want["bounces.image_graph"] == NUM_IMAGE_SOURCE - 1
    names = [k for k in want if k.startswith(COUNTERS)]
    assert "pair_tests.seg" in names and "order.entries_kept" in names
    assert {k: got[k] for k in names} == {k: want[k] for k in names}
    assert stages == want_stages and set(stages) == set(STAGES)


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_graph_counts_what_eager_counts(card, monkeypatch, name):
    _, _, info, reflections, stages = _run(monkeypatch, name, True, graph=True)
    _, _, want_info, _, want_stages = _run(monkeypatch, name, True, graph=False)
    got, want = info["timings"]["counters"], want_info["timings"]["counters"]
    assert got["bounces.graph"] == reflections and got["bounces.eager"] == 0
    assert got["bounces.image_graph"] == NUM_IMAGE_SOURCE - 1
    assert want["bounces.graph"] == want["bounces.image_graph"] == 0
    assert want["bounces.eager"] == reflections
    # phase B, and what follows the trace: every counter
    assert stages["rv.phase_b"] == want_stages["rv.phase_b"]
    assert "pair_tests.shadow" in stages["rv.phase_b"]
    later = [k for k in want if k.startswith("launches.biquad")]
    assert {k: got[k] for k in later} == {k: want[k] for k in later}
    # phase A: the same sweeps, live rows, bounce pair tests and launches
    a, want_a = stages["rv.phase_a"], want_stages["rv.phase_a"]
    same = [k for k in want_a if k.startswith(SAME_IN_PHASE_A)]
    assert "pair_tests.bounce" in same and "launches.closest_hit_order" in same
    assert {k: a[k] for k in same} == {k: want_a[k] for k in same}
    # its bounce 0 keys its rows too, and keeps them in their order
    image = NUM_IMAGE_SOURCE - 1
    keys = want_a["launches.ray_keys"]
    resort = keys == 2 * image - 1
    assert resort or keys == image
    rays, pairs = (4 * DATAGEN["rays"], 4) if name == "datagen" else (RAYS, 1)
    assert a["launches.ray_keys"] == keys + resort
    assert a["sort_keys.fused"] == want_a["sort_keys.fused"] + resort * rays
    # the image sweeps' fixed regions: shadow, segment and visibility rows,
    # (NUM_IMAGE_SOURCE + 1) x rays, and their groups x nblocks entries
    assert a["closest_hit.rows"] == pairs + image * (NUM_IMAGE_SOURCE + 2) * rays
    assert want_a["closest_hit.rows"] < a["closest_hit.rows"]
    groups = -(-rays // intersect.SWEEP_RAYS)
    nblocks = stages["rv.phase_b"]["order.entries"] // (2 * (reflections - image) * groups)
    wide = -(-(NUM_IMAGE_SOURCE + 1) * rays // intersect.SWEEP_RAYS)
    assert a["order.entries"] == image * (groups + wide) * nblocks
    assert want_a["order.entries"] <= a["order.entries"]
    # the image sweeps' pair tests: the shadow rows', at most the eager
    # sweeps' (and the same where both take one slice), the segments' at
    # most; the visibility rows' follow their groups
    for kind in ("shadow", "seg"):
        assert a[f"pair_tests.{kind}"] <= want_a[f"pair_tests.{kind}"], kind
    if intersect.sweep_slices(rays, nblocks, True) == 1:
        assert a["pair_tests.shadow"] == want_a["pair_tests.shadow"]
