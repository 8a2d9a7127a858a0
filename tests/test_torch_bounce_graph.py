"""The trace's bounces by replay of one CUDA graph of a bounce, on the CPU:
phase B's diffuse bounce, and phase A's fixed-shape image bounce (the
image gate a stable partition on the card, the chain in fixed slots).

The graphs themselves run only on the card
(tests/test_torch_bounce_graph_card.py). Here: the rules that decide where
they engage, and the runner's buffers driven without a graph
(``_EagerGraph``: each step runs the factored bounce on the static state
and writes its row into fixed buffers, as a replay overwrites its captured
outputs), held bit for bit to the eager loops (phase A's: the gate that
compacts the rays), on the consume path and the dense path; and the
runner's host counts, added again at each replay after the first."""

import functools
import json
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

from rayverb_tpu_torch.config.schema import parse_config
from rayverb_tpu_torch.constants import NUM_IMAGE_SOURCE
from rayverb_tpu_torch.ops import intersect, intersect_cuda
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
from rayverb_tpu_torch.utils.directions import random_directions

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"
MIC = [0.013, 2.017, 0.021]
SOURCE = [0.031, 1.989, 2.007]
# 9 image-phase bounces, then 3 diffuse ones
REFLECTIONS = NUM_IMAGE_SOURCE + 2


@pytest.fixture(scope="module")
def box():
    scene = load_scene(str(ASSETS / "test_models" / "large_square.obj"),
                       str(ASSETS / "materials" / "mat.json"))
    return scene, intersect.soup_from_scene(scene, device="cpu")


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


_GRAPH_RULE, _IMAGE_RULE = trace._graph_engages, trace._image_graph_engages


def _image_rule_on(device):
    """Phase A's rule as it reads on ``device``, whatever device the trace
    runs on, and whatever stands in for phase B's rule meanwhile."""

    def rule(dev, impl, rows, bounces):
        with mock.patch.object(trace, "_graph_engages", _GRAPH_RULE):
            return _IMAGE_RULE(torch.device(device), impl, rows, bounces)

    return rule


@pytest.fixture
def stand_in(monkeypatch):
    """Phase B by the runner; phase A eager."""
    monkeypatch.setattr(trace, "_graph_engages", lambda dev, impl, bounces: bounces >= 2)
    monkeypatch.setattr(trace, "_image_graph_engages", lambda *a: False)
    monkeypatch.setattr(trace, "_BounceGraph", _EagerGraph)


@pytest.fixture
def image_stand_in(stand_in, monkeypatch):
    """Both phases by the runner: phase A's rule as on the card."""
    monkeypatch.setattr(trace, "_image_graph_engages", _image_rule_on("cuda"))


def _recorded(fn):
    """fn() inside a stats call on the CPU: (its result, the counters)."""
    timings = {}
    with profiling.call("rv.test", torch.device("cpu"), stats=True, timings=timings):
        stats = profiling.pair_sums()
        out = fn(stats)
        profiling.stage()
    return out, timings["counters"]


def _trace(soup, nrays, *, pairs=None, dense=False, resort=True, dirs=None, **kw):
    """(images, rows, counters) of one trace of nrays rays (per pair)."""
    rows = []

    def consume(row):
        rows.append(tuple(x.clone() for x in row))

    if pairs is None:
        mic, src, pair_id = MIC, SOURCE, None
        dirs = random_directions(nrays, seed=5) if dirs is None else dirs
    else:
        rng = np.random.default_rng(3)
        mic = rng.uniform(-1.0, 1.0, (pairs, 3)).astype(np.float32) + np.float32([0, 2, 0])
        src = rng.uniform(-1.0, 1.0, (pairs, 3)).astype(np.float32) + np.float32([0, 2, 0])
        dirs = np.concatenate([random_directions(nrays, seed=9 + p) for p in range(pairs)])
        pair_id = torch.arange(pairs).repeat_interleave(nrays)

    def run(stats):
        return trace._trace_impl(
            soup, mic, src, dirs, nreflections=kw.pop("nreflections", REFLECTIONS),
            consume_row=None if dense else consume, resort=resort, stats=stats,
            pair_id=pair_id, **kw)

    out, counters = _recorded(run)
    return out, rows, counters


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            _equal(x, y)


@pytest.mark.parametrize("dev, impl, bounces, schedule, engages", [
    ("cuda", "auto", 2, None, True),
    ("cuda", "cuda", 119, None, True),
    ("cpu", "auto", 119, None, False),
    ("cuda", "plain", 119, None, False),
    ("cuda", "auto", 1, None, False),
    ("cuda", "auto", 119, "_sorted_bounce_sweep", True),
    ("cuda", "auto", 119, "_shadow_rows", True),
    ("cuda", "auto", 119, "_ray_sort_key", True),
])
def test_engagement_rule(monkeypatch, dev, impl, bounces, schedule, engages):
    """The rule reads the device, the implementation and the bounces only:
    a wrapped bounce function is captured as the function itself is."""
    if schedule is not None:
        default = getattr(trace, schedule)
        monkeypatch.setattr(trace, schedule, lambda *a, **k: default(*a, **k))
    assert trace._graph_engages(torch.device(dev), impl, bounces) is engages


@pytest.mark.parametrize("case", ["cpu", "plain", "one_diffuse", "patched_sweep"])
def test_eager_where_the_graph_does_not_engage(box, monkeypatch, case):
    _, soup = box
    kw = {}
    reflections = REFLECTIONS
    if case == "plain":
        kw["impl"] = "plain"
    elif case == "one_diffuse":
        reflections = NUM_IMAGE_SOURCE
    elif case == "patched_sweep":
        default = trace._sorted_bounce_sweep
        monkeypatch.setattr(trace, "_sorted_bounce_sweep",
                            lambda *a: default(*a))
    _, rows, counters = _trace(soup, 128, nreflections=reflections, **kw)
    assert len(rows) == reflections
    assert counters["bounces.eager"] == reflections
    assert counters["bounces.graph"] == 0


@pytest.mark.parametrize("mode", ["consume", "dense", "multi_pair", "unsorted"])
def test_runner_equals_eager_loop(box, stand_in, mode):
    _, soup = box
    kw = {"dense": mode == "dense", "resort": mode != "unsorted"}
    if mode == "multi_pair":
        kw["pairs"] = 3
    want = _trace(soup, 160, bounce_graph=False, **kw)
    got = _trace(soup, 160, **kw)
    _equal(got[0], want[0])  # the image slots (dense: every TraceOutputs field)
    _equal(got[1], want[1])  # the consumed rows
    assert got[2]["bounces.graph"] == REFLECTIONS - (NUM_IMAGE_SOURCE - 1)
    assert got[2]["bounces.eager"] == NUM_IMAGE_SOURCE - 1
    assert want[2]["bounces.graph"] == 0 and want[2]["bounces.eager"] == REFLECTIONS
    for name, n in want[2].items():
        if name.startswith(("closest_hit.", "pair_tests.", "live_rows.", "launches.")):
            assert got[2][name] == n, name


@pytest.mark.parametrize("bin_mode, model", [
    ("sorted", "speakers"), ("scatter", "speakers"), ("sorted", "hrtf"),
])
def test_runner_render_equals_eager_render(box, stand_in, monkeypatch, bin_mode, model):
    scene, soup = box
    doc = json.loads((ASSETS / "configs" / "large_square.json").read_text())
    doc["reflections"] = REFLECTIONS
    if model == "hrtf":
        doc["attenuation_model"] = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}
    cfg = parse_config(json.dumps(doc))
    dirs = random_directions(96, seed=13)
    render = functools.partial(port_render.render_fused, scene, cfg, dirs, device="cpu",
                               soup=soup, bin_mode=bin_mode, stats=True)
    got, info = render()
    assert info["timings"]["counters"]["bounces.graph"] == 3
    monkeypatch.setattr(port_render, "_trace_impl",
                        functools.partial(trace._trace_impl, bounce_graph=False))
    want, info = render()
    assert info["timings"]["counters"]["bounces.graph"] == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dev, impl, rows, bounces, engages", [
    ("cuda", "auto", 50_000, 9, True),
    ("cuda", "cuda", trace.IMAGE_GRAPH_ROWS, 9, True),
    ("cuda", "auto", 4096, 2, True),
    ("cpu", "auto", 50_000, 9, False),
    ("cuda", "plain", 50_000, 9, False),
    ("cuda", "auto", trace.IMAGE_GRAPH_ROWS + 1, 9, False),
    ("cuda", "auto", 1_000_000, 9, False),
    ("cuda", "auto", 50_000, 1, False),
])
def test_image_engagement_rule(dev, impl, rows, bounces, engages):
    """Phase A's graph: on the card, the kernels' impl, two image bounces
    or more, and rows at or under IMAGE_GRAPH_ROWS."""
    assert trace._image_graph_engages(torch.device(dev), impl, rows, bounces) is engages


@pytest.mark.parametrize("case", ["cpu", "plain", "rows_above_bound"])
def test_image_phase_eager_where_its_graph_does_not_engage(box, stand_in, monkeypatch, case):
    """The compacted eager phase A (its gate a sync, site image_gate) where
    phase A's rule says no; phase B's graph is the stand-in's."""
    _, soup = box
    kw = {"impl": "plain"} if case == "plain" else {}
    monkeypatch.setattr(trace, "_image_graph_engages",
                        _image_rule_on("cpu" if case == "cpu" else "cuda"))
    if case == "rows_above_bound":
        monkeypatch.setattr(trace, "IMAGE_GRAPH_ROWS", 127)
    _, rows, counters = _trace(soup, 128, **kw)
    assert len(rows) == REFLECTIONS
    assert counters["bounces.image_graph"] == 0
    assert counters["bounces.eager"] == NUM_IMAGE_SOURCE - 1


def _up_cone(nrays):
    """Directions within ~25 degrees of +y: from Stonehenge's centre every
    ray leaves the scene, so the image gate admits no ray."""
    d = random_directions(nrays, seed=31)
    d[:, 1] = np.abs(d[:, 1]) + 2.0
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _soup(obj, materials):
    scene = load_scene(str(ASSETS / "test_models" / obj), str(ASSETS / "materials" / materials))
    return intersect.soup_from_scene(scene, device="cpu")


# (scene, rays per pair, mode, reflections): the box's gate admits many
# rays, the vault's ~1-3 %, Stonehenge's few or (the up cone) none; 3
# reflections fill 3 of the chain's 9 slots, 9 all, 10 and 12 leave
# diffuse bounces for phase B
IMAGE_CASES = [
    *[("box", 160, mode, r) for mode in ("consume", "dense", "multi_pair", "unsorted")
      for r in (3, 9, 12)],
    ("vault", 4096, "consume", 9),
    ("vault", 4096, "dense", 10),
    ("vault", 1024, "multi_pair", 3),
    ("stonehenge", 256, "consume", 10),
    ("up_cone", 256, "consume", 12),
]
SCENES = {"box": ("large_square.obj", "mat.json"), "vault": ("vault.obj", "vault.json"),
          "stonehenge": ("stonehenge.obj", "mat.json"), "up_cone": ("stonehenge.obj", "mat.json")}


@pytest.mark.parametrize("scene, nrays, mode, reflections", IMAGE_CASES)
def test_image_runner_equals_eager_image_phase(image_stand_in, scene, nrays, mode, reflections):
    """Phase A by the runner of the fixed-shape image bounce, bit for bit
    the compacted eager phase A: every image slot, every diffuse row; the
    same sweeps, live rows and bounce sweeps' pair tests (bounce 0's rows
    unsorted in both); closest_hit.rows counts the parked rows of the
    image sweeps, and bounce 0's sort key is computed. The other pair
    tests follow the image sweeps' groups and slices (the card test holds
    them to the fixed-shape bounce run eagerly)."""
    soup = _soup(*SCENES[scene])
    kw = {"dense": mode == "dense", "resort": mode != "unsorted", "nreflections": reflections}
    if mode == "multi_pair":
        kw["pairs"] = 2
    if scene == "up_cone":
        kw["dirs"] = _up_cone(nrays)
    want = _trace(soup, nrays, bounce_graph=False, **kw)
    got = _trace(soup, nrays, **kw)
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    image = min(reflections, NUM_IMAGE_SOURCE - 1)
    graphed = image + (reflections - image if reflections - image >= 2 else 0)
    assert got[2]["bounces.image_graph"] == image
    assert got[2]["bounces.graph"] == graphed
    assert got[2]["bounces.eager"] == reflections - graphed
    assert want[2]["bounces.graph"] == want[2]["bounces.image_graph"] == 0
    for name, n in want[2].items():
        if name.startswith(("closest_hit.calls", "live_rows.", "pair_tests.bounce")):
            assert got[2][name] == n, name
    rows = nrays * kw.get("pairs", 1)
    diffuse = reflections - image
    assert got[2]["closest_hit.rows"] == (kw.get("pairs", 1) + image * (NUM_IMAGE_SOURCE + 2) * rows
                                          + diffuse * 2 * rows)
    assert want[2]["closest_hit.rows"] < got[2]["closest_hit.rows"]
    keyed = rows * (2 * reflections - 1) if kw["resort"] else rows * reflections
    assert want[2]["sort_keys.plain"] == keyed
    assert got[2]["sort_keys.plain"] == keyed + rows * kw["resort"]
    slots = got[0].image_index if mode == "dense" else got[0][3]
    admitted = int((slots[:, 1:] != 0).sum())
    assert (admitted == 0) == (scene == "up_cone")


@pytest.mark.parametrize("model", ["speakers", "hrtf"])
def test_image_runner_render_equals_eager_render(box, image_stand_in, monkeypatch, model):
    """render_fused with both phases by the runner, bit for bit the eager
    render."""
    scene, soup = box
    doc = json.loads((ASSETS / "configs" / "large_square.json").read_text())
    doc["reflections"] = REFLECTIONS
    if model == "hrtf":
        doc["attenuation_model"] = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}
    cfg = parse_config(json.dumps(doc))
    dirs = random_directions(96, seed=13)
    render = functools.partial(port_render.render_fused, scene, cfg, dirs, device="cpu",
                               soup=soup, stats=True)
    got, info = render()
    counters = info["timings"]["counters"]
    assert counters["bounces.graph"] == REFLECTIONS
    assert counters["bounces.image_graph"] == NUM_IMAGE_SOURCE - 1
    monkeypatch.setattr(port_render, "_trace_impl",
                        functools.partial(trace._trace_impl, bounce_graph=False))
    want, info = render()
    assert info["timings"]["counters"]["bounces.graph"] == 0
    np.testing.assert_array_equal(got, want)


def test_replays_add_the_captured_counts():
    """A runner whose capture runs the bounce once (as a capture records
    its host counts) and whose replays run nothing: each step after the
    first adds the capture's counts again."""

    class Counted(trace._BounceGraph):
        def _capture(self):
            self.row = self.chain()

        def _replay(self):
            pass

    def body(state):
        profiling.count("closest_hit.calls", 2)
        profiling.count("closest_hit.rows", 2 * state.pos.shape[0])
        intersect_cuda.launches += 2
        intersect_cuda.order_launches += 2
        return state, (state.volume, state.pos, state.distance)

    n = 7
    state = trace._RayState(torch.zeros(n, 3), torch.ones(n, 3), torch.zeros(n),
                            torch.ones(n, 8), torch.ones(n, dtype=torch.bool))

    def steps(_):
        g = Counted(body, state)
        return [g.step() for _ in range(5)]

    rows, counters = _recorded(steps)
    assert len(rows) == 5
    assert counters["closest_hit.calls"] == 10
    assert counters["closest_hit.rows"] == 10 * n
    assert counters["launches.closest_hit_sweep"] == 10
    assert counters["launches.closest_hit_order"] == 10
