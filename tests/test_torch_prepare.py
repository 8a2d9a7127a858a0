"""The per-call preparation that render_fused, render_fused_sharded and
render_irs_batched share (rayverb_tpu_torch/ops/render.py ``_prepare``),
on the CPU: its ray order, resort, histogram bound and attenuation spec
against ray_schedule, resort_sweeps, histogram_length and make_atten_spec
called directly, below and above the Morton threshold of 2,048 rays, for
one ray set and for a batch of them; the output mode's flags; at most
one sweep table per call (none where render_fused is given one), kept
across calls by the scene's content and device (ops/intersect.py
cached_soup: hits, builds, eviction, IRs bit for bit); its refusals; the
spans under rv.prepare, in order; and the resort that render_fused hands
to the trace.

The vault (32 table blocks, so a population of 4,096 rays or more
resorts)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from rayverb_tpu_torch.config.schema import OutputMode, parse_config
from rayverb_tpu_torch.ops import intersect as port_intersect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops.attenuate import _f32
from rayverb_tpu_torch.ops.intersect import soup_from_scene
from rayverb_tpu_torch.parallel import datagen as port_datagen
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
from rayverb_tpu_torch.utils.directions import random_directions

torch.set_num_threads(1)

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"
CPU = torch.device("cpu")
MODELS = {
    "speakers": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5},
                              {"direction": [1, 0, 0], "shape": 0.2}]},
    "hrtf": {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
}
PAIRS = 3


@pytest.fixture(scope="module")
def vault():
    return load_scene(str(ASSETS / "test_models" / "vault.obj"),
                      str(ASSETS / "materials" / "vault.json"))


def _cfg(rays=64, reflections=2, model="speakers", **kw):
    return parse_config(json.dumps({
        "rays": rays, "reflections": reflections, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [0, 1.75, 0], "mic_position": [0, 1.75, 6],
        "attenuation_model": MODELS[model], **kw}))


def _batch_inputs(rays):
    sources = np.float32([[0, 1.75, 0], [0.4, 1.5, 1.0], [-0.3, 1.2, 2.0]])
    mics = np.float32([[0, 1.75, 6], [0.2, 1.2, 4.0], [0.5, 1.6, 3.0]])
    dirs = np.stack([random_directions(rays, seed=40 + p) for p in range(PAIRS)])
    return sources, mics, dirs


def _spec_equal(got, want):
    assert type(got) is type(want)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("batched", [False, True], ids=["rays", "pairs"])
@pytest.mark.parametrize("rays", [1024, 8192])
@pytest.mark.parametrize("model", ["speakers", "hrtf"])
def test_prepared_equals_the_direct_calls(vault, model, rays, batched):
    cfg = _cfg(rays, model=model)
    dirs = _batch_inputs(rays)[2] if batched else random_directions(rays, seed=7)
    prep = port_render._prepare(vault, cfg, dirs, CPU)

    soup = soup_from_scene(vault, device=CPU)
    nblocks = soup.block_aabb.shape[0]
    assert prep.nblocks == nblocks == 32
    order, resort = port_render.ray_schedule(_f32(dirs, CPU), nblocks)
    want = _f32(dirs, CPU).reshape(-1, 3)
    if order is not None:
        want = want[order]
    assert (order is None) is (rays < 2048)
    assert torch.equal(prep.directions, want)
    rows = rays * (PAIRS if batched else 1)
    assert prep.directions.shape == (rows, 3)
    assert prep.resort is resort is port_render.resort_sweeps(rows, nblocks)
    assert prep.resort is (rows >= 4096)
    assert prep.length == port_render.histogram_length(vault, cfg.reflections,
                                                       cfg.sample_rate)
    _spec_equal(prep.spec, port_render.make_atten_spec(cfg.attenuation_model, CPU))
    assert prep.spec.is_hrtf is (model == "hrtf")
    assert prep.bin_mode == "sorted" and prep.pair_stats is None


@pytest.mark.parametrize("mode, diffuse, images", [
    ("all", True, True), ("diffuse_only", True, False), ("image_only", False, True),
])
def test_output_mode_flags(vault, mode, diffuse, images):
    cfg = _cfg(output_mode=mode)
    assert cfg.output_mode is OutputMode(mode)
    prep = port_render._prepare(vault, cfg, random_directions(16, seed=1), CPU,
                                bin_mode="scatter")
    assert (prep.include_diffuse, prep.include_images) == (diffuse, images)
    assert prep.bin_mode == "scatter"


@pytest.fixture
def soups(monkeypatch):
    """An empty soup cache of the process's size, in place of the
    process's own for one test."""
    cache = port_intersect.SoupCache(port_intersect._SOUPS.size)
    monkeypatch.setattr(port_intersect, "_SOUPS", cache)
    return cache


def _builds(monkeypatch):
    """The devices of the soups that the cache builds from here on."""
    built = []
    real = port_intersect.soup_from_scene

    def spy(scene, device=None):
        built.append(device)
        return real(scene, device=device)

    monkeypatch.setattr(port_intersect, "soup_from_scene", spy)
    return built


def _copy(scene):
    """A scene object of equal content, every array a copy of its own."""
    return dataclasses.replace(scene, tri_verts=scene.tri_verts.copy(),
                               tri_surface=scene.tri_surface.copy(),
                               specular=scene.specular.copy(), diffuse=scene.diffuse.copy())


def _soup_equal(got, want):
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("entry", ["render_fused", "render_fused_soup", "render_irs_batched"])
def test_one_sweep_table_per_call(vault, soups, monkeypatch, entry):
    """A call builds at most one sweep table: the first call for a scene
    one, a call given a soup none."""
    built = _builds(monkeypatch)
    cfg = _cfg(32)
    if entry == "render_irs_batched":
        sources, mics, dirs = _batch_inputs(32)
        port_datagen.render_irs_batched(vault, cfg, sources, mics, dirs, device="cpu")
        assert built == [CPU]
        return
    kw = {"soup": soup_from_scene(vault, device=CPU)} if entry == "render_fused_soup" else {}
    port_render.render_fused(vault, cfg, random_directions(32, seed=2), device="cpu", **kw)
    assert built == ([] if kw else [CPU])


def test_two_prepares_build_one_table(vault, soups, monkeypatch):
    """Two preparations of one scene: one build, one hit, the same soup
    (the same tensor objects), the span rv.sweep_table marked by hit."""
    built = _builds(monkeypatch)
    timings = {}
    dirs = random_directions(16, seed=5)
    with profiling.call("rv.test", CPU, stats=True, timings=timings):
        first = port_render._prepare(vault, _cfg(), dirs, CPU)
        second = port_render._prepare(vault, _cfg(model="hrtf"), dirs, CPU)
        spans = list(profiling._current.spans)
    assert built == [CPU]
    assert {k: v for k, v in timings["counters"].items() if k.startswith("sweep_table.")} == {
        "sweep_table.builds": 1, "sweep_table.hits": 1}
    assert all(a is b for a, b in zip(first.soup, second.soup))
    assert [s[4] for s in spans if s[0] == "rv.sweep_table"] == [{"hit": False}, {"hit": True}]
    _soup_equal(first.soup, soup_from_scene(vault, device=CPU))


def test_equal_content_hits(vault, soups, monkeypatch):
    built = _builds(monkeypatch)
    soup, hit = port_intersect.cached_soup(vault, CPU)
    again, hit_again = port_intersect.cached_soup(_copy(vault), CPU)
    assert (hit, hit_again) == (False, True) and again is soup and built == [CPU]


@pytest.mark.parametrize("field, index", [
    ("tri_verts", (5, 1, 2)),       # one vertex coordinate
    ("tri_verts", (-1, 2, 0)),      # a padding row
    ("tri_surface", (7,)),          # one triangle's material row
    ("specular", (3, 4)),           # one material's band
    ("diffuse", (2, 0)),
])
def test_changed_scene_rebuilds(vault, soups, monkeypatch, field, index):
    """A scene changed in place after its soup was kept misses, and its
    new soup equals a fresh soup_from_scene of it."""
    assert vault.num_triangles < vault.padded_triangles
    scene = _copy(vault)
    kept, _ = port_intersect.cached_soup(scene, CPU)
    array = getattr(scene, field)
    array[index] = (array[index] + 1) % 5 if field == "tri_surface" else array[index] + 0.125
    built = _builds(monkeypatch)
    soup, hit = port_intersect.cached_soup(scene, CPU)
    assert not hit and built == [CPU] and soup is not kept
    _soup_equal(soup, soup_from_scene(scene, device=CPU))
    _soup_equal(kept, soup_from_scene(vault, device=CPU))


def test_another_device_misses(vault, soups, monkeypatch):
    """The device is part of the key, a CUDA device without an index taken
    as the current one (CUDA stood in for: the soups are built on the
    CPU)."""
    built = []
    real = port_intersect.soup_from_scene

    def build(scene, device=None):
        built.append(device)
        return real(scene, device=CPU)

    monkeypatch.setattr(port_intersect, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(port_intersect, "soup_from_scene", build)
    hits = [soups.get(vault, d)[1] for d in ("cpu", "cuda", "cuda:0", "cuda:1", "cpu", "cuda:1")]
    assert hits == [False, False, True, False, True, True]
    assert built == [CPU, torch.device("cuda", 0), torch.device("cuda", 1)]


def test_cache_evicts_the_least_recently_used(vault, monkeypatch):
    built = _builds(monkeypatch)
    cache = port_intersect.SoupCache(2)
    scenes = [_copy(vault) for _ in range(3)]
    for k, scene in enumerate(scenes):
        scene.tri_verts[0, 0, 0] += k
    a, b, c = scenes
    hits = [cache.get(s, CPU)[1] for s in (a, b, a, c, b, c, a)]
    assert hits == [False, False, True, False, False, True, False]
    assert len(built) == 5 and len(cache.entries) == 2
    assert [soup for _, soup in cache.entries] == [cache.get(c, CPU)[0], cache.get(a, CPU)[0]]


@pytest.mark.parametrize("entry", ["render_fused", "render_fused_soup", "render_irs_batched"])
def test_counters_of_back_to_back_calls(vault, soups, entry):
    """Per call that prepares without a soup, one of sweep_table.builds
    and .hits: the first call builds, the next hits; a call given a soup
    counts neither."""
    cfg = _cfg(32)
    got = []
    for _ in range(2):
        if entry == "render_irs_batched":
            sources, mics, dirs = _batch_inputs(32)
            _, _, info = port_datagen.render_irs_batched(vault, cfg, sources, mics, dirs,
                                                         device="cpu", stats=True)
        else:
            kw = ({"soup": soup_from_scene(vault, device=CPU)}
                  if entry == "render_fused_soup" else {})
            _, info = port_render.render_fused(vault, cfg, random_directions(32, seed=2),
                                               device="cpu", stats=True, **kw)
        got.append({k: v for k, v in info["timings"]["counters"].items()
                    if k.startswith("sweep_table.")})
    if entry == "render_fused_soup":
        assert got == [{}, {}]
    else:
        assert got == [{"sweep_table.builds": 1}, {"sweep_table.hits": 1}]


@pytest.mark.parametrize("entry", ["render_fused", "render_irs_batched"])
def test_kept_soup_renders_bit_for_bit_and_stays_unchanged(vault, soups, entry):
    """A call on the kept soup returns the IRs of a call on a fresh one,
    bit for bit, and leaves the kept soup's tensors as they were."""
    cfg = _cfg(256, reflections=4, model="hrtf")
    sources, mics, dirs = _batch_inputs(256)

    def render(**kw):
        if entry == "render_irs_batched":
            return port_datagen.render_irs_batched(vault, cfg, sources, mics, dirs,
                                                   device="cpu")[0]
        return port_render.render_fused(vault, cfg, dirs[0], device="cpu", **kw)[0]

    built = render()
    kept, hit = port_intersect.cached_soup(vault, CPU)
    assert hit
    before = [t.clone() for t in kept]
    again = render()
    assert np.array_equal(again, built)
    if entry == "render_fused":
        assert np.array_equal(render(soup=soup_from_scene(vault, device=CPU)), built)
    assert all(torch.equal(a, b) for a, b in zip(kept, before))


@pytest.mark.parametrize("scene", ["vault", "random"])
def test_scene_bounds_are_the_real_vertices_extremes(vault, scene):
    """Scene.bounds, which histogram_length reads every call, is the
    per-axis min and max over the real triangles' vertices."""
    if scene == "random":
        rng = np.random.default_rng(11)
        verts = rng.uniform(5.0, 40.0, size=(1000, 3, 3)).astype(np.float32)
        verts[990:] = 0.0
        vault = dataclasses.replace(vault, tri_verts=verts, tri_surface=np.zeros(1000, np.int32),
                                    num_triangles=990)
    v = vault.tri_verts[: vault.num_triangles].reshape(-1, 3)
    want = np.stack([v.min(axis=0), v.max(axis=0)])
    got = vault.bounds
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if scene == "random":
        assert (got[0] >= 5.0).all()  # the padding rows' zeros are left out


@pytest.mark.parametrize("case", ["bad_bin_mode", "no_rays", "environment"])
def test_refusals(vault, monkeypatch, case):
    cfg = _cfg()
    dirs = random_directions(16, seed=3)
    if case == "bad_bin_mode":
        with pytest.raises(ValueError, match="bin_mode"):
            port_render._prepare(vault, cfg, dirs, CPU, bin_mode="dense")
    elif case == "no_rays":
        for empty in (np.zeros((0, 3), np.float32), np.zeros((2, 0, 3), np.float32)):
            with pytest.raises(ValueError, match="at least one ray"):
                port_render._prepare(vault, cfg, empty, CPU)
    else:
        # bin_mode None reads RAYVERB_BIN, and refuses what it does not know
        monkeypatch.setenv("RAYVERB_BIN", "dense")
        with pytest.raises(ValueError, match="bin_mode"):
            port_render._prepare(vault, cfg, dirs, CPU)
        assert port_render._prepare(vault, cfg, dirs, CPU, bin_mode="sorted").bin_mode == "sorted"
        monkeypatch.setenv("RAYVERB_BIN", "scatter")
        assert port_render._prepare(vault, cfg, dirs, CPU).bin_mode == "scatter"


@pytest.mark.parametrize("entry, children", [
    ("render_fused", ["rv.atten_spec", "rv.sweep_table", "rv.ray_order"]),
    ("render_irs_batched", ["rv.atten_spec", "rv.sweep_table", "rv.ray_order",
                            "rv.filter_params"]),
])
def test_spans_under_prepare_in_order(vault, monkeypatch, entry, children):
    """The spans directly under rv.prepare, in the order they open, of a
    stats call (profiling.Recording keeps them in that order)."""
    kept = []
    real = profiling.Recording.fold

    def fold(self, flat):
        kept.append(list(self.spans))
        return real(self, flat)

    monkeypatch.setattr(profiling.Recording, "fold", fold)
    cfg = _cfg(32)
    if entry == "render_fused":
        port_render.render_fused(vault, cfg, random_directions(32, seed=4), device="cpu",
                                 stats=True)
    else:
        sources, mics, dirs = _batch_inputs(32)
        port_datagen.render_irs_batched(vault, cfg, sources, mics, dirs, device="cpu",
                                        stats=True)
    spans = kept[-1]
    prepare = [i for i, s in enumerate(spans) if s[0] == "rv.prepare"]
    assert len(prepare) == 1
    assert [s[0] for s in spans if s[3] == prepare[0]] == children


@pytest.mark.parametrize("rays, resorts", [(4096, True), (2048, False)])
def test_render_fused_hands_the_prepared_resort_to_the_trace(vault, monkeypatch, rays,
                                                             resorts):
    """render_fused traces with the resort that _prepare decided: on from
    4,096 rays in the vault, off below."""
    prepared, seen = [], []
    real = port_render._prepare

    class Stop(Exception):
        pass

    def prepare(*a, **k):
        prepared.append(real(*a, **k))
        return prepared[-1]

    def trace(*a, resort=False, **k):
        seen.append(resort)
        raise Stop

    monkeypatch.setattr(port_render, "_prepare", prepare)
    monkeypatch.setattr(port_render, "_trace_impl", trace)
    with pytest.raises(Stop):
        port_render.render_fused(vault, _cfg(rays), random_directions(rays, seed=0),
                                 device="cpu")
    assert seen == [prepared[0].resort] == [resorts]
