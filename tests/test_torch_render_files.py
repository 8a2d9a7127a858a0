"""The CLI's per-render function (cli.render_files) on the CPU: the files it
and cli.main write equal, byte for byte, those of the CLI's earlier
sequence (config, scene, random_directions, the render, write_audio); gen's
records and report keys, with and without --stats; the root rv.cli and the
render nested in it (utils/profiling.py); and the sweep-table and filter-
parameter cache counters over a sequence of corpus combinations against an
LRU model of the caches."""

import collections
import functools
import json
import time

import numpy as np
import pytest
import torch

from rayverb_tpu_torch import cli, gen
from rayverb_tpu_torch import pipeline as port_pipeline
from rayverb_tpu_torch.config.schema import load_config
from rayverb_tpu_torch.io.audio import write_audio
from rayverb_tpu_torch.ops import intersect as port_intersect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
from rayverb_tpu_torch.utils.directions import random_directions

torch.set_num_threads(1)

RAYS, REFLECTIONS = 256, 8
CLI_CHILDREN = ["rv.config", "rv.load_scene", "rv.directions", "rv.render", "rv.write"]


def _cut(combo, tmp_path, rays=RAYS, reflections=REFLECTIONS, paths=gen.combo_paths):
    """The combination's files, its config cut to ``rays`` x ``reflections``
    and written into ``tmp_path``."""
    cfg, model, materials = paths(combo)
    doc = json.load(open(cfg))
    doc.update(rays=rays, reflections=reflections)
    path = tmp_path / f"{combo[0]}.json"
    path.write_text(json.dumps(doc))
    return str(path), model, materials


@pytest.fixture
def not_first(monkeypatch):
    monkeypatch.setattr(profiling, "_first_pending", False)


@pytest.fixture
def recordings(monkeypatch):
    """Every profiling.Recording made from here on."""
    made = []

    class Kept(profiling.Recording):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(profiling, "Recording", Kept)
    return made


def _earlier_cli(cfg, model, materials, out, seed, pipeline):
    """The CLI's sequence before render_files: config, scene, directions,
    the render, write_audio."""
    config = load_config(cfg)
    scene = load_scene(model, materials, verbose=config.verbose)
    directions = random_directions(config.rays, seed=seed)
    if pipeline == "fused":
        channels, _ = port_render.render_fused(scene, config, directions, device="cpu")
    else:
        channels = port_pipeline.render(config, scene, directions=directions,
                                        device="cpu").channels
    write_audio(out, channels, config.sample_rate, config.bit_depth)
    return channels


@pytest.mark.parametrize("combo, pipeline", [
    (("oct", "random_pillars", "mat"), "fused"),
    (("hrtf_vault_l", "random_pillars", "mat"), "fused"),
    (("far", "echo_tunnel", "mat"), "fused"),
    (("near_c", "small_pentagon", "bright"), "modular"),
], ids=["oct", "hrtf", "tunnel", "modular"])
def test_files_equal_the_earlier_sequence(combo, pipeline, tmp_path, not_first):
    cfg, model, materials = _cut(combo, tmp_path)
    seed = gen.COMBOS.index(combo)
    want = _earlier_cli(cfg, model, materials, str(tmp_path / "want.wav"), seed, pipeline)
    got, info = cli.render_files(cfg, model, materials, str(tmp_path / "files.wav"),
                                 pipeline=pipeline, seed=seed, device="cpu")
    assert np.array_equal(got, want) and "timings" not in info
    assert cli.main([cfg, model, materials, str(tmp_path / "cli.wav"), "--seed", str(seed),
                     "--device", "cpu", "--pipeline", pipeline]) == 0
    blob = (tmp_path / "want.wav").read_bytes()
    assert (tmp_path / "files.wav").read_bytes() == blob == (tmp_path / "cli.wav").read_bytes()
    # the caller's directions in place of the seeded ones
    again, _ = cli.render_files(cfg, model, materials, str(tmp_path / "given.wav"),
                                pipeline=pipeline, device="cpu",
                                directions=random_directions(RAYS, seed=seed))
    assert np.array_equal(again, want)


RECORD = {"combo", "index", "seed", "run", "wall_s", "rc", "channels", "samples"}
REPORT = {"rendered", "failures", "failed_combos", "total", "wall_seconds",
          "per_render_seconds", "pipeline", "mode", "ext", "device", "walls_by_model",
          "renders"}


def test_gen_records_and_report(tmp_path, monkeypatch):
    """gen's records keep their keys and its report scripts/gen.py's; with
    --stats each record gains its flat timings and cache counters; the
    files equal render_files' own; a failed render keeps the CLI's text."""
    monkeypatch.setattr(gen, "combo_paths", lambda combo: _cut(combo, tmp_path, 200, 6))
    assert gen.main(["--outdir", str(tmp_path / "a"), "--only", "small_square", "--limit", "2",
                     "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "a" / "report.json").read_text())
    assert set(report) == REPORT and [set(r) for r in report["renders"]] == [RECORD] * 2
    assert gen.main(["--outdir", str(tmp_path / "b"), "--only", "small_square", "--limit", "2",
                     "--device", "cpu", "--stats"]) == 0
    report = json.loads((tmp_path / "b" / "report.json").read_text())
    assert set(report) == REPORT
    for r in report["renders"]:
        assert set(r) == RECORD | {"timings", "counters"}
        assert set(r["timings"]) == {"load", "render", "write", "trace_bin", "time_stats",
                                     "finalize", "pull"}
        assert set(r["counters"]) == set(gen.CACHE_COUNTERS)
        assert sum(r["counters"][f"filter_params.{k}"] for k in ("hits", "uploads", "builds")) == 1
        assert r["counters"]["sweep_table.hits"] + r["counters"]["sweep_table.builds"] == 1
    for name in ("small_square_near_c_mat", "small_square_near_l_mat"):
        path = f"small_square/{name}.wav"
        assert (tmp_path / "a" / path).read_bytes() == (tmp_path / "b" / path).read_bytes()
    k = gen.COMBOS.index(("near_c", "small_square", "mat"))
    cli.render_files(*_cut(gen.COMBOS[k], tmp_path, 200, 6), str(tmp_path / "one.wav"), seed=k,
                     device="cpu")
    assert (tmp_path / "one.wav").read_bytes() == (
        tmp_path / "a" / "small_square" / "small_square_near_c_mat.wav").read_bytes()

    missing = str(tmp_path / "missing.json")
    monkeypatch.setattr(gen, "combo_paths", lambda combo: (missing, *_cut(combo, tmp_path)[1:]))
    report = gen.render([(0, gen.COMBOS[0])], str(tmp_path / "c"), device="cpu",
                        log=lambda s: None)
    (rec,) = report["renders"]
    assert rec["rc"] == 1 and rec["error"] == f"input file {missing} does not exist"
    assert report["failed_combos"] == [rec["combo"]]


def test_render_files_tree(tmp_path, recordings, not_first):
    """One Recording for the whole call: rv.cli holds rv.config,
    rv.load_scene, rv.directions, rv.render and rv.write in that order; the
    nested render's flat keys, spans and counters are in rv.cli's timings,
    its trace_bin measured from rv.render's start; write.bytes is the
    file's size."""
    cfg, model, materials = _cut(("near_c", "bedroom", "mat"), tmp_path)
    out = tmp_path / "ir.wav"
    _, info = cli.render_files(cfg, model, materials, str(out), seed=3, device="cpu",
                               stats=True)
    (rec,) = recordings
    assert [s[0] for s in rec.spans if s[3] == 0] == CLI_CHILDREN
    render = next(i for i, s in enumerate(rec.spans) if s[0] == "rv.render")
    assert rec.spans[render][3] == 0 and rec.roots == [0]
    t = info["timings"]
    spans, counters = t["spans"], t["counters"]
    assert {"rv.cli", "rv.obj_parse", "rv.scene_compile", "rv.prepare", "rv.trace",
            "rv.finalize", "rv.filter_params", *CLI_CHILDREN} <= set(spans)
    flat = {k for k, v in t.items() if isinstance(v, float)}
    assert flat == {"load", "render", "write", "trace_bin", "time_stats", "finalize", "pull",
                    "total"}
    assert t["total"] == spans["rv.cli"]["s"] > t["render"] == spans["rv.render"]["s"]
    assert t["load"] == spans["rv.config"]["s"] + spans["rv.load_scene"]["s"]
    assert t["write"] == spans["rv.write"]["s"]
    assert t["finalize"] == spans["rv.finalize"]["s"]
    assert rec.spans[render][1] + t["trace_bin"] <= rec.spans[render][2]
    assert t["trace_bin"] > spans["rv.prepare"]["s"]
    assert counters["write.bytes"] == out.stat().st_size
    assert counters["closest_hit.calls"] > 0 and counters["pair_tests.bounce"] > 0
    assert counters.get("sweep_table.hits", 0) + counters.get("sweep_table.builds", 0) == 1
    assert sum(counters.get(f"filter_params.{k}", 0) for k in ("hits", "uploads", "builds")) == 1
    assert t["call"]["id"] == rec.id and spans["rv.render"]["n"] == 1
    assert info["pair_tests_executed"]["bounce"] == counters["pair_tests.bounce"]

    # the caller's directions: no rv.directions
    cli.render_files(cfg, model, materials, str(out), device="cpu", stats=True,
                     directions=random_directions(RAYS, seed=3))
    assert [s[0] for s in recordings[1].spans if s[3] == 0] == [
        c for c in CLI_CHILDREN if c != "rv.directions"]


def test_lone_render_and_first_call(tmp_path, recordings, monkeypatch):
    """A lone render_fused records as before (its own root and keys); the
    process's first call through render_files is rv.cli, its render a
    span inside it, and later calls without stats record nothing."""
    cfg, model, materials = _cut(("near_c", "bedroom", "mat"), tmp_path)
    config = load_config(cfg)
    scene = load_scene(model, materials)
    monkeypatch.setattr(profiling, "_first_pending", False)
    _, info = port_render.render_fused(scene, config, random_directions(RAYS, seed=1),
                                       device="cpu", stats=True)
    t = info["timings"]
    assert {k for k, v in t.items() if isinstance(v, float)} == {
        "trace_bin", "time_stats", "finalize", "pull", "total"}
    assert t["total"] == t["spans"]["rv.render"]["s"] and "rv.cli" not in t["spans"]
    assert len(recordings) == 1

    monkeypatch.setattr(profiling, "_first_pending", True)
    monkeypatch.setattr(profiling, "_first", None)
    cli.render_files(cfg, model, materials, str(tmp_path / "a.wav"), seed=1, device="cpu")
    first = profiling.once_record()["first"]
    assert first["name"] == "rv.cli" and {"rv.render", "rv.write", "rv.trace"} <= set(first["spans"])
    assert len(recordings) == 2
    cli.render_files(cfg, model, materials, str(tmp_path / "b.wav"), seed=1, device="cpu")
    assert len(recordings) == 2 and profiling.once_record()["first"] is first


def test_nested_call(recordings, not_first):
    """A stats call inside a stats call is a span of it: one Recording; the
    inner timings hold its own subtree, flat keys and marks (from its own
    root); the outer timings every flat key."""
    outer, inner = {}, {}
    with profiling.call("rv.outer", "cpu", stats=True, timings=outer, flat={"a": "rv.a"}):
        with profiling.span("rv.a"):
            time.sleep(0.01)
        with profiling.call("rv.inner", "cpu", stats=True, timings=inner, flat={"b": "rv.b"}):
            with profiling.span("rv.b"):
                time.sleep(0.01)
            profiling.mark("m")
            profiling.count("c")
    assert len(recordings) == 1
    assert set(inner["spans"]) == {"rv.inner", "rv.b"}
    assert inner["total"] == inner["spans"]["rv.inner"]["s"] < outer["total"]
    assert inner["b"] == outer["b"] and "a" not in inner and outer["a"] >= 0.01
    assert inner["m"] == outer["m"] <= inner["total"]
    assert outer["counters"]["c"] == 1
    assert set(outer["spans"]) == {"rv.outer", "rv.a", "rv.inner", "rv.b"}


class _LRU:
    def __init__(self, size):
        self.size, self.keys = size, collections.OrderedDict()

    def get(self, key) -> bool:
        hit = key in self.keys
        if hit:
            self.keys.move_to_end(key)
        else:
            self.keys[key] = None
            if len(self.keys) > self.size:
                self.keys.popitem(last=False)
        return hit


# the vault, a room twice (two configs), two other scenes (a room's other
# materials among them), and the room again
SEQUENCE = [("vault", "vault", "vault"), ("near_c", "small_square", "mat"),
            ("near_l", "small_square", "mat"), ("far", "large_square", "mat"),
            ("near_l", "small_square", "damped"), ("near_r", "small_square", "mat")]


@pytest.mark.parametrize("sizes", [(4, 16, 4), (2, 16, 1)], ids=["process", "small"])
def test_cache_counters_follow_an_lru_model(sizes, tmp_path, monkeypatch, not_first):
    """sweep_table.* and filter_params.* of each call of a sequence equal
    an LRU model of the soup cache and of the host and device filter
    caches, keyed by the scene's files and by (cutoff, finalize bucket),
    at the process's sizes and at smaller ones."""
    soups, host, device = sizes
    monkeypatch.setattr(port_intersect, "_SOUPS", port_intersect.SoupCache(soups))
    monkeypatch.setattr(port_render, "_finalize_filter_params_cached", functools.lru_cache(
        maxsize=host)(port_render._finalize_filter_params_cached.__wrapped__))
    monkeypatch.setattr(port_render, "_device_filter_params", functools.lru_cache(
        maxsize=device)(port_render._device_filter_params.__wrapped__))
    model = [_LRU(soups), _LRU(host), _LRU(device)]
    kinds = collections.Counter()
    for i, combo in enumerate(SEQUENCE):
        cfg, obj, materials = _cut(combo, tmp_path, reflections=12)
        _, info = cli.render_files(cfg, obj, materials, str(tmp_path / "ir.wav"), seed=i,
                                   device="cpu", stats=True)
        c = info["timings"]["counters"]
        key = (load_config(cfg).hipass, c["finalize.bucket"])
        table = "hits" if model[0].get((obj, materials)) else "builds"
        on_device, on_host = model[2].get(key), model[1].get(key)
        params = "hits" if on_device else "uploads" if on_host else "builds"
        want = {f"sweep_table.{table}": 1, f"filter_params.{params}": 1}
        got = {k: v for k, v in c.items() if k.split(".")[0] in ("sweep_table", "filter_params")}
        assert got == want, (i, combo)
        kinds.update(want)
    assert kinds["sweep_table.hits"] and kinds["sweep_table.builds"]
    assert kinds["filter_params.hits"] and kinds["filter_params.builds"]
    if device == 1:
        assert kinds["filter_params.uploads"]
