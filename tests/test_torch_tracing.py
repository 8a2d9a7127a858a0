"""The port's recorder of spans and counters (rayverb_tpu_torch/utils/
profiling.py): nesting, self time and call ids; nothing recorded, no
profiler range entered and no synchronisation with recording off; the
spans in a torch.profiler session; every named span and counter of a
stats=True render_fused and render_irs_batched beside their flat phase
walls; the executed-pair counters by row range; and the port bench's
readers of them (portbench/metrics), on a program's records and on a
parent's, which keeps none."""

import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from portbench.devtrace import DeviceTrace
from rayverb_tpu_torch import cli, pipeline
from rayverb_tpu_torch.config.schema import parse_config
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import intersect_cuda
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace
from rayverb_tpu_torch.parallel import datagen as port_datagen
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
from rayverb_tpu_torch.utils.directions import random_directions

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
METRICS = REPO / "portbench" / "metrics"

RENDER_SPANS = {"rv.render", "rv.prepare", "rv.atten_spec", "rv.sweep_table", "rv.ray_order",
                "rv.trace", "rv.phase_a", "rv.phase_b", "rv.bounce", "rv.closest_hit",
                "rv.block_order", "rv.sweep", "rv.bin", "rv.dedup", "rv.time_stats",
                "rv.finalize", "rv.pull", "rv.sync"}
DATAGEN_SPANS = {"rv.datagen", "rv.prepare", "rv.atten_spec", "rv.sweep_table", "rv.ray_order",
                 "rv.filter_params", "rv.inputs", "rv.trace", "rv.phase_a", "rv.phase_b",
                 "rv.bounce", "rv.closest_hit", "rv.block_order", "rv.sweep", "rv.bin",
                 "rv.dedup", "rv.finalize", "rv.sync"}
COUNTERS = {"closest_hit.calls", "closest_hit.rows", "launches.closest_hit_sweep",
            "launches.closest_hit_order", "launches.biquad_scan", "launches.ray_keys",
            "sort_keys.plain",
            *(f"pair_tests.{k}" for k in port_trace.SWEEP_KINDS),
            *(f"live_rows.{k}" for k in port_trace.SWEEP_KINDS)}
NREFL = 4


@pytest.fixture(scope="module")
def vault():
    return load_scene(str(REPO / "assets" / "test_models" / "vault.obj"),
                      str(REPO / "assets" / "materials" / "vault.json"))


def _cfg(rays=96, **kw):
    return parse_config(json.dumps({
        "rays": rays, "reflections": NREFL, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [0, 1.75, 0], "mic_position": [0, 1.75, 6],
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
        "trim_predelay": True, **kw}))


def _render(vault, **kw):
    cfg = _cfg()
    return port_render.render_fused(vault, cfg, random_directions(cfg.rays, seed=5),
                                    device="cpu", **kw)


def _batch(vault, **kw):
    src = np.array([[0, 1.75, 0], [0.4, 1.5, 1.0]], np.float32)
    mic = np.array([[0, 1.75, 6], [0.2, 1.2, 4.0]], np.float32)
    dirs = np.stack([random_directions(64, seed=s) for s in (6, 7)])
    return port_datagen.render_irs_batched(vault, _cfg(), src, mic, dirs, device="cpu", **kw)


@pytest.fixture
def not_first(monkeypatch):
    """The process's first call is behind: a call without stats records
    nothing."""
    monkeypatch.setattr(profiling, "_first_pending", False)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_nesting_self_time_and_call_ids(not_first):
    t = {}
    with profiling.call("rv.outer", "cpu", stats=True, timings=t, flat={"a": "rv.a"}):
        with profiling.span("rv.a", index=1):
            time.sleep(0.02)
            with profiling.span("rv.b"):
                time.sleep(0.03)
            with profiling.span("rv.b"):
                time.sleep(0.01)
        profiling.count("c", 2)
        profiling.count("c")
    spans = t["spans"]
    assert set(spans) == {"rv.outer", "rv.a", "rv.b"}
    assert spans["rv.b"]["n"] == 2 and spans["rv.a"]["n"] == 1
    assert spans["rv.a"]["s"] >= 0.06 and spans["rv.b"]["s"] >= 0.04
    assert spans["rv.a"]["self_s"] == pytest.approx(spans["rv.a"]["s"] - spans["rv.b"]["s"])
    assert 0.02 <= spans["rv.a"]["self_s"] < spans["rv.a"]["s"]
    assert t["a"] == spans["rv.a"]["s"] and t["total"] == spans["rv.outer"]["s"]
    assert t["counters"]["c"] == 3
    t2 = {}
    with profiling.call("rv.outer", "cpu", stats=True, timings=t2):
        pass
    assert t2["call"]["id"] > t["call"]["id"] and t2["call"]["t0"] > t["call"]["t0"]
    assert "c" not in t2["counters"]


def test_recording_keeps_parents_and_attributes():
    rec = profiling.Recording("cpu")
    i = rec.open("rv.a", 0.0, {"site": "x"})
    j = rec.open("rv.b", 1.0, {})
    rec.close(j, 2.0)
    rec.close(i, 4.0)
    assert [s[3] for s in rec.spans] == [-1, 0] and rec.spans[0][4] == {"site": "x"}
    assert rec.table() == {"rv.a": {"n": 1, "s": 4.0, "self_s": 3.0},
                           "rv.b": {"n": 1, "s": 1.0, "self_s": 1.0}}


def test_off_enters_no_profiler_range_and_records_nothing(vault, not_first, monkeypatch):
    """With no stats call and no profiler session a span is the shared
    no-op: no profiler range (record_function) is entered, no span or
    counter is kept and the sweeps get no counters."""
    def refuse(*a, **k):
        raise AssertionError("profiler range entered with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Range", refuse)
    assert profiling.span("rv.x") is profiling._OFF is profiling.phase("rv.x")
    assert profiling.pair_sums() is None
    passed = []
    real = port_isect.closest_hit

    def spy(*a, **kw):
        passed.append(kw.get("pair_sums"))
        return real(*a, **kw)

    monkeypatch.setattr(port_trace, "closest_hit", spy)
    once = profiling.once_record()["spans"]
    _, info = _render(vault)
    assert "timings" not in info
    assert profiling._current is None and passed and all(p is None for p in passed)
    assert profiling.once_record()["spans"] == once


def test_sync_only_in_stats_calls(monkeypatch):
    """phase and mark synchronise a stats call's CUDA device and nothing
    else."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    with profiling.phase("rv.x"):
        profiling.mark("k")
    assert synced == []
    monkeypatch.setattr(profiling, "_current", profiling.Recording("cuda", stats=False))
    profiling._current.open("rv.root", 0.0, {})
    with profiling.phase("rv.x"):
        profiling.mark("k")
    assert synced == [] and profiling._current.marks == {}
    monkeypatch.setattr(profiling, "_current", profiling.Recording("cuda", stats=True))
    profiling._current.open("rv.root", time.perf_counter(), {})
    with profiling.phase("rv.x"):
        profiling.mark("k")
    assert synced == [torch.device("cuda")] * 2 and "k" in profiling._current.marks


def test_spans_in_a_profiler_session(vault, not_first):
    """Under torch.profiler every span enters a profiler range, so the rv.*
    ranges land in the session's events beside the operations, on the
    host's side of the trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _render(vault)
    events = [e for e in prof.events() if e.name.startswith("rv.")]
    assert RENDER_SPANS <= {e.name for e in events}
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)
    assert profiling._current is None


def test_profile_dir_writes_a_trace(vault, tmp_path, monkeypatch):
    """render_fused(stats=True) with RAYVERB_PROFILE_DIR set writes one
    Chrome trace of the render into the directory; without stats, none."""
    cfg = _cfg(rays=64)
    out = tmp_path / "profile"
    monkeypatch.setenv("RAYVERB_PROFILE_DIR", str(out))
    d = random_directions(64, seed=1)
    plain, _ = port_render.render_fused(vault, cfg, d, device="cpu")
    assert not out.exists()
    ir, info = port_render.render_fused(vault, cfg, d, device="cpu", stats=True)
    np.testing.assert_array_equal(ir, plain)
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert "timings" in info


def test_first_call_of_the_process(vault, monkeypatch):
    """The process's first call records its whole tree without stats
    (kept once), and later calls without stats record nothing."""
    monkeypatch.setattr(profiling, "_first_pending", True)
    monkeypatch.setattr(profiling, "_first", None)
    _render(vault)
    first = profiling.once_record()["first"]
    assert first["name"] == "rv.render" and first["s"] > 0
    assert {"rv.prepare", "rv.trace", "rv.bounce", "rv.finalize"} <= set(first["spans"])
    assert first["counters"]["closest_hit.calls"] == port_trace.sweep_count(NREFL)
    _render(vault)
    assert profiling.once_record()["first"] is first
    _, info = _render(vault, stats=True)
    assert info["timings"]["once"]["first"] == first


def test_once_spans_are_kept_whatever_the_switches(assets_dir):
    before = profiling.once_record()["spans"].get("rv.load_scene", {"n": 0})["n"]
    load_scene(str(assets_dir / "test_models" / "large_square.obj"),
               str(assets_dir / "materials" / "mat.json"))
    spans = profiling.once_record()["spans"]
    assert spans["rv.load_scene"]["n"] == before + 1
    assert spans["rv.obj_parse"]["n"] >= 1 and spans["rv.scene_compile"]["n"] >= 1


# ---------------------------------------------------------------------------
# the named spans and counters of a stats call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bin_mode", ["sorted", "scatter"])
def test_render_fused_spans_and_counters(vault, bin_mode):
    _, info = _render(vault, stats=True, bin_mode=bin_mode)
    t = info["timings"]
    flat = {k for k, v in t.items() if isinstance(v, float)}
    assert flat == {"trace_bin", "time_stats", "finalize", "pull", "total"}
    assert set(t) == flat | {"spans", "counters", "call", "once"}
    spans, counters = t["spans"], t["counters"]
    assert RENDER_SPANS <= set(spans) and COUNTERS <= set(counters)
    assert all(k.startswith("rv.") for k in spans)
    for key, name in port_render.FLAT_TIMINGS.items():
        assert t[key] == spans[name]["s"]
    assert t["total"] == spans["rv.render"]["s"] >= t["trace_bin"] > spans["rv.prepare"]["s"]
    sweeps = port_trace.sweep_count(NREFL)
    assert spans["rv.closest_hit"]["n"] == counters["closest_hit.calls"] == sweeps
    assert counters["hist.len"] == info["histogram_length"]
    assert 4096 <= counters["finalize.bucket"] <= counters["hist.len"]
    assert spans["rv.bounce"]["n"] == NREFL and spans["rv.trace"]["n"] == 1
    # one image-gate compaction per image bounce; the time stats, the
    # dedup, the content reads and the pull
    assert spans["rv.sync"]["n"] == min(NREFL, port_trace.NUM_IMAGE_SOURCE - 1) + 6
    assert counters["closest_hit.rows"] >= 96 * (2 * NREFL)
    assert all(counters[f"pair_tests.{k}"] > 0 for k in port_trace.SWEEP_KINDS)
    assert counters["launches.closest_hit_sweep"] == 0  # the CPU runs the plain sweep
    # the shadow key of every bounce, by the plain path (96 rays: no resort)
    assert counters["sort_keys.plain"] == 96 * NREFL and counters["launches.ray_keys"] == 0
    assert info["pair_tests_executed"] == {
        k: counters[f"pair_tests.{k}"] for k in port_trace.SWEEP_KINDS}
    assert 0 < info["pair_tests_executed_total"] <= info["pair_tests_issued"]
    for row in spans.values():
        assert row["n"] >= 1 and 0 <= row["self_s"] <= row["s"] + 1e-9


def test_render_irs_batched_spans_and_counters(vault):
    _, _, info = _batch(vault, stats=True)
    t = info["timings"]
    flat = {k for k, v in t.items() if isinstance(v, float)}
    assert flat == {"trace", "bin", "dedup", "finalize", "total"}
    spans, counters = t["spans"], t["counters"]
    assert DATAGEN_SPANS <= set(spans) and COUNTERS <= set(counters)
    for key, name in port_datagen.FLAT_TIMINGS.items():
        assert t[key] == spans[name]["s"]
    assert t["total"] == spans["rv.datagen"]["s"]
    assert spans["rv.closest_hit"]["n"] == port_trace.sweep_count(NREFL)
    assert info["pair_tests_executed"]["bounce"] == counters["pair_tests.bounce"] > 0
    assert counters["sort_keys.plain"] == 2 * 64 * NREFL


@pytest.mark.parametrize("entry", ["render_fused", "render_irs_batched"])
@pytest.mark.parametrize("rays", [2047, 2048])
def test_ray_order_rows_counter(vault, entry, rays):
    """ray_order.rows counts the rows put in Morton order: N for
    render_fused, B x N for render_irs_batched (B = 2), none under 4 x
    RAY_BLOCK_SORT = 2,048 rays, where no order is taken."""
    cfg = _cfg(rays=rays, reflections=1)
    if entry == "render_fused":
        _, info = port_render.render_fused(vault, cfg, random_directions(rays, seed=5),
                                           device="cpu", stats=True)
        pairs = 1
    else:
        src = np.array([[0, 1.75, 0], [0.4, 1.5, 1.0]], np.float32)
        mic = np.array([[0, 1.75, 6], [0.2, 1.2, 4.0]], np.float32)
        dirs = np.stack([random_directions(rays, seed=s) for s in (6, 7)])
        _, _, info = port_datagen.render_irs_batched(vault, cfg, src, mic, dirs,
                                                     device="cpu", stats=True)
        pairs = 2
    counters = info["timings"]["counters"]
    assert info["timings"]["spans"]["rv.ray_order"]["n"] == 1
    if rays < 2048:
        assert "ray_order.rows" not in counters
    else:
        assert counters["ray_order.rows"] == pairs * rays


def test_counters_of_two_passes_sum(vault):
    """Microbatched: the spans of every pass, and the accumulator pulled
    once, in the last pass's finalize, holds every pass's pairs; the rows
    are one pass's (pairs are independent)."""
    _, _, one = _batch(vault, stats=True)
    _, _, two = _batch(vault, stats=True, microbatch=1)
    assert two["passes"] == 2
    assert two["timings"]["spans"]["rv.trace"]["n"] == 2
    assert two["timings"]["counters"]["closest_hit.calls"] == 2 * port_trace.sweep_count(NREFL)
    assert all(v > 0 for v in two["pair_tests_executed"].values())
    assert one["timings"]["counters"]["closest_hit.rows"] == two["timings"]["counters"][
        "closest_hit.rows"]


# ---------------------------------------------------------------------------
# executed pairs by row range
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [
    ((0, 0, 300),),
    ((3, 0, 100), (2, 100, 250), (1, 250, 300)),
    ((2, 0, 0), (1, 0, 37)),
    ((3, 64, 65), (0, 200, 300)),
])
def test_plain_pair_sums_split_at_row_ranges(vault, kinds):
    soup = port_isect.soup_from_scene(vault, device="cpu")
    g = torch.Generator().manual_seed(3)
    o = torch.tensor([0.0, 1.75, 0.0]) + 0.5 * torch.randn((300, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((300, 3), generator=g), dim=-1)
    t_max, t_decide = port_isect._bounds(300, None, None, "cpu")
    # a tenth of the rows dead (t_max 0): they count no pair and no live row
    t_max = torch.where(torch.arange(300) % 10 == 3, 0.0, t_max)
    order, slices, counts = port_isect.sweep_schedule(o, d, t_max, None, soup)
    acc = torch.zeros(profiling.PAIR_SUMS, dtype=torch.int64)
    t, i, executed = port_isect.closest_hit_plain(
        o, d, soup.packed, soup.block_aabb, t_max, t_decide, order, slices,
        counts=counts, with_stats=True, pair_sums=acc, kinds=kinds)
    want = torch.zeros(profiling.PAIR_SUMS, dtype=torch.int64)
    for kind, start, end in kinds:
        want[kind] += executed[start:end].sum()
        want[profiling.LIVE_ROWS + kind] += (t_max[start:end] > 0).sum()
    assert torch.equal(acc, want) and int(acc[:4].sum()) > 0 and int(acc[4:].sum()) > 0
    t2, i2 = port_isect.closest_hit_plain(
        o, d, soup.packed, soup.block_aabb, t_max, t_decide, order, slices,
        counts=counts)
    assert torch.equal(t, t2) and torch.equal(i, i2)


def test_kind_ranges_of_the_kernel():
    arr = intersect_cuda._kind_ranges(((3, 0, 10), (1, 10, 12)), 12)
    assert list(arr) == [0, 10, 3, 10, 12, 1, 0, 0, -1]
    with pytest.raises(ValueError, match="row range"):
        intersect_cuda._kind_ranges(((4, 0, 1),), 1)
    with pytest.raises(ValueError, match="row range"):
        intersect_cuda._kind_ranges(((0, 0, 13),), 12)
    with pytest.raises(ValueError, match="at most"):
        intersect_cuda._kind_ranges(((0, 0, 1),) * 4, 1)


def test_trace_hands_the_accumulator_to_the_sweep_only_with_stats(vault, monkeypatch):
    """The trace's sweeps get the call's (PAIR_SUMS,) accumulator with stats and
    None (the kernel's null pointer) without; the direct path's never."""
    seen = []
    real = port_isect.closest_hit

    def spy(*a, **kw):
        seen.append((kw.get("pair_sums"), kw.get("kinds")))
        return real(*a, **kw)

    monkeypatch.setattr(port_trace, "closest_hit", spy)
    _render(vault, stats=True)
    accs = [p for p, _ in seen]
    assert accs[0] is None and seen[0][1] == ()
    assert all(p is accs[1] for p in accs[1:]) and accs[1].shape == (profiling.PAIR_SUMS,)
    seen.clear()
    monkeypatch.setattr(profiling, "_first_pending", False)
    _render(vault)
    assert all(p is None for p, _ in seen)


# ---------------------------------------------------------------------------
# the port bench's readers
# ---------------------------------------------------------------------------

def _reader(stem):
    spec = importlib.util.spec_from_file_location(f"metric_{stem}", METRICS / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _call_stats(total, prepare, ch_s, ch_n, rows, pairs, t0):
    return {"total": total, "trace_bin": total * 0.9,
            "spans": {"rv.prepare": {"n": 1, "s": prepare, "self_s": prepare},
                      "rv.closest_hit": {"n": ch_n, "s": ch_s, "self_s": ch_s / 2}},
            "counters": {"closest_hit.rows": rows,
                         **{f"pair_tests.{k}": p for k, p in
                            zip(port_trace.SWEEP_KINDS, pairs)}},
            "call": {"id": 2, "t0": t0},
            "once": {"spans": {}, "first": {"name": "rv.render", "t0": 100.0, "s": 2.5}}}


PROGRAM_CTX = {"setup_s": 20.0, "stats": [
    _call_stats(0.6, 0.010, 0.0257, 257, 1000, (100, 200, 300, 400), 110.0),
    _call_stats(0.8, 0.030, 0.0514, 257, 2000, (100, 100, 100, 100), 111.0),
    _call_stats(0.7, 0.020, 0.0771, 257, 500, (50, 50, 50, 50), 112.0)]}
# the parent's records: the flat phase walls only
PARENT_CTX = {"setup_s": 20.0, "stats": [{"trace_bin": 0.5, "time_stats": 0.01,
                                         "finalize": 0.005, "pull": 0.001, "total": 0.6}] * 3}


@pytest.mark.parametrize("stem, want", [
    ("prepare_ms", 20.0),
    ("closest_hit_host_us", 200.0),
    ("pair_tests_per_row", 0.4),
    ("first_call_extra_s", 1.8),
])
def test_reader_on_the_program(stem, want):
    assert _reader(stem)(PROGRAM_CTX) == pytest.approx(want)


STAGE_READERS = ["pre_idle_ms", "phase_a_idle_ms", "phase_b_idle_ms", "post_idle_ms",
                 "unnamed_idle_pct"]


@pytest.mark.parametrize("stem", ["prepare_ms", "closest_hit_host_us", "pair_tests_per_row",
                                  "first_call_extra_s", "live_row_share",
                                  "sweep_table_hit_share", "phase_a_ms", "phase_b_ms",
                                  "graph_capture_ms", *STAGE_READERS])
@pytest.mark.parametrize("ctx", [PARENT_CTX, {"setup_s": 1.0, "stats": []}],
                         ids=["parent", "untraced"])
def test_reader_on_the_parent(stem, ctx):
    assert _reader(stem)(ctx) is None


def test_first_call_reader_needs_this_runs_first_call():
    """A first call that began before the run's set-up (another run's, in
    the same process) is not this run's warm-up."""
    ctx = json.loads(json.dumps(PROGRAM_CTX))
    ctx["setup_s"] = 5.0
    assert _reader("first_call_extra_s")(ctx) is None


def test_readers_on_a_real_stats_call(vault):
    _, info = _render(vault, stats=True)
    ctx = {"setup_s": 1e9, "stats": [info["timings"]]}
    assert _reader("prepare_ms")(ctx) > 0
    assert _reader("closest_hit_host_us")(ctx) > 0
    assert _reader("pair_tests_per_row")(ctx) > 0
    phases = _reader("phase_a_ms")(ctx) + _reader("phase_b_ms")(ctx)
    assert 0 < _reader("phase_a_ms")(ctx) and phases <= 1e3 * info["timings"]["trace_bin"]
    # the CPU's trace runs phase B eagerly: no graph is captured
    assert _reader("graph_capture_ms")(ctx) is None


def test_graph_capture_reader_needs_the_stage_span():
    """graph_capture_ms reads the captures of calls that keep rv.phase_b,
    summed over a call's chunks; a parent's capture span alone reads
    nothing."""
    def call(*spans):
        return {"spans": {name: {"n": 1, "s": s, "self_s": s} for name, s in spans}}

    read = _reader("graph_capture_ms")
    ctx = {"stats": [call(("rv.phase_b", 0.05), ("rv.graph_capture", 0.008)),
                     call(("rv.phase_b", 0.05), ("rv.graph_capture", 0.006)),
                     call(("rv.phase_b", 0.05))]}
    assert read(ctx) == pytest.approx(7.0)
    assert read({"stats": [call(("rv.graph_capture", 0.008))] * 2}) is None


# ---------------------------------------------------------------------------
# the trace's stage spans and the idle gaps by stage
# ---------------------------------------------------------------------------

STAGE_R = 12  # phase A: 9 image bounces; phase B: 3 diffuse bounces


@pytest.fixture
def recordings(monkeypatch):
    """The Recordings of the stats calls made in the test, as they fold."""
    recs = []
    real = profiling.Recording.fold

    def spy(self, flat, root=0):
        recs.append(self)
        return real(self, flat, root)

    monkeypatch.setattr(profiling.Recording, "fold", spy)
    return recs


def _bounces_by_phase(spans):
    """{phase span index: the rv.bounce spans' phase attributes under it} of
    a Recording's spans; asserts each phase span sits in an rv.trace."""
    out = {i: [] for i, s in enumerate(spans) if s[0] in ("rv.phase_a", "rv.phase_b")}
    for i in out:
        assert spans[spans[i][3]][0] == "rv.trace"
    for name, _, _, parent, attrs in spans:
        if name == "rv.bounce":
            assert parent in out
            out[parent].append((spans[parent][0], attrs["phase"]))
    return out


def _assert_phases(spans, traces: int):
    by_phase = _bounces_by_phase(spans)
    image = min(STAGE_R, port_trace.NUM_IMAGE_SOURCE - 1)
    a = [v for i, v in by_phase.items() if spans[i][0] == "rv.phase_a"]
    b = [v for i, v in by_phase.items() if spans[i][0] == "rv.phase_b"]
    assert len(a) == len(b) == traces
    assert all(v == [("rv.phase_a", "image")] * image for v in a)
    assert all(v == [("rv.phase_b", "diffuse")] * (STAGE_R - image) for v in b)


def test_stage_spans_nest_in_a_stats_call(vault, recordings):
    """In a stats call rv.phase_a and rv.phase_b are children of rv.trace;
    phase A holds the min(R, 9) image bounces, phase B the rest."""
    cfg = _cfg(reflections=STAGE_R)
    _, info = port_render.render_fused(vault, cfg, random_directions(96, seed=5),
                                       device="cpu", stats=True)
    (rec,) = recordings
    _assert_phases(rec.spans, traces=1)
    spans = info["timings"]["spans"]
    assert spans["rv.phase_a"]["n"] == spans["rv.phase_b"]["n"] == 1
    assert spans["rv.phase_a"]["s"] + spans["rv.phase_b"]["s"] <= spans["rv.trace"]["s"]


def test_stage_spans_nest_in_a_profiler_session(vault, not_first):
    """Under torch.profiler with recording off, the two stage ranges lie in
    rv.trace's, and hold the image and the diffuse bounces' ranges."""
    cfg = _cfg(reflections=STAGE_R)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port_render.render_fused(vault, cfg, random_directions(96, seed=5), device="cpu")
    events = {}
    for e in prof.events():
        if e.name.startswith("rv."):
            events.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (trace,), (a,), (b,) = events["rv.trace"], events["rv.phase_a"], events["rv.phase_b"]
    assert trace[0] <= a[0] < a[1] <= b[0] < b[1] <= trace[1]

    def inside(r):
        return sum(r[0] <= s and e <= r[1] for s, e in events["rv.bounce"])

    image = min(STAGE_R, port_trace.NUM_IMAGE_SOURCE - 1)
    assert (inside(a), inside(b)) == (image, STAGE_R - image)


@pytest.mark.parametrize("entry", ["datagen", "modular", "render_files"])
def test_every_entry_records_the_stage_spans(vault, entry, recordings, tmp_path):
    """Datagen (one trace a pass), the modular pipeline's dense trace and
    render_files' nested render keep both stage spans, nested as in
    render_fused."""
    cfg = _cfg(reflections=STAGE_R)
    if entry == "datagen":
        src = np.array([[0, 1.75, 0], [0.4, 1.5, 1.0]], np.float32)
        mic = np.array([[0, 1.75, 6], [0.2, 1.2, 4.0]], np.float32)
        dirs = np.stack([random_directions(64, seed=s) for s in (6, 7)])
        _, _, info = port_datagen.render_irs_batched(vault, cfg, src, mic, dirs, device="cpu",
                                                     stats=True, microbatch=1)
        traces = 2  # one pass a pair
    elif entry == "modular":
        res = pipeline.render(cfg, vault, directions=random_directions(96, seed=5),
                              device="cpu", stats=True)
        info, traces = res.info, 1
    else:
        doc = {"rays": 96, "reflections": STAGE_R, "sample_rate": 8000, "bit_depth": 16,
               "source_position": [0, 1.75, 0], "mic_position": [0, 1.75, 6],
               "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]}}
        (tmp_path / "cfg.json").write_text(json.dumps(doc))
        _, info = cli.render_files(str(tmp_path / "cfg.json"),
                                   str(REPO / "assets" / "test_models" / "vault.obj"),
                                   str(REPO / "assets" / "materials" / "vault.json"),
                                   str(tmp_path / "out.wav"), device="cpu", stats=True)
        traces = 1
    # the render nested in rv.cli folds into rv.cli's one Recording
    rec = recordings[-1]
    assert all(r is rec for r in recordings)
    _assert_phases(rec.spans, traces=traces)
    spans = info["timings"]["spans"]
    assert spans["rv.phase_a"]["n"] == spans["rv.phase_b"]["n"] == traces


def _stage_window(units=2):
    """A profiled window of ``units`` calls with known gaps (us):

        host   rv.render [0, 1000]: rv.prepare [0, 100], rv.trace [100, 800]
               (rv.phase_a [110, 500] > rv.bin [300, 400]; rv.phase_b
               [500, 700]; rv.bin [700, 790]), rv.finalize [800, 950]
        device [20, 40] [60, 300] [380, 600] [640, 660] [760, 900]
               [960, 980]

    Gaps by middle: [0, 20] and [40, 60] pre; [300, 380] in phase A's
    rv.bin, phase A; [600, 640] phase B; [660, 760] (middle 710) in the
    trace's rv.bin after the phases, post; [900, 960] post; [980, 1000],
    the root's own time, unnamed. A host event after the last span (the
    profiler's own, at its stop) bounds nothing."""
    host = [("rv.render", 0, 1000), ("rv.prepare", 0, 100), ("rv.sweep_table", 10, 90),
            ("rv.trace", 100, 800), ("rv.phase_a", 110, 500), ("rv.bin", 300, 400),
            ("rv.sync", 310, 390), ("rv.phase_b", 500, 700), ("rv.bin", 700, 790),
            ("rv.finalize", 800, 950), ("rv.sync", 900, 940), ("aten::mul", 905, 906),
            ("cudaDeviceSynchronize", 1000, 1040)]
    dev = [("k", a, b) for a, b in
           ((20, 40), (60, 300), (380, 600), (640, 660), (760, 900), (960, 980))]
    return DeviceTrace(dev, [(n, float(a), float(b)) for n, a, b in host], 1000e-6, units)


def test_stage_readers_give_each_gap_to_the_outermost_stage():
    ctx = {"profile": _stage_window(units=2), "stats": []}
    want = {"pre_idle_ms": 40e-3 / 2, "phase_a_idle_ms": 80e-3 / 2,
            "phase_b_idle_ms": 40e-3 / 2, "post_idle_ms": (100 + 60) * 1e-3 / 2}
    for stem, ms in want.items():
        assert _reader(stem)(ctx) == pytest.approx(ms)
    assert _reader("unnamed_idle_pct")(ctx) == pytest.approx(100 * 20 / 1000)


def test_stage_idles_sum_to_device_idle_pct():
    """The stage idles times the calls, over the window's wall, plus the
    unnamed share give device_idle_pct, the edges of the window counted."""
    for units in (1, 2, 3):
        ctx = {"profile": _stage_window(units), "stats": []}
        wall_ms = 1e3 * ctx["profile"].wall_s
        named = sum(_reader(stem)(ctx) for stem in STAGE_READERS[:4]) * units
        total = 100 * named / wall_ms + _reader("unnamed_idle_pct")(ctx)
        assert total == pytest.approx(_reader("device_idle_pct")(ctx))
        assert total == pytest.approx(34.0)


def test_stage_readers_read_nothing_without_device_ops_or_stage_spans():
    """No device operation (a CPU run), or no phase range (a parent's
    program): every stage reader reads nothing."""
    full = _stage_window()
    no_device = DeviceTrace([], full.host_ops, full.wall_s, full.units)
    no_phases = DeviceTrace(full.device_ops, [h for h in full.host_ops
                                              if h[0] not in ("rv.phase_a", "rv.phase_b")],
                            full.wall_s, full.units)
    for prof in (no_device, no_phases, None):
        for stem in STAGE_READERS:
            assert _reader(stem)({"profile": prof, "stats": []}) is None


# ---------------------------------------------------------------------------
# live rows by sweep kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model, materials, doc", [
    ("stonehenge.obj", "mat.json", {"source_position": [0, 2, 0], "mic_position": [0, 2, 10],
                                    "filter": "twopass", "hipass": False}),
    ("vault.obj", "vault.json", {}),
], ids=["stonehenge", "vault"])
def test_live_rows_equal_a_host_count(model, materials, doc, monkeypatch):
    """live_rows.<kind> of a stats render are the rows of that kind that
    enter the sweeps with t_max > 0, counted on the host from the sweeps'
    own arguments; the open scene loses most of its rays, the vault none."""
    scene = load_scene(str(REPO / "assets" / "test_models" / model),
                       str(REPO / "assets" / "materials" / materials))
    cfg = _cfg(rays=512, reflections=12, **doc)
    want = dict.fromkeys(port_trace.SWEEP_KINDS, 0)
    real = port_isect.closest_hit

    def spy(*a, **kw):
        for kind, start, end in kw.get("kinds", ()):
            want[port_trace.SWEEP_KINDS[kind]] += int((kw["t_max"][start:end] > 0).sum())
        return real(*a, **kw)

    monkeypatch.setattr(port_trace, "closest_hit", spy)
    _, info = port_render.render_fused(scene, cfg, random_directions(cfg.rays, seed=5),
                                       device="cpu", stats=True)
    counters = info["timings"]["counters"]
    assert {k: counters[f"live_rows.{k}"] for k in want} == want
    share = want["bounce"] / (cfg.rays * cfg.reflections)
    assert share < 0.5 if model == "stonehenge.obj" else share > 0.99


def test_live_rows_off_records_and_passes_nothing(vault, monkeypatch):
    """Without stats, even in the process's first call (which records its
    spans and host counters), no sweep is handed an accumulator and no
    live_rows or pair_tests counter is kept."""
    monkeypatch.setattr(profiling, "_first_pending", True)
    monkeypatch.setattr(profiling, "_first", None)
    passed = []
    real = port_isect.closest_hit

    def spy(*a, **kw):
        passed.append(kw.get("pair_sums"))
        return real(*a, **kw)

    monkeypatch.setattr(port_trace, "closest_hit", spy)
    _, info = _render(vault)
    counters = profiling.once_record()["first"]["counters"]
    assert "timings" not in info and passed and all(p is None for p in passed)
    assert counters["closest_hit.calls"] == len(passed)
    assert not [k for k in counters if k.startswith(("live_rows.", "pair_tests."))]


def test_live_row_share_reader(vault):
    """live_row_share reads live_rows.bounce over rays x reflections x pairs,
    in percent, the median over the window's calls."""
    ctx = {"rays": 100, "reflections": 4, "pairs": 2, "stats": [
        {"counters": {"live_rows.bounce": n}} for n in (400, 200, 800)]}
    assert _reader("live_row_share")(ctx) == pytest.approx(50.0)
    _, info = _render(vault, stats=True)
    ctx = {"rays": 96, "reflections": NREFL, "pairs": 1, "stats": [info["timings"]]}
    assert 99.0 <= _reader("live_row_share")(ctx) <= 100.0


# ---------------------------------------------------------------------------
# the modular pipeline's root call
# ---------------------------------------------------------------------------

MODULAR_STAGES = ["rv.dense_trace", "rv.population", "rv.attenuate", "rv.predelay",
                  "rv.flatten", "rv.filter", "rv.mix"]
TWO_SPEAKERS = {"speakers": [{"direction": [-1, 0, -1], "shape": 0.5},
                             {"direction": [1, 0, -1], "shape": 0.5}]}


def _modular_cfg(**kw):
    return _cfg(attenuation_model=TWO_SPEAKERS, trim_tail=True, output_mode="all",
                **{"filter": "linkwitz_riley", "hipass": 60, **kw})


def _modular(vault, stats=False, **kw):
    cfg = _modular_cfg(**kw)
    return pipeline.render(cfg, vault, directions=random_directions(cfg.rays, seed=5),
                           device="cpu", stats=stats)


def test_flat_key_sums_the_spans_it_names(not_first):
    t = {}
    flat = {"ab": ("rv.a", "rv.b"), "a": "rv.a", "gone": ("rv.z",), "bz": ("rv.b", "rv.z")}
    with profiling.call("rv.outer", "cpu", stats=True, timings=t, flat=flat):
        with profiling.span("rv.a"):
            time.sleep(0.01)
        with profiling.span("rv.b"):
            time.sleep(0.01)
    spans = t["spans"]
    assert t["ab"] == pytest.approx(spans["rv.a"]["s"] + spans["rv.b"]["s"])
    assert t["a"] == spans["rv.a"]["s"] and t["bz"] == spans["rv.b"]["s"]
    assert "gone" not in t


def test_modular_root_call_stages_and_counters(vault, not_first, monkeypatch):
    """pipeline.render(stats=True) is the root rv.modular, with a call id,
    its total and the once record; its stages are spans in the pipeline's
    order, each flat key the sum of the stage walls it names; the host's
    waits carry their sites; the counters count the population, the dedup,
    the table build and the filter bank's samples."""
    sites = []
    real_open = profiling.Recording.open

    def spy(self, name, start, attrs):
        if name == "rv.sync":
            sites.append(attrs["site"])
        return real_open(self, name, start, attrs)

    monkeypatch.setattr(profiling.Recording, "open", spy)
    res = _modular(vault, stats=True)
    t = res.info["timings"]
    assert {"call", "once", "spans", "counters", "total"} <= set(t)
    assert t["call"]["id"] > 0 and set(t["once"]) == {"spans", "first"}
    spans, counters = t["spans"], t["counters"]
    assert next(iter(spans)) == "rv.modular"
    assert t["total"] == spans["rv.modular"]["s"] > 0 and spans["rv.modular"]["n"] == 1
    assert [n for n in spans if n in MODULAR_STAGES] == MODULAR_STAGES
    for key, names in pipeline.FLAT_TIMINGS.items():
        assert t[key] == pytest.approx(sum(spans[n]["s"] for n in names))
    assert t["total"] >= sum(t[k] for k in pipeline.FLAT_TIMINGS)
    assert {"rv.sweep_table", "rv.trace", "rv.bounce", "rv.closest_hit", "rv.dedup"} <= set(spans)
    assert spans["rv.trace"]["n"] == 1 and spans["rv.bounce"]["n"] == NREFL
    assert {"dedup_index", "predelay", "hist_len", "pull"} <= set(sites)
    assert counters["sweep_table.builds"] == 1
    assert counters["population.rows"] == 96 * (NREFL + port_trace.NUM_IMAGE_SOURCE)
    assert 96 <= counters["dedup.images_in"] and 1 <= counters["dedup.images_kept"]
    assert counters["dedup.images_kept"] <= counters["dedup.images_in"]
    assert counters["closest_hit.calls"] == port_trace.sweep_count(NREFL)
    assert all(counters[f"pair_tests.{k}"] > 0 for k in port_trace.SWEEP_KINDS)
    assert counters["bounces.graph"] + counters["bounces.eager"] == NREFL
    assert counters["launches.biquad_scan"] == 0  # the CPU runs the plain scan
    assert res.info["device"] == "cpu" and res.info["filter_method"] == "scan"


@pytest.mark.parametrize("filt, passes", [("linkwitz_riley", 4), ("twopass", 2),
                                          ("onepass", 1)])
def test_modular_series_samples(vault, filt, passes):
    """biquad.series_samples: every pass of the bank adds its series
    (channels x 8 bands) times the histogram's length."""
    res = _modular(vault, stats=True, filter=filt)
    length = res.info["histogram_length"]
    assert length > res.channels.shape[-1] > 100
    assert res.info["timings"]["counters"]["biquad.series_samples"] == passes * 2 * 8 * length


def test_modular_output_is_the_same_with_stats(vault, not_first):
    """Stats add spans, synchronisations and counters, not arithmetic."""
    off = _modular(vault)
    on = _modular(vault, stats=True)
    assert "timings" not in off.info and "timings" in on.info
    assert on.channels.tobytes() == off.channels.tobytes()
    assert on.channels.shape == off.channels.shape and on.predelay == off.predelay


def test_modular_first_call_of_the_process(vault, monkeypatch):
    """A process's first modular render records its tree, which
    first_call_extra_s reads, and no stats call is needed for it."""
    monkeypatch.setattr(profiling, "_first_pending", True)
    monkeypatch.setattr(profiling, "_first", None)
    res = _modular(vault)
    first = profiling.once_record()["first"]
    assert "timings" not in res.info
    assert first["name"] == "rv.modular" and first["s"] > 0
    assert set(MODULAR_STAGES) <= set(first["spans"])
    assert first["counters"]["sweep_table.builds"] == 1


def test_render_from_raw_is_a_root_call(vault, not_first):
    """render_from_raw runs the same root without the trace's stages."""
    direct = _modular(vault)
    again = pipeline.render_from_raw(_modular_cfg(), direct.raw, device="cpu", stats=True)
    t = again.info["timings"]
    assert again.channels.tobytes() == direct.channels.tobytes()
    assert "trace" not in t and "population" not in t and {"post", "process"} <= set(t)
    assert next(iter(t["spans"])) == "rv.modular"
