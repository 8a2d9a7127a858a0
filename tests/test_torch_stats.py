"""Executed pair tests by sweep kind, and the 'scatter' bin mode, of the
PyTorch port's render_fused.

The kinds follow the JAX trace (rayverb_tpu/ops/trace.py:492-523): bounce
hits, reversed mic-shadow rows, image-path validation segments and image
mic visibility. Every stats=True call counts them: each sweep adds its
executed pairs by row kind into the call's (4,) accumulator in its own
launch (utils/profiling.py), split at the row ranges of the kinds exactly
(the JAX trace attributes 512-row groups), so the kinds must sum to the
per-row counters of every counted sweep, exactly.

scatter against sorted: the diffuse bins sum in another order (index_add_
row by row against segmented tree sums), so the IRs agree to float32
summation noise, 1e-5 of peak.
"""

import json

import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch.config.schema import parse_config
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace
from rayverb_tpu_torch.utils import profiling

from test_torch_render import _doc

torch.set_num_threads(1)

NOISE = 1e-5  # of peak: float32 summation order

HRTF = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}


@pytest.fixture(scope="module")
def box(assets_dir):
    return load_scene(
        str(assets_dir / "test_models" / "large_square.obj"),
        str(assets_dir / "materials" / "mat.json"),
    )


@pytest.fixture
def recorded_sweeps(monkeypatch):
    """Every closest_hit call of the trace: (rows, decided, counted, the
    executed pairs of its rows by kind or None), the per-row counts taken
    beside the accumulator and split at the call's row ranges."""
    calls = []

    def record(origins, dirs, soup, **kw):
        hit, executed = port_isect.closest_hit(origins, dirs, soup, with_stats=True, **kw)
        counted = kw.get("pair_sums") is not None
        by_kind = None
        if counted:
            by_kind = dict.fromkeys(port_trace.SWEEP_KINDS, 0)
            for kind, start, end in kw["kinds"]:
                by_kind[port_trace.SWEEP_KINDS[kind]] += int(executed[start:end].sum())
        calls.append((origins.shape[0], kw.get("t_decide") is not None, counted, by_kind))
        return hit

    monkeypatch.setattr(port_trace, "closest_hit", record)
    return calls


def _render(box, rays=200, reflections=12, **kw):
    doc = _doc("large_square", "all", True, rays=rays, reflections=reflections)
    return port_render.render_fused(
        box, parse_config(json.dumps(doc)), random_directions(rays, seed=3),
        device="cpu", **kw,
    )


def test_executed_pairs_by_kind(box, recorded_sweeps):
    _, info = _render(box, stats=True)
    ex = info["pair_tests_executed"]
    assert list(ex) == list(port_trace.SWEEP_KINDS) == ["bounce", "imgvis", "seg", "shadow"]
    assert all(isinstance(v, int) and v > 0 for v in ex.values()), ex
    assert ex == {k: info["timings"]["counters"][f"pair_tests.{k}"] for k in ex}
    counted = [c for c in recorded_sweeps if c[2]]
    # every sweep but the direct path's carries counters (JAX counts the
    # same sweeps); the kinds are the per-row counts split at the ranges
    assert len(counted) == len(recorded_sweeps) - 1 == 2 * 12
    for k in port_trace.SWEEP_KINDS:
        assert ex[k] == sum(c[3][k] for c in counted)
    # bounce sweeps are the closest-hit ones (no t_decide)
    assert ex["bounce"] == sum(sum(c[3].values()) for c in counted if not c[1])
    assert ex["shadow"] + ex["seg"] + ex["imgvis"] == sum(
        sum(c[3].values()) for c in counted if c[1])
    assert 0 < info["pair_tests_executed_total"] <= info["pair_tests_issued"]


def test_executed_pairs_split_at_row_ranges(box, monkeypatch):
    """The image-phase sweep's rows are shadow, then segments, then
    visibility: with every row counting 1, each kind receives exactly its
    own rows."""
    real = port_isect.closest_hit

    def marked(origins, dirs, soup, pair_sums=None, kinds=(), **kw):
        for kind, start, end in kinds if pair_sums is not None else ():
            pair_sums[kind] += end - start
        return real(origins, dirs, soup, **kw)

    monkeypatch.setattr(port_trace, "closest_hit", marked)
    rays, reflections = 64, 3
    _, info = _render(box, rays=rays, reflections=reflections, stats=True)
    ex = info["pair_tests_executed"]
    # one row per ray in each bounce and shadow sweep
    assert ex["bounce"] == ex["shadow"] == rays * reflections
    # validated rays g_k issue k+1 segment rows and one visibility row
    assert ex["seg"] >= ex["imgvis"] > 0


def test_stats_off_runs_without_counters(box, recorded_sweeps, monkeypatch):
    """Without stats (and past the process's first call) no sweep gets the
    accumulator; with stats every sweep but the direct path's does."""
    monkeypatch.setattr(profiling, "_first_pending", False)
    _, info = _render(box, stats=False)
    assert "pair_tests_executed" not in info and "timings" not in info
    assert not any(c[2] for c in recorded_sweeps)
    recorded_sweeps.clear()
    _, info = _render(box, stats=True)
    assert info["pair_tests_executed_total"] > 0
    assert [c[2] for c in recorded_sweeps] == [False] + [True] * (len(recorded_sweeps) - 1)


def test_executed_pairs_accumulate_over_chunks(box):
    _, one = _render(box, rays=300, reflections=4, stats=True)
    _, chunked = _render(box, rays=300, reflections=4, stats=True, ray_chunk=128)
    assert chunked["chunks"] == 3
    # the groups' block orders change with the chunking, and so may the
    # counts; every kind is counted across the chunks
    for k in port_trace.SWEEP_KINDS:
        assert chunked["pair_tests_executed"][k] > 0
    assert chunked["pair_tests_executed_total"] <= one["pair_tests_issued"]


@pytest.mark.parametrize("att", ["speakers", "hrtf"])
def test_scatter_matches_sorted(box, att):
    doc = _doc("large_square", "all", True, rays=256, reflections=8)
    if att == "hrtf":
        doc["attenuation_model"] = HRTF
    cfg = parse_config(json.dumps(doc))
    dirs = random_directions(256, seed=4)
    runs = {
        mode: port_render.render_fused(box, cfg, dirs, device="cpu", bin_mode=mode)
        for mode in ("sorted", "scatter")
    }
    (a, ainfo), (b, binfo) = runs["sorted"], runs["scatter"]
    assert (ainfo["bin_mode"], binfo["bin_mode"]) == ("sorted", "scatter")
    assert binfo["predelay"] == ainfo["predelay"]
    assert a.shape == b.shape
    assert np.abs(b.astype(np.float64) - a).max() <= NOISE * np.abs(a).max()


def test_bin_mode_reads_the_environment(box, monkeypatch):
    monkeypatch.setenv("RAYVERB_BIN", "scatter")
    _, info = _render(box, rays=16, reflections=2)
    assert info["bin_mode"] == "scatter"
    monkeypatch.delenv("RAYVERB_BIN")
    _, info = _render(box, rays=16, reflections=2)
    assert info["bin_mode"] == "sorted"
    with pytest.raises(ValueError, match="bin_mode"):
        _render(box, rays=16, reflections=2, bin_mode="dense")
