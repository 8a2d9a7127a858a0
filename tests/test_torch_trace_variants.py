"""The JAX trace's other sweep schedules (rayverb_tpu_torch/trace_variants.py)
against the JAX package and against the port's own default trace, on the
CPU, and render_fused's RAYVERB_PROFILE_DIR.

  - the cell8, cell64 and octant sort keys: bit-equal to JAX
    ``_ray_sort_key`` with its ``_SORT_KEY_VARIANT`` on
    tests/test_torch_trace.py's inputs
  - the horizon split, the sort keys and no resort: the port's trace
    records equal to its default trace bit for bit, and held against JAX
    ``_trace_impl`` with the same constant
  - the forward shadow rays: against JAX's forward trace, single-pair and
    multi-pair
  - RAYVERB_PROFILE_DIR: render_fused(stats=True) writes a Chrome trace

Inputs: large_square, 512 rays x 6 reflections, seed 3 (tests/test_trace.py's
horizon test), with tests/test_torch_trace.py's mic and source a hair off
the box's symmetry planes and its tolerances (volumes 1e-6, diffuse
positions 1e-4 m, image positions 1e-3 m, times 1e-6 s, image indices
equal). The box's table is smaller than the 32 blocks from which renders
resort, so the traces here are asked for resort directly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene
from rayverb_tpu.ops import intersect as jax_isect
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.ops import trace as jax_trace
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch import trace_variants
from rayverb_tpu_torch.config.schema import parse_config as port_parse_config
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace
from rayverb_tpu_torch.parallel import datagen as port_datagen

torch.set_num_threads(1)

NRAYS, NREFL, SEED = 512, 6, 3
MIC = np.float32([0.013, 2.017, 0.021])
SOURCE = np.float32([0.031, 1.989, 2.007])
ATOL = {
    "diffuse_volume": 1e-6,
    "diffuse_position": 1e-4,
    "diffuse_time": 1e-6,
    "image_volume": 1e-6,
    "image_position": 1e-3,
    "image_time": 1e-6,
}
DIFFUSE = ("diffuse_volume", "diffuse_position", "diffuse_time")
IMAGES = ("image_volume", "image_position", "image_time", "image_index")
# each port variant and the JAX trace's constant that selects it (None:
# no resort, which the JAX trace takes as resort=False)
VARIANTS = {
    "horizon_0.05": ("_HORIZON_FRAC", 0.05),
    "horizon_0.25": ("_HORIZON_FRAC", 0.25),
    "sort_cell8": ("_SORT_KEY_VARIANT", "cell8"),
    "sort_cell64": ("_SORT_KEY_VARIANT", "cell64"),
    "sort_octant": ("_SORT_KEY_VARIANT", "octant"),
    "no_resort": None,
}


@pytest.fixture(scope="module")
def box(assets_dir):
    scene = load_scene(
        str(assets_dir / "test_models" / "large_square.obj"),
        str(assets_dir / "materials" / "mat.json"),
    )
    return scene, jax_isect.soup_from_scene(scene), port_isect.soup_from_scene(scene, device="cpu")


@pytest.fixture(scope="module")
def dirs():
    return random_directions(NRAYS, seed=SEED)


@pytest.fixture
def variant(request, monkeypatch):
    """Install the port's variant ``request.param`` for the test and set the
    JAX trace's constant to match."""
    name = request.param
    jax_const = {**VARIANTS, "shadow_fwd": ("_SHADOW_REVERSED", False)}[name]
    if jax_const:
        monkeypatch.setattr(jax_trace, *jax_const)
    with trace_variants.applied(name):
        yield name


def _resort():
    """The resort a render would choose for a population that fills the
    card, with the variant installed: False under no_resort."""
    return port_render.resort_sweeps(1 << 20, 1024)


def _port(box, dirs, resort):
    return port_trace._trace_impl(
        box[2], MIC, SOURCE, dirs, nreflections=NREFL, impl="plain", resort=resort
    )


def _jax(box, dirs, resort):
    """JAX _trace_impl on the XLA sweep (its resort needs the consume
    path), as dense records (N, R, .)."""

    @jax.jit
    def run(soup, d):
        aux, images, _ = jax_trace._trace_impl(
            soup, MIC, SOURCE, d, nreflections=NREFL, impl="xla",
            consume_row=jax_render._collect_row,
            aux0=jax_render._row_buffers(NREFL, d.shape[0]),
            nvalid=np.int32(d.shape[0]), resort=resort,
        )
        return aux[:3], images

    rows, images = run(box[1], jnp.asarray(dirs))
    out = {f: np.moveaxis(np.asarray(r), 0, 1) for f, r in zip(DIFFUSE, rows)}
    out.update({f: np.asarray(x) for f, x in zip(IMAGES, images)})
    return out


def _assert_close(got, want):
    for f in DIFFUSE + IMAGES:
        g = getattr(got, f).numpy()
        assert g.shape == want[f].shape, f
        if f == "image_index":
            np.testing.assert_array_equal(g, want[f], err_msg=f)
        else:
            np.testing.assert_allclose(g, want[f], rtol=0, atol=ATOL[f], err_msg=f)


@pytest.fixture(scope="module")
def default_trace(box, dirs):
    return _port(box, dirs, True)


@pytest.mark.parametrize("variant", ["mix6", "cell8", "cell64", "octant", "morton9"])
def test_sort_key_variants_bit_equal(monkeypatch, rng, variant):
    """Each key, and an unknown name (the octant key, as in JAX), on
    test_sort_keys_bit_equal's inputs."""
    monkeypatch.setattr(jax_trace, "_SORT_KEY_VARIANT", variant)
    n = 5000
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:7] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1], [1, 1, 1], [-1, -1, -1]]
    pos = rng.uniform(-3, 13, (n, 3)).astype(np.float32)
    lo = np.float32([-2.0, -1.0, 0.5])
    inv_span = (1.0 / np.float32([12.0, 7.5, 9.0])).astype(np.float32)
    want = np.asarray(
        jax_trace._ray_sort_key(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(inv_span))
    ).astype(np.int64)
    got = trace_variants.sort_key(variant)(
        torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(lo), torch.from_numpy(inv_span)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < (1 << 32)
    assert len(np.unique(got)) > n // 4  # the key spreads the rays


@pytest.mark.parametrize("variant", sorted(VARIANTS), indirect=True)
def test_variant_trace_equals_default_and_jax(box, dirs, default_trace, variant):
    """The variant's records are the port's default trace's, bit for bit,
    and JAX _trace_impl's with the same constant, at the stated
    tolerances."""
    resort = _resort()
    assert resort is (variant != "no_resort")
    got = _port(box, dirs, resort)
    for f in DIFFUSE + IMAGES:
        assert torch.equal(getattr(got, f), getattr(default_trace, f)), f
    _assert_close(got, _jax(box, dirs, resort))
    assert int((got.image_index[:, 1:] != 0).sum()) > 50  # images exercised


@pytest.mark.parametrize("variant", ["shadow_fwd"], indirect=True)
def test_forward_shadow_matches_jax(box, dirs, default_trace, variant):
    """Forward shadow rays against JAX's forward trace. The bounce chains
    and images do not depend on the shadow verdicts, so they are the
    default trace's; only emissions may differ, on geometry within
    EPSILON of the mic."""
    got = _port(box, dirs, True)
    _assert_close(got, _jax(box, dirs, True))
    for f in IMAGES + ("diffuse_position",):
        assert torch.equal(getattr(got, f), getattr(default_trace, f)), f
    emitted = got.diffuse_time != 0
    assert emitted.sum() > NRAYS  # verdicts exercised
    assert (emitted != (default_trace.diffuse_time != 0)).float().mean() < 0.01


def _calls(monkeypatch):
    """Record each closest_hit call of the trace: (rows, t_max, t_decide,
    executed pairs or None)."""
    calls = []
    real = port_trace.closest_hit

    def spy(origins, dirs, soup, **kw):
        counted = kw.get("pair_sums") is not None
        out = real(origins, dirs, soup, with_stats=counted, **kw)
        executed = int(out[1].sum()) if counted else None
        calls.append((origins.shape[0], kw.get("t_max"), kw.get("t_decide"), executed))
        return out[0] if counted else out

    monkeypatch.setattr(port_trace, "closest_hit", spy)
    return calls


def test_horizon_stats_count_both_passes(box, dirs, monkeypatch):
    """With stats, the bounce kind adds the executed pairs of both passes
    of every split bounce; the trace launches
    trace_variants.sweep_count sweeps, R - 1 more than without the split,
    and the split reports the live rows of each pass."""
    calls = _calls(monkeypatch)
    live = []
    stats = torch.zeros(2 * len(port_trace.SWEEP_KINDS), dtype=torch.int64)
    with trace_variants.applied("horizon_0.05", live):
        port_trace._trace_impl(box[2], MIC, SOURCE, dirs, nreflections=NREFL,
                               impl="plain", resort=True, stats=stats)
    assert len(calls) == trace_variants.sweep_count("horizon_0.05", NREFL) == 1 + 3 * NREFL - 1
    assert port_trace.sweep_count(NREFL) == 1 + 2 * NREFL
    bounce = [c for c in calls[1:] if c[2] is None]
    assert len(bounce) == 2 * NREFL - 1
    assert int(stats[port_trace._BOUNCE]) == sum(c[3] for c in bounce)
    # the live rows of both passes count
    assert int(stats[len(port_trace.SWEEP_KINDS) + port_trace._BOUNCE]) == sum(
        int((c[1] > 0).sum()) for c in bounce)
    horizon = 0.05 * torch.linalg.norm(box[2].bounds[1] - box[2].bounds[0])
    # bounce 0 (from the source) is not sorted, and so not split
    pass1, pass2 = bounce[1::2], bounce[2::2]
    assert len(pass1) == len(pass2) == len(live) == NREFL - 1
    for (_, t_max, _, _), (alive, _) in zip(pass1, live):
        assert ((t_max == 0) | (t_max == horizon)).all() and (t_max == horizon).any()
        assert int((t_max > 0).sum()) == int(alive)
    # pass 2 sweeps only the unresolved rays, partitioned to the front
    for (_, t_max, _, executed), (alive, unresolved) in zip(pass2, live):
        n_live = int((t_max > 0).sum())
        assert n_live == int(unresolved) and 0 < n_live < int(alive)
        assert (t_max[:n_live] > 0).all() and executed > 0
    # the variant is gone after its block
    assert port_trace._sorted_bounce_sweep is trace_variants._default_sorted_sweep


def _multi_inputs():
    sources = np.float32([[0, 2, 2], [1, 3, 0]]) + np.float32([0.031, -0.011, 0.007])
    mics = np.float32([[0, 2, 0], [0, 4, 2]]) + np.float32([0.013, 0.017, 0.021])
    dirs = np.stack([random_directions(128, seed=i) for i in range(2)])
    return sources, mics, dirs


def test_horizon_batched_datagen_equals_default(box, monkeypatch):
    """render_irs_batched's multi-pair trace, resorted and split at the
    horizon: the IRs and contents of the default, bit for bit."""
    sources, mics, dirs = _multi_inputs()
    cfg = port_parse_config(json.dumps({
        "rays": 128, "reflections": NREFL, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [0, 0, 0], "mic_position": [0, 0, 0],
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
        "normalize": False, "trim_tail": False, "trim_predelay": False,
    }))
    monkeypatch.setattr(port_datagen, "resort_sweeps", lambda n, nb: True)

    def run():
        return port_datagen.render_irs_batched(box[0], cfg, sources, mics, dirs,
                                               device="cpu", stats=True)

    want, wc, winfo = run()
    calls = _calls(monkeypatch)
    with trace_variants.applied("horizon_0.05"):
        got, gc, info = run()
    assert torch.equal(got, want) and torch.equal(gc, wc)
    assert np.abs(want.numpy()).max() > 0
    assert winfo["sweeps"] == port_trace.sweep_count(NREFL) * winfo["passes"]
    assert len(calls) == trace_variants.sweep_count("horizon_0.05", NREFL) * info["passes"]


@pytest.mark.parametrize("variant", ["shadow_fwd"], indirect=True)
def test_forward_shadow_multi_pair_matches_jax(box, variant):
    """The multi-pair trace's forward shadow rows start at each row's
    bounce point and aim at the row's own mic, as JAX's."""
    sources, mics, dirs = _multi_inputs()
    flat = dirs.reshape(-1, 3)
    pair = np.repeat(np.arange(2, dtype=np.int32), dirs.shape[1])

    @jax.jit
    def run(soup, d, p):
        aux, images, _ = jax_trace._trace_impl(
            soup, mics, sources, d, nreflections=NREFL, impl="xla",
            consume_row=lambda bufs, row: jax_render._collect_row(bufs, row[:3]),
            aux0=jax_render._row_buffers(NREFL, d.shape[0]), resort=True, pair_id=p)
        return aux[:3], images

    (wv, wp, wt), wimg = run(box[1], jnp.asarray(flat), jnp.asarray(pair))
    rows = []
    images = port_trace._trace_impl(
        box[2], mics, sources, flat, nreflections=NREFL, impl="plain",
        consume_row=rows.append, resort=True, pair_id=torch.from_numpy(pair))
    for b, (vol, pos, tim, mic_rows, _) in enumerate(rows):
        np.testing.assert_allclose(vol.numpy(), np.asarray(wv[b]), rtol=0, atol=ATOL["diffuse_volume"])
        np.testing.assert_allclose(pos.numpy(), np.asarray(wp[b]), rtol=0, atol=ATOL["diffuse_position"])
        np.testing.assert_allclose(tim.numpy(), np.asarray(wt[b]), rtol=0, atol=ATOL["diffuse_time"])
        np.testing.assert_array_equal(mic_rows.numpy(), mics[pair])
    for f, g, w in zip(IMAGES, images, wimg):
        if f == "image_index":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL[f], err_msg=f)
    assert sum(int((r[2] != 0).sum()) for r in rows) > 128


def test_no_resort_reaches_render_fused(assets_dir, monkeypatch):
    """no_resort turns resort off in ray_schedule and so in render_fused
    (where the JAX package reads RAYVERB_NO_RESORT), on the vault (32
    blocks) with a population that resorts by default; the default comes
    back after the block."""
    from rayverb_tpu_torch.ops.render import ray_schedule
    from rayverb_tpu_torch.scene import load_scene as port_load_scene

    vault = port_load_scene(str(assets_dir / "test_models" / "vault.obj"),
                            str(assets_dir / "materials" / "vault.json"))
    n = 4096
    dirs = random_directions(n, seed=0)
    cfg = port_parse_config(json.dumps({
        "rays": n, "reflections": 2, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [0, 1, 0], "mic_position": [0, 1, 1],
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
    }))
    seen = []

    class Stop(Exception):
        pass

    def spy(*args, resort=False, **kw):
        seen.append(resort)
        raise Stop

    monkeypatch.setattr(port_render, "_trace_impl", spy)

    def resorts():
        with pytest.raises(Stop):
            port_render.render_fused(vault, cfg, dirs, device="cpu")
        return seen.pop()

    assert ray_schedule(dirs, 32)[1] and resorts()
    with trace_variants.applied("no_resort"):
        assert not ray_schedule(dirs, 32)[1] and not resorts()
    assert ray_schedule(dirs, 32)[1] and resorts()


def test_variant_names():
    """Every name of VARIANTS installs a patch (the default none) that its
    block takes back; malformed names are refused."""
    originals = {
        "_ray_sort_key": port_trace._ray_sort_key,
        "_sorted_bounce_sweep": port_trace._sorted_bounce_sweep,
        "_shadow_rows": port_trace._shadow_rows,
        "resort_sweeps": port_render.resort_sweeps,
    }

    def current():
        return {k: getattr(port_render if k == "resort_sweeps" else port_trace, k)
                for k in originals}

    for name in trace_variants.VARIANTS:
        with trace_variants.applied(name):
            changed = {k for k, v in current().items() if v is not originals[k]}
        assert len(changed) == (name != "default"), name
        assert current() == originals
    for bad in ("horizon_0", "horizon_x", "sort", "shadow", "bogus"):
        with pytest.raises(ValueError):
            with trace_variants.applied(bad):
                pass
    assert current() == originals


def test_profile_dir_writes_a_trace(box, tmp_path, monkeypatch):
    """render_fused(stats=True) with RAYVERB_PROFILE_DIR set writes one
    Chrome trace of the render into the directory; without stats, none."""
    cfg = port_parse_config(json.dumps({
        "rays": 64, "reflections": 3, "sample_rate": 8000, "bit_depth": 16,
        "source_position": SOURCE.tolist(), "mic_position": MIC.tolist(),
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
    }))
    out = tmp_path / "profile"
    monkeypatch.setenv("RAYVERB_PROFILE_DIR", str(out))
    d = random_directions(64, seed=1)
    plain, _ = port_render.render_fused(box[0], cfg, d, device="cpu")
    assert not out.exists()
    ir, info = port_render.render_fused(box[0], cfg, d, device="cpu", stats=True)
    np.testing.assert_array_equal(ir, plain)
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert "timings" in info


def test_probe_turns_runs_one_variant_per_process(monkeypatch, capsys):
    """probe_turns runs each variant by name in a process whose only
    RAYVERB_* variable is the counters'; it needs a GPU."""
    from rayverb_tpu_torch import probe_turns

    assert probe_turns.VARIANTS[0] == "default" and "horizon_0.12" in probe_turns.VARIANTS
    seen = {}

    def fake_run(cmd, env, **kw):
        seen.update(cmd=cmd, env=env)
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps({"wall_s": 1.5}) + "\n",
                                           stderr="")

    monkeypatch.setattr(probe_turns.subprocess, "run", fake_run)
    monkeypatch.setenv("RAYVERB_BIN", "scatter")
    monkeypatch.setenv("RAYVERB_HORIZON", "0.5")
    rec = probe_turns._run("horizon_0.12", 1, 64, 2)
    assert rec == {"variant": "horizon_0.12", "turn": 1, "rc": 0, "wall_s": 1.5}
    assert not any(k.startswith("RAYVERB_") for k in seen["env"])
    assert seen["cmd"][-7:] == ["--rays", "64", "--runs", "2", "--profile",
                                "--variant", "horizon_0.12"]
    if not torch.cuda.is_available():
        assert probe_turns.main(["--turns", "1"]) == 1
        assert "needs a CUDA device" in capsys.readouterr().err


def test_probe_records_the_horizon_split_rows(assets_dir):
    """probe under a horizon variant: the IR's walls and counters as under
    the default, plus the live rows of both passes of each split of the
    cold render (the vault: 32 blocks, so 4,096 rays resort)."""
    from rayverb_tpu_torch import probe
    from rayverb_tpu_torch.scene import load_scene as port_load_scene

    vault = port_load_scene(str(assets_dir / "test_models" / "vault.obj"),
                            str(assets_dir / "materials" / "vault.json"))
    cfg = port_parse_config(json.dumps({
        "rays": 4096, "reflections": 3, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [0, 1, 0], "mic_position": [0, 1, 1],
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
    }))
    base = probe.probe(vault, cfg, device="cpu")
    rec = probe.probe(vault, cfg, device="cpu", variant="horizon_0.12")
    assert "horizon_split_rows" not in base and rec["variant"] == "horizon_0.12"
    rows = rec["horizon_split_rows"]
    assert len(rows) == cfg.reflections - 1
    assert all(0 <= u <= a <= cfg.rays for a, u in rows) and any(u < a for a, u in rows)
    assert rec["executed_G"]["bounce"] != base["executed_G"]["bounce"]
    assert rec["executed_G"]["shadow"] == base["executed_G"]["shadow"]
