"""The PyTorch port's fused render vs the JAX package's render_fused and vs
the float64 oracle (tests/oracle.py), within -60 dB of peak (the criterion
of tests/test_oracle.py: max error < 1e-3 of peak, forgiving single-bin
displacement of impulses that sit within one float32 ulp of a bin edge).

The bedroom is compared in diffuse_only mode: its overlapping coplanar wall
triangles make image-source chains depend on how each sweep rounds t (the
JAX package's own XLA and Pallas renders of it differ by far more than
-60 dB), see tests/test_torch_trace.py.
"""

import json

import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene
from rayverb_tpu.config.schema import parse_config as jax_parse_config
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch.config.schema import parse_config as port_parse_config
from rayverb_tpu_torch.ops import render as port_render

import oracle

torch.set_num_threads(1)

DB60 = 1e-3  # -60 dB relative to peak

SPEAKERS = {
    "speakers": [
        {"direction": [0, 0, 1], "shape": 0.5},
        {"direction": [1, 0, 0], "shape": 0.0},
    ]
}
# mic and source a hair off the scenes' symmetry planes, where the XLA
# sweep and the kernel's Woop rows may break exact ties differently
PLACES = {
    "large_square": ([0.013, 2.017, 0.021], [0.031, 1.989, 2.007]),
    "bedroom": ([0.013, 0.017, 2.021], [0.031, -0.011, 0.007]),
}


def _doc(scene_name, mode, trims, rays=128, reflections=6):
    mic, src = PLACES[scene_name]
    return {
        "rays": rays,
        "reflections": reflections,
        "sample_rate": 16000,
        "bit_depth": 16,
        "source_position": src,
        "mic_position": mic,
        "attenuation_model": SPEAKERS,
        "filter": "linkwitz_riley",
        "trim_predelay": trims,
        "trim_tail": trims,
        "output_mode": mode,
        "seed": 3,
    }


@pytest.fixture(scope="module")
def scenes(assets_dir):
    return {
        name: load_scene(
            str(assets_dir / "test_models" / f"{name}.obj"),
            str(assets_dir / "materials" / "mat.json"),
        )
        for name in PLACES
    }


def feed_jax_trace(monkeypatch, scene, calls=None):
    """Replace the port render's trace by the JAX package's trace_chunk of
    the same rays, fed through the port's consume protocol, so that both
    renders bin the same trace records. With ``calls``, each call's
    directions are appended to it as they came (a tensor on the soup's
    device)."""
    from rayverb_tpu.ops.intersect import soup_from_scene
    from rayverb_tpu.ops.trace import trace_chunk

    soup = soup_from_scene(scene)

    def trace(_soup, mic, source, directions, *, nreflections, impl,
              consume_row, resort, stats):
        if calls is not None:
            calls.append(directions)
        directions = np.asarray(directions)
        out = trace_chunk(soup, np.float32(mic), np.float32(source), directions,
                          nreflections=nreflections)
        t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
        for b in range(nreflections):
            consume_row((t(out.diffuse_volume[:, b]), t(out.diffuse_position[:, b]),
                         t(out.diffuse_time[:, b])))
        return (t(out.image_volume), t(out.image_position), t(out.image_time),
                t(out.image_index).long())

    monkeypatch.setattr(port_render, "_trace_impl", trace)


def _assert_within_60db(got, want):
    n = min(got.shape[-1], want.shape[-1])
    assert n > 20
    peak = np.abs(want).max()
    assert peak > 0
    g = got[:, :n]
    errs = [np.abs(g - want[:, :n])]
    for s in (1, -1):
        errs.append(np.abs(g - np.roll(want, s, axis=-1)[:, :n]))
    err = np.minimum(np.minimum(errs[0], errs[1]), errs[2]).max() / peak
    assert err < DB60, f"max error {err:.2e} exceeds -60 dB"
    assert np.abs(got[:, n:]).max(initial=0.0) / peak < DB60
    assert np.abs(want[:, n:]).max(initial=0.0) / peak < DB60


@pytest.mark.parametrize(
    "scene_name, mode, trims",
    [
        ("large_square", "all", True),
        ("large_square", "all", False),
        ("large_square", "image_only", False),
        ("large_square", "diffuse_only", True),
        ("bedroom", "diffuse_only", True),
        ("bedroom", "diffuse_only", False),
    ],
)
def test_render_matches_jax(scenes, scene_name, mode, trims):
    doc = json.dumps(_doc(scene_name, mode, trims))
    scene = scenes[scene_name]
    dirs = random_directions(128, seed=3)
    want, winfo = jax_render.render_fused(scene, jax_parse_config(doc), dirs)
    got, ginfo = port_render.render_fused(
        scene, port_parse_config(doc), dirs, device="cpu"
    )
    assert got.dtype == np.float32 and got.shape[0] == 2
    assert np.all(np.isfinite(got))
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))
    assert ginfo["predelay"] == pytest.approx(winfo["predelay"], rel=1e-6, abs=1e-9)
    assert ginfo["histogram_length"] == winfo["histogram_length"]


def test_render_matches_oracle(scenes):
    """Independent float64 per-ray oracle, as tests/test_oracle.py holds the
    JAX render to it."""
    doc = _doc("large_square", "all", False, rays=24, reflections=6)
    doc["seed"] = 7
    cfg = port_parse_config(json.dumps(doc))
    scene = scenes["large_square"]
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    want = oracle.render(
        scene,
        cfg.mic_position,
        cfg.source_position,
        dirs,
        cfg.reflections,
        cfg.sample_rate,
        attenuation="speakers",
        speakers=[
            {"direction": np.asarray(s.direction), "shape": float(s.shape)}
            for s in cfg.attenuation_model.speakers
        ],
        lo_cutoff=cfg.hipass,
    )
    got, _ = port_render.render_fused(scene, cfg, dirs, device="cpu")
    _assert_within_60db(got.astype(np.float64), want)


def test_histogram_length_matches(scenes):
    for name, scene in scenes.items():
        for refl, sr in ((6, 16000.0), (128, 44100.0)):
            assert port_render.histogram_length(scene, refl, sr) == (
                jax_render.histogram_length(scene, refl, sr)
            )


@pytest.mark.parametrize("filt", ["linkwitz_riley", "onepass", "twopass"])
def test_finalize_filter_params_byte_equal(filt):
    from rayverb_tpu.config.schema import FilterType as JaxFilter
    from rayverb_tpu_torch.config.schema import FilterType as PortFilter

    want, wflips, wnfft, wmethod = jax_render.finalize_filter_params(
        JaxFilter(filt), 16000.0, 60.0, 4096, method="fft"
    )
    got, gflips, gnfft, gmethod = port_render.finalize_filter_params(
        PortFilter(filt), 16000.0, 60.0, 4096, method="fft"
    )
    assert (gflips, gnfft, gmethod) == (wflips, wnfft, wmethod) == (gflips, gnfft, "fft")
    assert got.tobytes() == np.asarray(want).tobytes()


def test_sorted_binning_matches_jax(rng):
    """Scatter-free sorted binning, bit for bit on the same rows."""
    import jax.numpy as jnp

    from rayverb_tpu.config.schema import parse_config as jp

    m, length = 3000, 512
    vol = rng.random((m, 8)).astype(np.float32)
    vol[rng.random(m) < 0.2] = 0.0
    pos = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    tim = (rng.random(m) * 0.04).astype(np.float32)
    tim[:5] = [0.0, 1e-9, 0.03199, 0.5, 0.032]
    mic = np.float32([0.1, 0.2, 0.3])
    doc = json.dumps(_doc("large_square", "all", False))
    jspec = jax_render.make_atten_spec(jp(doc).attenuation_model)
    pspec = port_render.make_atten_spec(
        port_parse_config(doc).attenuation_model, device="cpu"
    )
    import jax

    binned = jax.jit(
        lambda *a: jax_render._bin_rows_sorted(*a, jspec, length, np.float32(16000.0))
    )
    wh, wmin, wmax = binned(
        jnp.asarray(mic), jnp.asarray(vol), jnp.asarray(pos), jnp.asarray(tim)
    )
    gh, gmin, gmax = port_render._bin_rows_sorted(
        torch.from_numpy(mic), torch.from_numpy(vol), torch.from_numpy(pos),
        torch.from_numpy(tim), pspec, length, 16000.0,
    )
    assert float(gmin) == float(wmin) and float(gmax) == float(wmax)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=2e-6, atol=1e-7)


def test_hrtf_config_renders(scenes):
    """HRTF configs render (the port once refused them; the name is kept):
    two finite, non-silent ears. Parity with the JAX package is held in
    tests/test_torch_hrtf.py."""
    doc = _doc("large_square", "all", False)
    doc["attenuation_model"] = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}
    ir, info = port_render.render_fused(
        scenes["large_square"], port_parse_config(json.dumps(doc)),
        random_directions(8, seed=0), device="cpu",
    )
    assert ir.dtype == np.float32 and ir.shape[0] == 2 and ir.shape[1] > 20
    assert np.all(np.isfinite(ir)) and np.abs(ir).max() > 0
    assert info["chunks"] == 1


@pytest.fixture(scope="module")
def vault(assets_dir):
    return load_scene(
        str(assets_dir / "test_models" / "vault.obj"),
        str(assets_dir / "materials" / "vault.json"),
    )


def test_vault_render_matches_jax(vault, assets_dir):
    """The headline demo's scene, materials and speakers (vault.json) at a
    few hundred rays and a few reflections, output_mode all, trims on."""
    doc = json.loads((assets_dir / "configs" / "vault.json").read_text())
    doc.update(rays=300, reflections=6, sample_rate=16000, bit_depth=16, seed=3)
    assert doc["output_mode"] == "all" and "speakers" in doc["attenuation_model"]
    text = json.dumps(doc)
    dirs = random_directions(doc["rays"], seed=3)
    want, winfo = jax_render.render_fused(vault, jax_parse_config(text), dirs)
    got, ginfo = port_render.render_fused(
        vault, port_parse_config(text), dirs, device="cpu"
    )
    assert np.all(np.isfinite(got))
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))
    assert ginfo["predelay"] == pytest.approx(winfo["predelay"], rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("filt", ["twopass", "onepass"])
@pytest.mark.parametrize("trims", [True, False])
def test_biquad_render_matches_jax(scenes, filt, trims):
    """IRs through the biquad filter banks (stonehenge.json and
    config_hrtf.json use twopass), not only their filter parameters."""
    doc = _doc("large_square", "all", trims)
    doc["filter"] = filt
    text = json.dumps(doc)
    dirs = random_directions(128, seed=3)
    scene = scenes["large_square"]
    want, _ = jax_render.render_fused(scene, jax_parse_config(text), dirs)
    got, _ = port_render.render_fused(scene, port_parse_config(text), dirs, device="cpu")
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))
