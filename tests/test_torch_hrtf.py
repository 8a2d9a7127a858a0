"""The PyTorch port's HRTF pieces vs the JAX package's: the table (numpy),
the head frame and lookup, per-ear attenuation, and HRTF renders.

Tolerances, stated per test:
  - tables: bit for bit (the same numpy code on the same inputs)
  - lookup indices: equal, except where the JAX angle lies within a few
    float32 ulps of a whole degree, where XLA's fused arithmetic (an FMA,
    a hypot rounded differently) and PyTorch's may round to either side;
    those rows are counted and must stay rare
  - ITD-shifted times: rtol 2.5e-7 (2 ulps) and atol 1e-8 s (XLA
    contracts the norms' sums and t + diff * s/m into FMAs on the CPU;
    1e-8 s is 1/6000 of a bin at 16 kHz); gains: equal where the indices
    are
  - renders: -60 dB of peak (tests/test_torch_render.py's criterion)

The HRTF renders bin the JAX package's own trace records (the port's
_trace_impl is replaced by the JAX trace of the same rays): the two traces
agree record by record only to an ulp or two (tests/test_torch_trace.py),
and an ear's ITD shift then moves an arrival across a bin edge often
enough (3 of 8 seeds of the large_square config) that a displaced impulse
amid others exceeds the single-bin forgiveness of the -60 dB criterion.
Fed the same records, the port's HRTF attenuation, binning, image dedup,
predelay and filters agree with the JAX render to ~1e-6 of peak.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayverb_tpu import load_scene
from rayverb_tpu.config.schema import parse_config as jax_parse_config
from rayverb_tpu.hrtf import table as jax_table
from rayverb_tpu.ops import attenuate as jax_att
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch.config.schema import parse_config as port_parse_config
from rayverb_tpu_torch.hrtf import table as port_table
from rayverb_tpu_torch.io.audio import write_audio
from rayverb_tpu_torch.ops import attenuate as port_att
from rayverb_tpu_torch.ops import render as port_render

from test_torch_render import PLACES, _assert_within_60db, _doc, feed_jax_trace

torch.set_num_threads(1)

HRTF = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}
F32 = np.float32


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def test_default_table_equals_shipped_npz():
    """The port rebuilds the table the JAX package ships as
    hrtf_table.npz, bit for bit."""
    got = port_table.default_table()
    want = jax_table.default_table()
    assert got.dtype == np.float32 and got.shape == port_table.TABLE_SHAPE
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()
    assert port_table.default_table() is got  # built once


def test_test_table_matches_jax_and_expectations():
    """tests/test_hrtf_table.py's expectations of the identifiable table,
    and bit equality with the JAX package's."""
    t = port_table.test_table()
    assert t.tobytes() == jax_table.test_table().tobytes()
    for a, e in [(0, 0), (15, 15), (180, 90), (345, 165), (90, 45)]:
        np.testing.assert_allclose(t[0, a, e, 0], a, atol=1e-4)
        np.testing.assert_allclose(t[0, a, e, 1], e, atol=1e-4)
        assert np.all(t[0, a, e, 2:] == 0)
    np.testing.assert_allclose(t[0], t[1])
    np.testing.assert_allclose(t[0, 7, 0, 0], 7.0, atol=1e-3)
    np.testing.assert_allclose(t[0, 0, 7, 1], 7.0, atol=1e-3)


def test_interpolation_and_band_energies_match_jax(rng):
    entries = [((int(a), int(e)), rng.random(8), rng.random(8))
               for a, e in zip(rng.integers(0, 361, 40), rng.integers(0, 181, 40))]
    got = port_table.interpolate_measurements(entries)
    assert got.tobytes() == jax_table.interpolate_measurements(entries).tobytes()
    x = rng.standard_normal((2, 512))
    np.testing.assert_array_equal(
        port_table.band_energies(x, 44100.0), jax_table.band_energies(x, 44100.0)
    )


def test_decode_ircam_filename():
    assert port_table.decode_ircam_filename("IRC_1002_C_R0195_T030_P045.wav") == (195, 30, 45)
    with pytest.raises(ValueError, match="IRCAM"):
        port_table.decode_ircam_filename("not_an_ircam_name.wav")


def test_analyze_hrir_directory_matches_jax(tmp_path, rng):
    """Stereo HRIRs with IRCAM names, written here, through both packages'
    analysis: equal tables."""
    for az, el in [(0, 0), (30, 15), (90, 345), (180, 0), (270, 45), (330, 330)]:
        ir = rng.standard_normal((2, 256)) * 0.3
        write_audio(str(tmp_path / f"IRC_1002_C_R0195_T{az:03d}_P{el:03d}.wav"),
                    ir, 44100.0, 16)
    (tmp_path / "subdir").mkdir()  # directories are skipped
    got = port_table.analyze_hrir_directory(str(tmp_path))
    want = jax_table.analyze_hrir_directory(str(tmp_path))
    assert got.shape == port_table.TABLE_SHAPE
    assert got.tobytes() == want.tobytes()
    assert np.abs(got).max() > 0


def test_analyze_hrir_directory_rejects_mono(tmp_path):
    write_audio(str(tmp_path / "IRC_1002_C_R0195_T000_P000.wav"),
                np.zeros((1, 64)), 44100.0, 16)
    with pytest.raises(ValueError, match="stereo"):
        port_table.analyze_hrir_directory(str(tmp_path))


# ---------------------------------------------------------------------------
# head frame, lookup, per-ear attenuation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "facing, up",
    [([0, 0, 1], [0, 1, 0]), ([0, 0, -1], [0, 1, 0]), ([5, 75, -5], [0, 1, 0]),
     ([1, 0, 0], [0, 0, 1])],
)
def test_head_basis_matches_jax(facing, up):
    want = np.asarray(jax.jit(jax_att.head_basis)(jnp.float32(facing), jnp.float32(up)))
    got = port_att.head_basis(torch.tensor(facing, dtype=torch.float32),
                              torch.tensor(up, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def _near_whole_degree(deg, ulps=4):
    """Angles (float32 degrees) within ``ulps`` ulps of an integer."""
    deg = np.asarray(deg, np.float32)
    return np.abs(deg - np.round(deg)) <= ulps * np.spacing(np.abs(deg) + 1)


def test_hrtf_lookup_indices_match_jax(rng):
    d = rng.standard_normal((200_000, 3)).astype(F32)
    # boundary directions: axes, both poles (e == 180 clamps to 179), the
    # back (a wraps), whole-degree azimuths and elevations
    deg = np.radians(np.arange(-180, 181, 15, dtype=np.float64))
    ring = np.stack([np.sin(deg), np.zeros_like(deg), np.cos(deg)], 1)
    tilt = np.stack([np.zeros_like(deg), np.sin(deg / 2), np.cos(deg / 2)], 1)
    special = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                        [0, 0, 1], [0, 0, -1], [0, 0, 0]], np.float64)
    d = np.concatenate([d, ring, tilt, special]).astype(F32)
    wa, we = (np.asarray(x) for x in jax.jit(jax_att.hrtf_lookup_indices)(d))
    ga, ge = (x.numpy() for x in port_att.hrtf_lookup_indices(torch.from_numpy(d)))
    assert ga.min() >= 0 and ga.max() < 360 and ge.min() >= 0 and ge.max() < 180
    assert ge[-7] == 0 and ge[-6] == 179  # +y pole, -y pole clamped
    az = np.asarray(jnp.degrees(jnp.arctan2(d[:, 0], d[:, 2]))) + F32(180)
    el = np.asarray(jnp.degrees(jnp.arctan2(d[:, 1], jnp.hypot(d[:, 0], d[:, 2]))))
    bad_a = ga != wa
    bad_e = ge != we
    assert not np.any(bad_a & ~_near_whole_degree(az)), np.nonzero(bad_a)[0][:10]
    assert not np.any(bad_e & ~_near_whole_degree(el)), np.nonzero(bad_e)[0][:10]
    # boundary rows that flip are counted; they must stay rare
    assert bad_a.sum() + bad_e.sum() <= 1e-4 * d.shape[0]


@pytest.mark.parametrize("channel", [0, 1])
def test_hrtf_attenuate_channel_matches_jax(rng, channel):
    m = 50_000
    vol = rng.random((m, 8)).astype(F32)
    vol[rng.random(m) < 0.1] = 0.0
    pos = rng.uniform(-20, 20, (m, 3)).astype(F32)
    tim = (rng.random(m) * 0.5).astype(F32)
    mic = F32([0.013, 2.017, 0.021])
    table = port_table.default_table()
    facing, up = [5.0, 75.0, -5.0], [0.0, 1.0, 0.0]
    wv, wt = (np.asarray(x) for x in jax_att.hrtf_attenuate_channel(
        mic, vol, pos, tim, table, jnp.float32(facing), jnp.float32(up), channel))
    gv, gt = (x.numpy() for x in port_att.hrtf_attenuate_channel(
        mic, torch.from_numpy(vol), torch.from_numpy(pos), torch.from_numpy(tim),
        table, facing, up, channel))
    same_cell = np.all(gv == wv, axis=-1)
    assert same_cell.mean() > 0.999
    np.testing.assert_allclose(gt, wt, rtol=2.5e-7, atol=1e-8)
    assert np.all(gt[~vol.any(-1)] == 0) and np.all(gv[~vol.any(-1)] == 0)


def test_attenuate_dispatch_matches_jax(rng):
    """attenuate() on any object with mic, volume, position and time, for
    speakers and HRTF."""
    m = 2000
    res = SimpleNamespace(
        mic=F32([0.1, 1.5, 0.2]),
        volume=rng.random((m, 8)).astype(F32),
        position=rng.uniform(-5, 5, (m, 3)).astype(F32),
        time=(rng.random(m) * 0.1).astype(F32),
    )
    for att in (HRTF, {"speakers": [{"direction": [1, 0, 0], "shape": 0.5},
                                     {"direction": [0, 0, 1], "shape": 1.0}]}):
        doc = json.dumps(dict(_doc("large_square", "all", False), attenuation_model=att))
        wv, wt = jax_att.attenuate(res, jax_parse_config(doc).attenuation_model)
        gv, gt = port_att.attenuate(
            res, port_parse_config(doc).attenuation_model, device="cpu"
        )
        assert gv.shape == (2, m, 8) and gt.shape == (2, m)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=2.5e-7, atol=1e-8)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes(assets_dir):
    return {
        name: load_scene(
            str(assets_dir / "test_models" / f"{name}.obj"),
            str(assets_dir / "materials" / "mat.json"),
        )
        for name in PLACES
    }


@pytest.fixture
def jax_records(monkeypatch, scenes):
    """Feed the port's render the JAX trace (module docstring)."""
    return lambda scene_name: feed_jax_trace(monkeypatch, scenes[scene_name])


def _hrtf_doc(scene_name, mode, trims, **extra):
    doc = _doc(scene_name, mode, trims)
    doc["attenuation_model"] = HRTF
    doc.update(extra)
    return json.dumps(doc)


@pytest.mark.parametrize(
    "scene_name, mode, trims",
    [
        ("large_square", "all", True),
        ("large_square", "all", False),
        ("bedroom", "diffuse_only", True),
        ("bedroom", "diffuse_only", False),
    ],
)
def test_hrtf_render_matches_jax(scenes, jax_records, scene_name, mode, trims):
    text = _hrtf_doc(scene_name, mode, trims)
    dirs = random_directions(128, seed=3)
    jax_records(scene_name)
    want, winfo = jax_render.render_fused(scenes[scene_name], jax_parse_config(text), dirs)
    got, ginfo = port_render.render_fused(
        scenes[scene_name], port_parse_config(text), dirs, device="cpu"
    )
    assert got.shape[0] == 2 and np.all(np.isfinite(got))
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))
    assert ginfo["predelay"] == pytest.approx(winfo["predelay"], rel=1e-6, abs=1e-9)


def test_hrtf_trim_predelay_regression(scenes, jax_records):
    """JAX regression test_hrtf_trim_predelay_match (tests/test_render_fused.py):
    predelay comes from the ITD-shifted times and shifted-out bins clamp to
    bin 0, so the near ear's direct-path energy survives normalize=True."""
    text = _hrtf_doc("large_square", "all", False, trim_predelay=True, normalize=True)
    dirs = random_directions(96, seed=11)
    jax_records("large_square")
    want, winfo = jax_render.render_fused(scenes["large_square"], jax_parse_config(text), dirs)
    got, ginfo = port_render.render_fused(
        scenes["large_square"], port_parse_config(text), dirs, device="cpu"
    )
    assert ginfo["predelay"] == pytest.approx(winfo["predelay"], rel=1e-6)
    # the nearer ear's direct arrival (ears at mic -+ 0.1 m along x, the
    # head facing +z), not the unshifted direct path to the mic
    mic, src = (np.asarray(p, np.float64) for p in PLACES["large_square"])
    ears = mic + np.array([[-0.1, 0, 0], [0.1, 0, 0]])
    nearest = np.linalg.norm(src - ears, axis=1).min() / 340.0
    assert ginfo["predelay"] == pytest.approx(nearest, rel=1e-5)
    assert nearest != pytest.approx(np.linalg.norm(src - mic) / 340.0, rel=1e-5)
    assert np.abs(got[:, :8]).max() > 0.01
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))


def test_hrtf_render_takes_a_table(scenes, jax_records):
    """render_fused(hrtf_table=...) as the JAX render takes it."""
    text = _hrtf_doc("large_square", "all", False)
    dirs = random_directions(64, seed=5)
    table = port_table.test_table() + np.float32(1.0)
    jax_records("large_square")
    want, _ = jax_render.render_fused(scenes["large_square"], jax_parse_config(text),
                                      dirs, hrtf_table=table)
    got, _ = port_render.render_fused(scenes["large_square"], port_parse_config(text),
                                      dirs, hrtf_table=table, device="cpu")
    _assert_within_60db(got.astype(np.float64), np.asarray(want, np.float64))


def test_hrtf_render_own_trace_is_stereo_and_close(scenes):
    """The port end to end (its own trace) on an HRTF config: two finite,
    non-silent ears whose energy agrees with the JAX render's within 1 %
    (single impulses may move one bin, module docstring)."""
    text = _hrtf_doc("large_square", "all", True)
    dirs = random_directions(128, seed=3)
    want, _ = jax_render.render_fused(scenes["large_square"], jax_parse_config(text), dirs)
    got, _ = port_render.render_fused(scenes["large_square"], port_parse_config(text),
                                      dirs, device="cpu")
    want = np.asarray(want, np.float64)
    assert got.shape[0] == 2 and abs(got.shape[1] - want.shape[1]) <= 1
    assert np.all(np.isfinite(got))
    n = min(got.shape[1], want.shape[1])
    e_got = np.sum(got[:, :n].astype(np.float64) ** 2, axis=1)
    e_want = np.sum(want[:, :n] ** 2, axis=1)
    np.testing.assert_allclose(e_got, e_want, rtol=1e-2)
