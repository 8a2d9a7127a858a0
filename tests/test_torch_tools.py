"""The port's tools on the CPU: kernel_parity's float64 oracle and gates,
convolve against scripts/convolve.py, health and probe through their
functions, every new entry point's default device, and biquad_ab's usage.

kernel_parity's gates are held at the script's own 2,048 rows on the
vault: its p99 gate reads the 99th percentile of ~1,370 rows that both hit
there (8.8e-6 for the plain version against the 2e-5 gate); at 256 rows
(152 such rows) the percentile is the second-largest error and reads
3.0e-5 at seed 3, a statistic of the sample size, not of the sweep.
"""

import importlib.util
import json

import numpy as np
import pytest
import torch

from rayverb_tpu_torch import convolve, gen, health, kernel_parity, probe
from rayverb_tpu_torch.config.schema import parse_config
from rayverb_tpu_torch.constants import EPSILON
from rayverb_tpu_torch.io.audio import read_audio, write_audio
from rayverb_tpu_torch.ops import intersect
from rayverb_tpu_torch.scene import load_scene

from conftest import REPO

torch.set_num_threads(1)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vault():
    return kernel_parity.vault_scene()


# ---------------------------------------------------------------------------
# kernel_parity
# ---------------------------------------------------------------------------

def test_oracle_equals_scripts_numpy_reference(vault):
    rows = kernel_parity.sweep_rows(vault.bounds, 64, seed=3)
    v0, e0, e1 = (np.asarray(x, np.float64) for x in (vault.v0, vault.e0, vault.e1))
    want_t, want_i = _script("kernel_parity").numpy_reference(
        rows["o"], rows["d"], v0, e0, e1, rows["t_max"], EPSILON)
    got_t, got_i = kernel_parity.oracle(*(torch.from_numpy(x) for x in (
        rows["o"], rows["d"], v0, e0, e1, rows["t_max"])), chunk_bytes=1 << 20)
    assert (want_i >= 0).sum() > 32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    hit = want_i >= 0
    np.testing.assert_allclose(got_t.numpy()[hit], want_t[hit], rtol=1e-12, atol=0)
    assert np.all(np.isinf(got_t.numpy()[~hit]))


def test_sweep_rows_match_scripts_kinds(vault):
    rows = kernel_parity.sweep_rows(vault.bounds, 300, seed=3)
    assert np.isinf(rows["t_max"][:100]).all() and np.isfinite(rows["t_max"][100:]).all()
    assert (rows["decide"][:200] == 0).all() and (rows["decide"][200:] > 0).all()
    assert rows["exact"].sum() == 200
    np.testing.assert_allclose(np.linalg.norm(rows["d"], axis=1), 1.0, rtol=1e-6)


def test_gates_pass_for_the_plain_sweep(vault):
    rec = kernel_parity.check_scene("vault", vault, 2048, 3, "cpu")
    assert rec["ok"], rec
    vs = rec["vs_float64"]
    assert rec["impl"] == "plain" and rec["kernel_launches"] == 0
    assert vs["hit_agree"] == 1.0 and vs["decide_verdict_agree"] == 1.0
    # the vault's overlapping coplanar faces: ties the oracle breaks otherwise
    assert 0.9 <= vs["index_agree"] < 1.0 and vs["index_mismatches"] > 0
    assert vs["index_mismatch_max_t_rel"] < 1e-9


def test_gates_fail_on_a_swapped_index(vault, monkeypatch):
    """One exact row's triangle swapped for one that the ray misses: the
    tie gate reads +inf and the record fails."""
    real = kernel_parity.closest_hit
    soup = intersect.soup_from_scene(vault, device="cpu")

    def swapped(o, d, s, **kw):
        hit = real(o, d, s, **kw)
        r = int(torch.nonzero(hit.hit[:100])[0])
        t = kernel_parity.pair_t(o[r].expand(len(soup.v0), 3), d[r].expand(len(soup.v0), 3),
                                 soup.v0, soup.e0, soup.e1, torch.arange(len(soup.v0)))
        miss = int(torch.nonzero(torch.isinf(t))[0])
        index = hit.index.clone()
        index[r] = miss
        return hit._replace(index=index)

    monkeypatch.setattr(kernel_parity, "closest_hit", swapped)
    rec = kernel_parity.check_scene("vault", vault, 2048, 3, "cpu")
    assert not rec["ok"]
    assert rec["vs_float64"]["index_mismatch_max_t_rel"] == float("inf")


# ---------------------------------------------------------------------------
# convolve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dry", ["--click", "--burst", "file"])
def test_convolve_matches_script(dry, tmp_path):
    ir = str(REPO / "impulses" / "small_square" / "small_square_near_c_bright.wav")
    if dry == "file":
        rng = np.random.default_rng(1)
        path = str(tmp_path / "dry.wav")
        write_audio(path, (0.5 * rng.standard_normal((1, 4000))).astype(np.float32),
                    44100.0, 16)
        args = [ir, path]
        extra = ["--dry-gain", "0.3", "--wet", "0.8", "--bit-depth", "24"]
    else:
        args = [ir, dry]
        extra = []
    port, script = str(tmp_path / "port.wav"), str(tmp_path / "script.wav")
    assert _script("convolve").main(args + [script] + extra) == 0
    assert convolve.main(args + [port, "--device", "cpu"] + extra) == 0
    got, sr, bits = read_audio(port)
    want, want_sr, want_bits = read_audio(script)
    assert (sr, bits) == (want_sr, want_bits) and got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 ** (1 - bits)  # 1 LSB
    assert np.abs(got).max() > 0.1


# ---------------------------------------------------------------------------
# health and probe
# ---------------------------------------------------------------------------

def _small(scene_doc_overrides=None):
    doc = {
        "rays": 96, "reflections": 6, "sample_rate": 16000, "bit_depth": 16,
        "source_position": [0.031, 1.989, 2.007], "mic_position": [0.013, 2.017, 0.021],
        "attenuation_model": {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
        "filter": "linkwitz_riley", "normalize": True, "trim_tail": False,
    }
    doc.update(scene_doc_overrides or {})
    return parse_config(json.dumps(doc))


@pytest.fixture(scope="module")
def box():
    return load_scene(str(REPO / "assets" / "test_models" / "large_square.obj"),
                      str(REPO / "assets" / "materials" / "mat.json"))


@pytest.mark.parametrize("threshold, rc", [(1e6, 0), (0.0, 1)])
def test_health_exit_code_at_threshold(box, threshold, rc, capsys):
    assert health.check(box, _small(), threshold=threshold, runs=2, device="cpu") == rc
    out = capsys.readouterr().out
    assert out.startswith("vault warm ") and ("HEALTHY" if rc == 0 else "DEGRADED") in out


def test_probe_prints_one_json_line(box, monkeypatch, capsys):
    monkeypatch.setenv("RAYVERB_BIN", "sorted")
    rec = probe.probe(box, _small(), runs=2, device="cpu")
    print(json.dumps(rec))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) >= {"rays", "env", "compile_wall_s", "wall_s", "trace_bin_s",
                        "finalize_s", "executed_G", "executed_total_G"}
    assert out["env"] == {"RAYVERB_BIN": "sorted"} and out["device"] == "cpu"
    assert set(out["executed_G"]) >= {"bounce", "shadow"} and out["executed_total_G"] > 0


def test_probe_north_star_is_the_benchmarks():
    """probe.NORTH_STAR is bench.py's north star (read from its source, not
    imported: bench.py imports JAX at run time)."""
    src = (REPO / "bench.py").read_text()
    for key in ("source_position", "mic_position"):
        assert str(probe.NORTH_STAR[key]).replace(" ", "") in src.replace(" ", "")
    assert probe.NORTH_STAR["rays"] == 1_000_000 and probe.NORTH_STAR["reflections"] == 16
    assert probe.HALL_TRIANGLES == 100_000


def test_write_hall(tmp_path):
    assert probe.write_hall(str(tmp_path / "h.obj"), 2_000) > 2_000
    assert (tmp_path / "h.obj").stat().st_size > 0


# ---------------------------------------------------------------------------
# default device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module, argv", [
    (gen, ["--outdir", "{tmp}/corpus", "--dry-run"]),
    (kernel_parity, ["--rays", "64"]),
    (health, []),
    (probe, ["--rays", "64"]),
    (convolve, [str(REPO / "impulses" / "vault" / "vault_vault_vault.wav"), "--click",
                "{tmp}/out.wav"]),
])
def test_entry_point_default_device_is_cuda(module, argv, tmp_path, capsys):
    """Without --device each entry point asks for the GPU; on a host without
    one it exits 1 with resolve_device's message and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    assert module.main([a.format(tmp=tmp_path) for a in argv]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("argv", [[], ["a", "b"]])
def test_biquad_ab_usage(argv, capsys):
    """biquad_ab takes one argument, the other checkout's root: anything
    else prints its usage and exits 2 before it needs a card."""
    from rayverb_tpu_torch import biquad_ab

    assert biquad_ab.main(argv) == 2
    assert "usage: biquad_ab PARENT" in capsys.readouterr().err
