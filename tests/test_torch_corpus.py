"""The port's demo-corpus renderer (rayverb_tpu_torch.gen) and its acoustic
comparison (rayverb_tpu_torch.corpus_check), on the CPU.

  - gen.COMBOS equals scripts/gen.py's table (loaded by path), order and
    all; the seed of a render is its index in the full table whatever
    --only and --limit keep; --dry-run renders and writes nothing; the
    repository's impulses/ and a missing --outdir are refused
  - corpus_check on constructed IRs: a file against itself passes with
    zero readings; +2 dB on one channel fails balance, a rising tail fails
    decay, one crossover band 6 dB up fails spectrum; empty against empty
    passes and against non-empty fails; a checked-in corpus WAV against
    itself passes

The CLI parity of the corpus's configs is in tests/test_torch_corpus_cli.py.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from rayverb_tpu_torch import corpus_check, gen
from rayverb_tpu_torch.io.audio import write_audio

from conftest import REPO

SR = 44100.0


def _scripts_gen():
    spec = importlib.util.spec_from_file_location("scripts_gen", REPO / "scripts" / "gen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_combos_equal_scripts_gen():
    assert len(gen.COMBOS) == 165
    assert gen.COMBOS == _scripts_gen().COMBOS
    configs, models, materials = (set(x) for x in zip(*gen.COMBOS))
    assert (len(configs), len(models), len(materials)) == (14, 16, 5)
    for combo in gen.COMBOS:
        assert all(os.path.isfile(p) for p in gen.combo_paths(combo))
        assert (REPO / "impulses" / combo[1] / f"{gen.combo_name(combo)}.wav").is_file()


def test_seed_is_the_full_list_index(capsys):
    """scripts/gen.py seeds render i of the filtered list with seed + i; the
    port seeds by the index in the full list, so a filtered re-render
    traces the corpus file's rays."""
    todo = gen.select(only="small_square", limit=3)
    assert [k for k, _ in todo] == [7, 27, 28]
    assert [gen.COMBOS[k] for k, _ in todo] == [c for _, c in todo]
    rc = gen.main(["--outdir", "unused", "--only", "small_square", "--limit", "3",
                   "--seed", "10", "--dry-run", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out == [
        "[1/3] small_square x near_c x mat (seed 17)",
        "[2/3] small_square x near_l x mat (seed 37)",
        "[3/3] small_square x near_r x mat (seed 38)",
    ]
    assert len(gen.select()) == 165 and gen.select(limit=5) == list(enumerate(gen.COMBOS[:5]))


def test_dry_run_writes_nothing(tmp_path):
    out = tmp_path / "corpus"
    assert gen.main(["--outdir", str(out), "--dry-run", "--device", "cpu"]) == 0
    assert not out.exists()


@pytest.mark.parametrize("outdir", ["impulses", "impulses/../impulses", "{repo}/impulses/"])
def test_refuses_the_repository_corpus(outdir, monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit) as e:
        gen.main(["--outdir", outdir.format(repo=REPO), "--dry-run", "--device", "cpu"])
    assert e.value.code == 2
    assert "JAX package's corpus" in capsys.readouterr().err


def test_requires_outdir(capsys):
    with pytest.raises(SystemExit) as e:
        gen.main(["--dry-run", "--device", "cpu"])
    assert e.value.code == 2
    assert "--outdir" in capsys.readouterr().err


def test_covering_subset():
    """Each combination of covering() brings a config, model or material no
    earlier one brought, and together they cover all of them."""
    cov = gen.covering()
    assert [k for k, _ in cov][:4] == [0, 1, 2, 3] and len(cov) == 29
    seen = [set(), set(), set()]
    for k, combo in cov:
        assert gen.COMBOS[k] == combo
        assert any(p not in s for p, s in zip(combo, seen))
        for p, s in zip(combo, seen):
            s.add(p)
    assert seen == [set(x) for x in zip(*gen.COMBOS)]


# ---------------------------------------------------------------------------
# corpus_check
# ---------------------------------------------------------------------------

def _ir(seconds=0.6, channels=2, seed=0):
    """Exponentially decaying noise (T60 ~ 0.4 s), peak 0.9."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = np.exp(-6.9 * np.arange(n) / (0.4 * SR))
    x = rng.standard_normal((channels, n)) * env
    return 0.9 * x / np.abs(x).max()


def _check(got, want):
    return corpus_check.compare(got, SR, 24, want, SR, 24)


def _failed(rec):
    return sorted(n for n, c in rec["checks"].items() if c and not c["ok"])


def test_file_against_itself_passes_with_zeros(tmp_path):
    path = str(tmp_path / "ir.wav")
    write_audio(path, _ir().astype(np.float32), SR, 24)
    rec = corpus_check.compare_files(path, path)
    assert rec["ok"] and _failed(rec) == []
    for name in ("length", "decay", "balance", "spectrum"):
        assert rec["checks"][name]["value"] == 0.0
    assert rec["checks"]["decay"]["bound"] == corpus_check.DECAY_DB


def test_two_db_on_one_channel_fails_balance():
    want = _ir()
    got = want.copy()
    got[1] *= 10 ** (2 / 20)
    rec = _check(got, want)
    assert _failed(rec) == ["balance"]
    assert rec["checks"]["balance"]["value"] == pytest.approx(2.0, abs=0.6)


def test_rising_tail_fails_decay():
    want = _ir()
    got = want.copy()
    n = got.shape[1]
    tail = np.arange(n) >= n // 8
    got[:, tail] *= np.exp(3.0 * np.linspace(0.0, 1.0, int(tail.sum())))
    rec = _check(got, want)
    assert "decay" in _failed(rec)
    assert rec["checks"]["decay"]["value"] > corpus_check.DECAY_DB


def test_one_band_up_fails_spectrum():
    """The 760-1520 Hz crossover band 6 dB up, in both channels: spectrum
    fails; balance (both channels alike) holds."""
    want = _ir()
    spec = np.fft.rfft(want, axis=-1)
    f = np.fft.rfftfreq(want.shape[1], 1 / SR)
    spec[:, (f >= 760) & (f < 1520)] *= 2.0
    got = np.fft.irfft(spec, n=want.shape[1], axis=-1)
    rec = _check(got, want)
    assert "spectrum" in _failed(rec) and "balance" not in _failed(rec)
    assert rec["checks"]["spectrum"]["value"] > 3.0


def test_empty_files(tmp_path):
    empty = str(tmp_path / "empty.wav")
    full = str(tmp_path / "full.wav")
    write_audio(empty, np.zeros((2, 0), np.float32), SR, 24)
    write_audio(full, _ir().astype(np.float32), SR, 24)
    rec = corpus_check.compare_files(empty, empty)
    assert rec["ok"] and rec["checks"]["empty"]["value"] == [True, True]
    assert rec["checks"]["decay"] is None
    for got, want in ((empty, full), (full, empty)):
        rec = corpus_check.compare_files(got, want)
        assert not rec["ok"] and _failed(rec) == ["empty"]


def test_format_mismatch_fails():
    rec = corpus_check.compare(_ir(channels=2), SR, 24, _ir(channels=8), SR, 24)
    assert _failed(rec) == ["format"] and rec["checks"]["spectrum"] is None
    rec = corpus_check.compare(_ir(), SR, 16, _ir(), SR, 24)
    assert _failed(rec) == ["format"]


def test_checked_in_wav_against_itself_passes():
    path = str(REPO / "impulses" / "random_pillars" / "random_pillars_oct_mat.wav")
    rec = corpus_check.compare_files(path, path)
    assert rec["ok"] and rec["checks"]["format"]["value"]["channels"] == [8, 8]
    assert corpus_check.main([path, path]) == 0


def test_worst_over_records():
    recs = [_check(_ir(), _ir()), _check(_ir(seed=1), _ir())]
    worst = corpus_check.worst(recs)
    assert worst["decay"]["bound"] == corpus_check.DECAY_DB
    assert worst["decay"]["max"] == recs[1]["checks"]["decay"]["value"]
    assert worst["format"]["failed"] == 0
    assert json.loads(json.dumps(worst)) == worst


def test_main_writes_the_report(tmp_path, monkeypatch, capsys):
    """A reduced render of two combinations (rays and reflections cut in
    their config files) held against a directory where one reference is
    missing: the report has scripts/gen.py's keys and the per-render
    records, the missing reference fails its check, and the exit code is 1."""
    real = gen.combo_paths

    def reduced(combo):
        cfg, model, materials = real(combo)
        doc = json.load(open(cfg))
        doc.update(rays=200, reflections=6)
        path = tmp_path / f"{combo[0]}.json"
        path.write_text(json.dumps(doc))
        return str(path), model, materials

    monkeypatch.setattr(gen, "combo_paths", reduced)
    refs = tmp_path / "refs"
    out = tmp_path / "out"
    assert gen.main(["--outdir", str(refs), "--only", "small_heptagon", "--limit", "2",
                     "--device", "cpu"]) == 0
    (refs / "small_heptagon" / "small_heptagon_near_l_mat.wav").unlink()
    rc = gen.main(["--outdir", str(out), "--only", "small_heptagon", "--limit", "2",
                   "--device", "cpu", "--check-against", str(refs)])
    assert rc == 1
    report = json.loads((out / "report.json").read_text())
    assert set(report) >= {"rendered", "failures", "failed_combos", "total", "wall_seconds",
                           "per_render_seconds", "pipeline", "mode", "ext", "renders",
                           "check_failed_combos", "check_worst"}
    assert (report["rendered"], report["total"], report["failures"]) == (2, 2, 0)
    first, second = report["renders"]
    assert (first["combo"], first["seed"], first["run"]) == ("small_heptagon_near_c_mat", 32, "cold")
    assert (second["seed"], second["run"]) == (33, "warm")
    assert first["channels"] == 2 and first["samples"] > 0 and first["wall_s"] > 0
    assert first["check"]["ok"] and first["check"]["checks"]["decay"]["value"] == 0.0
    assert not second["check"]["ok"] and "error" in second["check"]
    assert report["check_failed_combos"] == ["small_heptagon_near_l_mat"]
    assert "1 failed the check" in capsys.readouterr().out
