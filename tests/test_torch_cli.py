"""The PyTorch port's CLI: renders a readable WAV on the CPU, and mirrors
rayverb_tpu.cli's error texts and exit codes."""

import json

import numpy as np
import pytest
import torch

from rayverb_tpu import cli as jax_cli
from rayverb_tpu_torch import cli as port_cli
from rayverb_tpu_torch.io.audio import read_audio

torch.set_num_threads(1)


def _write_config(path, **overrides):
    doc = {
        "rays": 64,
        "reflections": 6,
        "sample_rate": 8000,
        "bit_depth": 16,
        "source_position": [0.031, -0.011, 0.007],
        "mic_position": [0.013, 0.017, 2.021],
        "attenuation_model": {
            "speakers": [
                {"direction": [-1, 0, 1], "shape": 0.5},
                {"direction": [1, 0, 1], "shape": 0.5},
            ]
        },
        "filter": "linkwitz_riley",
        "trim_predelay": True,
        "output_mode": "all",
    }
    doc.update(overrides)
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture
def bedroom_args(assets_dir, tmp_path):
    return [
        _write_config(tmp_path / "bedroom.json"),
        str(assets_dir / "test_models" / "bedroom.obj"),
        str(assets_dir / "materials" / "mat.json"),
    ]


def test_cli_writes_wav_on_cpu(bedroom_args, tmp_path, capsys):
    out = tmp_path / "ir.wav"
    rc = port_cli.main(bedroom_args + [str(out), "--device", "cpu", "--stats", "--seed", "5"])
    assert rc == 0, capsys.readouterr().err
    data, sr, bits = read_audio(str(out))
    assert (sr, bits) == (8000.0, 16)
    assert data.shape[0] == 2 and data.shape[1] > 100
    assert np.all(np.isfinite(data)) and np.abs(data).max() > 0.5
    assert "pair-tests" in capsys.readouterr().err


def _run_both(argv, capsys):
    rc_j = jax_cli.main(argv)
    err_j = capsys.readouterr().err
    rc_p = port_cli.main(argv + ["--device", "cpu"])
    err_p = capsys.readouterr().err
    return rc_j, err_j, rc_p, err_p


@pytest.mark.parametrize("case", ["missing_input", "bad_extension", "bad_bit_depth", "bad_config"])
def test_cli_errors_match_reference(bedroom_args, tmp_path, capsys, case):
    args = list(bedroom_args)
    out = str(tmp_path / "ir.wav")
    if case == "missing_input":
        args[1] = str(tmp_path / "nope.obj")
    elif case == "bad_extension":
        out = str(tmp_path / "ir.mp3")
    elif case == "bad_bit_depth":
        args[0] = _write_config(tmp_path / "b.json", bit_depth=12)
    else:
        (tmp_path / "c.json").write_text('{"rays": 10}')
        args[0] = str(tmp_path / "c.json")
    rc_j, err_j, rc_p, err_p = _run_both(args + [out], capsys)
    assert rc_j == rc_p == 1
    assert err_p == err_j and err_p


@pytest.mark.parametrize(
    "extra, message",
    [
        (["--pipeline", "modular"], "--pipeline modular is not ported yet"),
        (["--save-raw", "x.npz"], "--save-raw is not ported yet"),
        (["--from-raw", "x.npz"], "--from-raw is not ported yet"),
        (["--dump-paths", "x.jsonl"], "--dump-paths is not ported yet"),
    ],
)
def test_cli_unported_flags(bedroom_args, tmp_path, capsys, extra, message):
    rc = port_cli.main(bedroom_args + [str(tmp_path / "ir.wav"), "--device", "cpu"] + extra)
    assert rc == 1
    assert message in capsys.readouterr().err


def test_cli_hrtf_config_not_ported(bedroom_args, tmp_path, capsys, monkeypatch):
    """HRTF configs render through the CLI (it once refused them; the name
    is kept): exit 0 and a stereo WAV; with --stats and
    RAYVERB_SWEEP_STATS the executed pair tests by kind are printed."""
    monkeypatch.setenv("RAYVERB_SWEEP_STATS", "1")
    args = list(bedroom_args)
    args[0] = _write_config(
        tmp_path / "h.json",
        attenuation_model={"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
    )
    out = tmp_path / "ir.wav"
    rc = port_cli.main(args + [str(out), "--device", "cpu", "--stats"])
    err = capsys.readouterr().err
    assert rc == 0, err
    data, sr, bits = read_audio(str(out))
    assert (sr, bits) == (8000.0, 16)
    assert data.shape[0] == 2 and data.shape[1] > 100
    assert np.all(np.isfinite(data)) and np.abs(data).max() > 0.5
    assert "pair-tests executed:" in err and "bounce:" in err and "shadow:" in err


def test_cli_default_device_is_cuda(bedroom_args, tmp_path, capsys):
    """Without --device the CLI asks for the GPU; on a host without one it
    fails with exit 1 rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    rc = port_cli.main(bedroom_args + [str(tmp_path / "ir.wav")])
    assert rc == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "ir.wav").exists()
