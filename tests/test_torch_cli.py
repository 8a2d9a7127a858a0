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
    err = capsys.readouterr().err
    assert "phases [trace_bin:" in err and "rv.render" in err and "closest_hit.calls=" in err


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
    "flag",
    ["--pipeline modular", "--save-raw", "--from-raw", "--dump-paths",
     "--filter-method fft"],
)
def test_cli_modular_flags(bedroom_args, tmp_path, capsys, flag):
    """The modular pipeline's flags, once refused (the name is kept), now
    work on the CPU: exit 0 and a stereo WAV; --save-raw writes a file both
    packages load; --from-raw gives the direct modular render's IR;
    --dump-paths writes one JSON line per ray in the JAX schema, equal to
    the JAX CLI's dump for the same seed (positions within 1e-4 m and band
    means within 1e-6, the trace tolerances of tests/test_torch_trace.py);
    --filter-method fft gives the scan render's IR within -60 dB."""
    from rayverb_tpu import engine as jax_engine
    from rayverb_tpu_torch import engine as port_engine

    base = bedroom_args + ["--device", "cpu", "--seed", "5"]
    out = tmp_path / "ir.wav"
    raw = str(tmp_path / "raw.npz")
    extra = {
        "--pipeline modular": ["--pipeline", "modular"],
        "--save-raw": ["--save-raw", raw],
        "--from-raw": ["--from-raw", raw],
        "--dump-paths": ["--dump-paths", str(tmp_path / "p.jsonl")],
        "--filter-method fft": ["--pipeline", "modular", "--filter-method", "fft"],
    }[flag]
    direct = tmp_path / "direct.wav"
    if flag in ("--from-raw", "--filter-method fft"):
        rc = port_cli.main(base[:3] + [str(direct)] + base[3:] + ["--save-raw", raw])
        assert rc == 0, capsys.readouterr().err
    rc = port_cli.main(base[:3] + [str(out)] + base[3:] + extra + ["--stats"])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "phases [" in err and "process:" in err
    data, sr, bits = read_audio(str(out))
    assert (sr, bits) == (8000.0, 16)
    assert data.shape[0] == 2 and data.shape[1] > 100
    assert np.all(np.isfinite(data)) and np.abs(data).max() > 0.5
    if flag == "--save-raw":
        for engine in (port_engine, jax_engine):
            res = engine.load_raw(raw)
            assert res.num_impulses > 64 * 6 and res.volume.shape == (res.num_impulses, 8)
    elif flag == "--from-raw":
        assert "trace:" not in err
        want = read_audio(str(direct))[0]
        assert data.shape == want.shape and np.array_equal(data, want)
    elif flag == "--filter-method fft":
        want = read_audio(str(direct))[0]
        n = min(data.shape[1], want.shape[1])
        assert abs(data.shape[1] - want.shape[1]) <= 2
        assert np.abs(data[:, :n] - want[:, :n]).max() < 1e-3 * np.abs(want).max()
    elif flag == "--dump-paths":
        jax_out = tmp_path / "jax.wav"
        rc = jax_cli.main(bedroom_args + [str(jax_out), "--seed", "5", "--dump-paths",
                                          str(tmp_path / "j.jsonl")])
        assert rc == 0, capsys.readouterr().err
        got = [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()]
        want = [json.loads(line) for line in (tmp_path / "j.jsonl").read_text().splitlines()]
        assert len(got) == len(want) == 64
        for g, w in zip(got, want):
            assert len(g) == len(w) == 6
            for ge, we in zip(g, w):
                assert set(ge) == set(we) == {"position", "volume"}
                np.testing.assert_allclose(ge["position"], we["position"], rtol=0, atol=1e-4)
                assert abs(ge["volume"] - we["volume"]) <= 1e-6


def test_cli_renders_hrtf_config(bedroom_args, tmp_path, capsys):
    """HRTF configs render through the CLI (it once refused them; the name
    is kept): exit 0 and a stereo WAV; with --stats the render's span
    table and counters are printed, the executed pair tests by kind among
    them."""
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
    assert "rv.closest_hit" in err and "rv.bounce" in err and "self s" in err
    assert "pair_tests.bounce=" in err and "pair_tests.shadow=" in err
    assert "live_rows.bounce=" in err and "live_rows.shadow=" in err
    assert "hist.len=" in err and "finalize.bucket=" in err
    assert "G/s" not in err


def test_cli_default_device_is_cuda(bedroom_args, tmp_path, capsys):
    """Without --device the CLI asks for the GPU; on a host without one it
    fails with exit 1 rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    rc = port_cli.main(bedroom_args + [str(tmp_path / "ir.wav")])
    assert rc == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "ir.wav").exists()
