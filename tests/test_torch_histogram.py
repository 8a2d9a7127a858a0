"""The port's flattening and post-processing (rayverb_tpu_torch/ops/
histogram.py, ops/postprocess.py) against the JAX package's.

Tolerances: bins are C's round-half-away-from-zero in float32 in both
packages, so every arrival lands in the same bin (compared exactly, also at
exact half-sample times); the per-bin sums add the same float32 values in
another order (the port's sorted binning against XLA's scatter-add), 2e-6
relative. Predelay, normalisation and trim lengths are exact."""

import numpy as np
import pytest
import torch

from rayverb_tpu.config.schema import FilterType as JaxFilter
from rayverb_tpu.ops import histogram as jh
from rayverb_tpu.ops import postprocess as jp
from rayverb_tpu_torch.config.schema import FilterType as PortFilter
from rayverb_tpu_torch.ops import histogram as ph
from rayverb_tpu_torch.ops import postprocess as pp

torch.set_num_threads(1)

SR = 1024.0  # k / 1024 and (k + 0.5) / 1024 are exact in float32


def _impulses(rng, c=2, m=500, tmax=0.9):
    vol = rng.random((c, m, 8)).astype(np.float32)
    vol[:, rng.random(m) < 0.2] = 0.0
    tim = (rng.random((c, m)) * tmax).astype(np.float32)
    return vol, tim


def test_flatten_channels_matches_jax(rng):
    vol, tim = _impulses(rng)
    got = ph.flatten_channels(torch.from_numpy(vol), torch.from_numpy(tim), SR)
    want = np.asarray(jh.flatten_channels(vol, tim, SR))
    assert got.shape == want.shape == (2, 8, ph.max_sample(torch.from_numpy(tim), SR))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-7)
    assert np.array_equal(got.numpy() != 0, want != 0)


def test_half_sample_times_round_away_from_zero():
    """Exact half-sample times go up (C round), never to even
    (torch.round); k / sr lands in bin k."""
    k = np.arange(0, 40, dtype=np.float32)
    tim = np.concatenate([(k + 0.5) / SR, k / SR]).astype(np.float32)[None]
    vol = np.ones((1, tim.shape[1], 8), np.float32)
    vol[0, 40:] = 2.0
    got = ph.flatten_channels(torch.from_numpy(vol), torch.from_numpy(tim), SR)
    want = np.asarray(jh.flatten_channels(vol, tim, SR))
    assert got.numpy().tobytes() == want.tobytes()
    band = got[0, 0].numpy()
    # bin 0 holds t=0 (2.0); bin j >= 1 holds (j - 0.5) -> j (1.0) and j (2.0)
    assert band[0] == 2.0 and np.all(band[1:40] == 3.0) and band[40] == 1.0


def test_flatten_impulses_drops_out_of_range(rng):
    vol = np.ones((3, 8), np.float32)
    tim = np.array([0.001, 0.5, 2.0], np.float32)
    got = ph.flatten_impulses(torch.from_numpy(vol), torch.from_numpy(tim), SR, length=600)
    want = np.asarray(jh.flatten_impulses(vol, tim, SR, length=600))
    assert got.numpy().tobytes() == want.tobytes()
    assert float(got.sum()) == 16.0


def test_max_sample_matches_jax(rng):
    _, tim = _impulses(rng)
    for sr in (SR, 16000.0, 44100.0):
        assert ph.max_sample(torch.from_numpy(tim), sr) == jh.max_sample(tim, sr)
    assert ph.max_sample(torch.zeros((0,)), SR) == jh.max_sample(np.zeros((0,), np.float32), SR)


def test_predelay_matches_jax(rng):
    _, tim = _impulses(rng)
    tim[:, :7] = 0.0
    t = torch.from_numpy(tim)
    p = pp.find_predelay(t)
    assert p == jp.find_predelay(tim) and p > 0
    got = pp.fix_predelay(t, p).numpy()
    assert got.tobytes() == np.asarray(jp.fix_predelay(tim, p)).tobytes()
    assert got.min() == 0.0
    assert pp.fix_predelay(t).numpy().tobytes() == got.tobytes()
    assert pp.find_predelay(torch.zeros((3,))) == jp.find_predelay(np.zeros(3, np.float32)) == 0.0


def test_mixdown_normalize_trim_match_jax(rng):
    bands = rng.standard_normal((2, 8, 300)).astype(np.float32)
    mixed = pp.mixdown(torch.from_numpy(bands))
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jp.mixdown(bands)), rtol=1e-6, atol=1e-6)
    assert np.array_equal(pp.mixdown(bands), jp.mixdown(bands))
    norm = pp.normalize(mixed)
    assert norm.numpy().tobytes() == np.asarray(jp.normalize(mixed.numpy())).tobytes()
    assert float(norm.abs().max()) == 1.0
    assert np.array_equal(pp.normalize(mixed.numpy()), jp.normalize(mixed.numpy()))
    assert float(pp.normalize(torch.zeros((2, 5))).abs().max()) == 0.0
    x = np.zeros((2, 50), np.float32)
    x[0, 30] = 1e-5
    x[1, 20] = 0.5
    x[1, 40] = 9e-6
    assert pp.trim_tail_length(x) == jp.trim_tail_length(x) == 30
    assert np.array_equal(pp.trim_tail(x), jp.trim_tail(x))


@pytest.mark.parametrize("filt", ["linkwitz_riley", "sinc"])
@pytest.mark.parametrize("method", ["scan", "fft"])
def test_process_matches_jax(rng, filt, method):
    bands = np.zeros((2, 8, 900), np.float32)
    hit = rng.random((2, 8, 900)) < 0.05
    bands[hit] = rng.standard_normal(int(hit.sum())).astype(np.float32)
    kw = dict(lo_cutoff=60.0, do_normalize=True, volume_scale=0.5, do_trim_tail=True,
              filter_method=method)
    got = pp.process(torch.from_numpy(bands), 16000.0, filter_type=PortFilter(filt), **kw)
    want = jp.process(bands, 16000.0, filter_type=JaxFilter(filt), **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert abs(got.shape[-1] - want.shape[-1]) <= 1
    n = min(got.shape[-1], want.shape[-1])
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=1e-5 * np.abs(want).max())
