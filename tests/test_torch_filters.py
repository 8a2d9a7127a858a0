"""The port's crossover filter bank (rayverb_tpu_torch/ops/filters.py)
against the JAX package's (rayverb_tpu/ops/filters.py) and against scipy,
and a numpy twin of the biquad_scan kernel's schedule against its plain
version.

Tolerances:
  - the windowed-sinc designs, the band edges and the coefficient stacks
    are host numpy in both packages: byte-equal
  - the biquad scan runs float32 state with one rounding per multiply and
    add in both packages; XLA's CPU scan may order or contract them
    otherwise, so the two agree to 1e-5 of the signal's peak at these
    lengths, and both to scipy's float64 lfilter at 2e-5 of peak (the JAX
    scan is validated against scipy to ~1e-4, filters.py:161)
  - FFT passes: float32 FFTs of two libraries, 1e-5 of peak
"""

import pathlib
import re

import numpy as np
import pytest
import scipy.signal as sps
import torch

from rayverb_tpu.config.schema import FilterType as JaxFilter
from rayverb_tpu.ops import filters as jf
from rayverb_tpu_torch.config.schema import FilterType as PortFilter
from rayverb_tpu_torch.ops import biquad_cuda
from rayverb_tpu_torch.ops import filters as pf

torch.set_num_threads(1)

SR = 16000.0
FILTERS = ["sinc", "onepass", "twopass", "linkwitz_riley"]
CSRC = pathlib.Path(pf.__file__).resolve().parent.parent / "csrc" / "biquad_scan.cu"


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0
    err = np.abs(got - want).max() / peak
    assert err < tol, f"max error {err:.2e} of peak exceeds {tol:.0e}"


def _signals(rng, shape):
    """Band-signal-like input: sparse arrivals decaying over the length."""
    t = shape[-1]
    x = rng.standard_normal(shape) * np.exp(-np.arange(t) / (t / 4))
    return np.where(rng.random(shape) < 0.1, x, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# designs, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cutoff", [0.01, 0.1, 0.25, 0.4])
def test_sinc_designs_byte_equal(cutoff):
    assert pf.sinc_kernel(cutoff, 29).tobytes() == jf.sinc_kernel(cutoff, 29).tobytes()
    assert pf.blackman(29).tobytes() == jf.blackman(29).tobytes()
    hz = cutoff * 44100.0
    for fn in ("lopass_kernel", "hipass_kernel"):
        got = getattr(pf, fn)(44100.0, hz, pf.KERNEL_LENGTH)
        want = getattr(jf, fn)(44100.0, hz, jf.KERNEL_LENGTH)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        pf.sinc_kernel(cutoff, 28)


@pytest.mark.parametrize("sr", [8000.0, 16000.0, 44100.0])
def test_bandpass_sinc_kernels_byte_equal(sr):
    edges = pf.band_edges(60.0, sr)
    assert edges == jf.band_edges(60.0, sr)
    for i in range(8):
        got = pf.bandpass_sinc_kernel(sr, edges[i], edges[i + 1])
        assert got.tobytes() == jf.bandpass_sinc_kernel(sr, edges[i], edges[i + 1]).tobytes()
    assert pf.sinc_bank_kernels(sr, 60.0).shape == (8, pf.KERNEL_LENGTH)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("sr", [8000.0, 44100.0])
def test_band_coeffs_byte_equal(filt, sr):
    """Every filter type, the windowed-sinc one included (it gets the
    Linkwitz-Riley stacks in both packages)."""
    got = pf._band_coeffs(PortFilter(filt), sr, 45.0)
    want = jf._band_coeffs(JaxFilter(filt), sr, 45.0)
    assert len(got) == len(want)
    for (gc, gf), (wc, wf) in zip(got, want):
        assert gf == wf and gc.dtype == wc.dtype and gc.tobytes() == wc.tobytes()


# ---------------------------------------------------------------------------
# the biquad scan
# ---------------------------------------------------------------------------

def _lp_coeffs():
    return np.asarray(pf.linkwitz_riley_coeffs(60.0, 175.0, SR)[0])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("coeff_kind", ["lowpass", "bandpass"])
def test_biquad_onepass_matches_jax_and_scipy(rng, reverse, coeff_kind):
    c = (_lp_coeffs() if coeff_kind == "lowpass"
         else np.asarray(pf.bandpass_biquad_coeffs(700.0, 1400.0, SR)))
    x = _signals(rng, (3, 2000))
    got = pf.biquad_onepass(torch.from_numpy(x), c, reverse=reverse)
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(jf.biquad_onepass(x, c, reverse=reverse))
    _close(got.numpy(), want, 1e-5)
    c32 = c.astype(np.float32).astype(np.float64)
    sig = x[:, ::-1] if reverse else x
    ref = sps.lfilter(c32[:3], [1.0, *c32[3:]], sig.astype(np.float64), axis=-1)
    _close(got.numpy(), ref[:, ::-1] if reverse else ref, 2e-5)


def test_biquad_onepass_per_series_coefficients(rng):
    """(..., 8, T) data with (8, 5) coefficients: band b of every channel
    takes coefficient set b (the bank's vmap over bands)."""
    passes = pf._band_coeffs(PortFilter.LINKWITZ_RILEY, SR, 60.0)
    coeffs = passes[0][0]
    x = _signals(rng, (2, 8, 600))
    got = pf.biquad_onepass(torch.from_numpy(x), coeffs, reverse=True).numpy()
    for ch in range(2):
        for b in range(8):
            one = pf.biquad_onepass(torch.from_numpy(x[ch, b]), coeffs[b], reverse=True)
            assert got[ch, b].tobytes() == one.numpy().tobytes()
    want = np.asarray(jf._bank_scan_onepass(x[..., ::-1], coeffs))[..., ::-1]
    _close(got, want, 1e-5)
    fwd = pf._bank_scan_onepass(torch.from_numpy(x), coeffs).numpy()
    _close(fwd, np.asarray(jf._bank_scan_onepass(x, coeffs)), 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_biquad_content_len_masks_and_matches_jax(rng, reverse):
    """content_len: zeros at and after it, and a reverse pass that starts
    at content_len - 1 equals the JAX reverse scan over the masked signal
    (the fused finalize's scan branch, render.py:981-996)."""
    c = _lp_coeffs()
    x = _signals(rng, (4, 900))
    n = 611
    got = pf.biquad_onepass(torch.from_numpy(x), c, reverse=reverse, content_len=n).numpy()
    assert not np.any(got[:, n:]) and not np.any(np.signbit(got[:, n:]))
    head = pf.biquad_onepass(torch.from_numpy(np.ascontiguousarray(x[:, :n])), c,
                             reverse=reverse).numpy()
    assert got[:, :n].tobytes() == head.tobytes()
    masked = np.where(np.arange(900) < n, x, 0.0).astype(np.float32)
    want = np.asarray(jf.biquad_onepass(masked, c, reverse=reverse)) * (np.arange(900) < n)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_biquad_per_series_content_lengths_match_scalar_form(rng, reverse):
    """Per-series content lengths (the batched finalize's, one per pair):
    each series equals the scalar form at its own length bit for bit,
    through biquad_onepass_plain and through biquad_onepass with lengths
    broadcast over the leading dims."""
    coeffs = np.stack([_lp_coeffs(), pf.bandpass_biquad_coeffs(700.0, 1400.0, SR),
                       _lp_coeffs() * 0.5, _lp_coeffs()]).astype(np.float32)
    x = _signals(rng, (4, 300))
    lens = np.array([0, 1, 173, 300], np.int32)
    got = pf.biquad_onepass_plain(torch.from_numpy(x), torch.from_numpy(coeffs),
                                  reverse=reverse, content_len=torch.from_numpy(lens))
    for s, n in enumerate(lens):
        one = pf.biquad_onepass_plain(torch.from_numpy(x[s:s + 1]), torch.from_numpy(coeffs[s:s + 1]),
                                      reverse=reverse, content_len=int(n))
        assert got[s].numpy().tobytes() == one[0].numpy().tobytes(), f"series {s}"
    batch = _signals(rng, (2, 3, 8, 120))
    pair_lens = torch.tensor([57, 120]).reshape(2, 1, 1)
    c8 = pf._band_coeffs(PortFilter.LINKWITZ_RILEY, SR, 60.0)[0][0]
    out = pf.biquad_onepass(torch.from_numpy(batch), c8, reverse=reverse,
                            content_len=pair_lens).numpy()
    for p, n in enumerate((57, 120)):
        one = pf.biquad_onepass(torch.from_numpy(batch[p]), c8, reverse=reverse,
                                content_len=n).numpy()
        assert out[p].tobytes() == one.tobytes()


def test_biquad_plain_refuses_bad_content_len(rng):
    x = torch.from_numpy(_signals(rng, (2, 50)))
    c = torch.ones((2, 5))
    for bad in (-1, 51):
        with pytest.raises(ValueError, match="content_len"):
            pf.biquad_onepass_plain(x, c, content_len=bad)
        with pytest.raises(ValueError, match="content lengths"):
            pf.biquad_onepass_plain(x, c, content_len=torch.tensor([3, bad]))


def test_biquad_cuda_wrapper_refuses_cpu_tensors(rng):
    """The kernel's wrapper never falls back: a CPU tensor raises (CPU
    tensors reach biquad_onepass_plain through biquad_onepass only)."""
    x = torch.from_numpy(_signals(rng, (2, 50)))
    before = biquad_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        biquad_cuda.biquad_scan_cuda(x, torch.ones((2, 5)))
    assert biquad_cuda.launches == before


def test_biquad_twopass_and_fft_passes_match_jax(rng):
    c = np.asarray(pf.bandpass_biquad_coeffs(350.0, 700.0, SR))
    x = _signals(rng, (2, 1500))
    t = torch.from_numpy(x)
    _close(pf.biquad_twopass(t, c).numpy(), np.asarray(jf.biquad_twopass(x, c)), 1e-5)
    _close(pf.fft_biquad_onepass(t, c).numpy(), np.asarray(jf.fft_biquad_onepass(x, c)), 1e-5)
    _close(pf.fft_biquad_twopass(t, c).numpy(), np.asarray(jf.fft_biquad_twopass(x, c)), 1e-5)
    # the FFT pass is the scan to float32 noise (the JAX module's claim)
    _close(pf.fft_biquad_onepass(t, c).numpy(), pf.biquad_onepass(t, c).numpy(), 1e-4)


def test_fir_filter_matches_jax_and_numpy(rng):
    x = _signals(rng, (3, 400))
    k = pf.bandpass_sinc_kernel(SR, 700.0, 1400.0)
    got = pf.fir_filter(torch.from_numpy(x), k).numpy()
    assert got.shape == (3, 400 + pf.KERNEL_LENGTH - 1)
    _close(got, np.asarray(jf.fir_filter(x, k)), 1e-5)
    _close(got, np.stack([np.convolve(r.astype(np.float64), k) for r in x]), 1e-5)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("method", ["scan", "fft"])
def test_filter_bank_matches_jax(rng, filt, method):
    """filter_bank for scan and fft x the four filter types; the sinc
    type is the fir bank (its method is not read), with FastConvolution
    growth."""
    x = _signals(rng, (2, 8, 1200))
    got = pf.filter_bank(torch.from_numpy(x), SR, 60.0, PortFilter(filt), method=method)
    want = np.asarray(jf.filter_bank(x, SR, 60.0, JaxFilter(filt), method=method))
    grow = pf.KERNEL_LENGTH - 1 if filt == "sinc" else 0
    assert got.shape == (2, 8, 1200 + grow) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)


def test_filter_bank_scan_and_fft_agree(rng):
    x = _signals(rng, (1, 8, 1500))
    t = torch.from_numpy(x)
    scan = pf.filter_bank(t, SR, 60.0, PortFilter.LINKWITZ_RILEY, method="scan")
    fft = pf.filter_bank(t, SR, 60.0, PortFilter.LINKWITZ_RILEY, method="fft")
    _close(fft.numpy(), scan.numpy(), 1e-4)
    with pytest.raises(ValueError, match="method"):
        pf.filter_bank(t, SR, 60.0, PortFilter.LINKWITZ_RILEY, method="fir")


# ---------------------------------------------------------------------------
# a numpy twin of the biquad_scan kernel's schedule
# ---------------------------------------------------------------------------

def _cu_constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", CSRC.read_text())
    assert m, name
    return m.group(1)


def test_kernel_constants_match_the_wrapper():
    assert int(_cu_constant("kTile")) == biquad_cuda.TILE
    assert _cu_constant("kStagers") == "kThreads - 32"


def _kernel_twin(x, coeffs, reverse, content, tile, stagers):
    """The schedule of csrc/biquad_scan.cu in numpy float32, per series
    (``content`` an int, or one length per series as the kernel's
    ``contents`` array gives them):
    the tail [content, t) written +0; tiles of ``tile`` samples walked
    from the first (from the last when reverse); tile 0 loaded by every
    thread; then per step k the chain thread runs tile k in buffer k & 1,
    while each of ``stagers`` threads writes its slots of tile k-1 out of
    the other buffer and loads its slots of tile k+1 into it; the last
    tile written out by every thread. Unwritten outputs stay NaN."""
    s_count, t = x.shape
    y = np.full((s_count, t), np.nan, np.float32)
    f = np.float32
    lens = np.broadcast_to(np.asarray(content), (s_count,))
    for s in range(s_count):
        content = int(lens[s])
        b0, b1, b2, a1, a2 = (f(v) for v in coeffs[s])
        y[s, content:] = f(0.0)
        ntiles = -(-content // tile)
        if ntiles == 0:
            continue

        def span(k):
            tk = ntiles - 1 - k if reverse else k
            return tk * tile, min(tile, content - tk * tile)

        buf = [np.full(tile, np.nan, np.float32), np.full(tile, np.nan, np.float32)]
        start, length = span(0)
        buf[0][:length] = x[s, start:start + length]
        z1 = z2 = f(0.0)
        for k in range(ntiles):
            cur = buf[k & 1]
            _, length = span(k)
            for i in (range(length - 1, -1, -1) if reverse else range(length)):
                xv = cur[i]
                out = f(xv * b0) + z1
                z1, z2 = f(f(xv * b1) + z2) - f(a1 * out), f(xv * b2) - f(a2 * out)
                cur[i] = out
            other = buf[(k + 1) & 1]
            for j in range(stagers):
                if k >= 1:
                    ps, pl = span(k - 1)
                    for i in range(j, pl, stagers):
                        y[s, ps + i] = other[i]
                if k + 1 < ntiles:
                    ns, nl = span(k + 1)
                    for i in range(j, nl, stagers):
                        other[i] = x[s, ns + i]
        start, length = span(ntiles - 1)
        y[s, start:start + length] = buf[(ntiles - 1) & 1][:length]
    return y


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("content", [0, 1, 15, 16, 17, 53, 64])
def test_kernel_schedule_twin_matches_plain(rng, reverse, content):
    """The twin (tiles of 16, 5 stagers, a 64-sample series) equals
    biquad_onepass_plain bit for bit for every content length around the
    tile edges, forward and reverse, and writes every sample."""
    x = _signals(rng, (3, 64))
    coeffs = np.stack([_lp_coeffs(), pf.bandpass_biquad_coeffs(700.0, 1400.0, SR),
                       _lp_coeffs() * 0.5]).astype(np.float32)
    twin = _kernel_twin(x, coeffs, reverse, content, tile=16, stagers=5)
    plain = pf.biquad_onepass_plain(torch.from_numpy(x), torch.from_numpy(coeffs),
                                    reverse=reverse, content_len=content).numpy()
    assert not np.isnan(twin).any()
    assert twin.tobytes() == plain.tobytes()


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_schedule_twin_per_series_lengths_matches_plain(rng, reverse):
    """The twin with one content length per series (0, 1, around the tile
    edges of 16, and full) equals biquad_onepass_plain given the same
    (S,) lengths bit for bit, and writes every sample."""
    lens = np.array([0, 1, 15, 16, 17, 33, 53, 64], np.int32)
    x = _signals(rng, (len(lens), 64))
    coeffs = np.tile(np.stack([_lp_coeffs(), pf.bandpass_biquad_coeffs(700.0, 1400.0, SR)]),
                     (len(lens) // 2, 1)).astype(np.float32)
    twin = _kernel_twin(x, coeffs, reverse, lens, tile=16, stagers=5)
    plain = pf.biquad_onepass_plain(torch.from_numpy(x), torch.from_numpy(coeffs),
                                    reverse=reverse, content_len=torch.from_numpy(lens)).numpy()
    assert not np.isnan(twin).any()
    assert twin.tobytes() == plain.tobytes()
