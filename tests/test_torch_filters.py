"""The port's crossover filter bank (rayverb_tpu_torch/ops/filters.py)
against the JAX package's (rayverb_tpu/ops/filters.py) and against scipy,
a numpy twin of the biquad_scan kernel's schedule against its plain
version, and the chunked bank on long series against the JAX scan and
scipy.

Tolerances:
  - the windowed-sinc designs, the band edges and the coefficient stacks
    are host numpy in both packages: byte-equal
  - the biquad scan runs float32 state in both packages: the port rounds
    each multiply and add on its own, XLA's CPU scan fuses them into
    multiply-adds (pinned below), and the port's scan is chunked (its
    carry between chunks rounds otherwise than the sequential chain), so
    the two agree to 1e-5 of the signal's peak at these lengths, and both
    to scipy's float64 lfilter at 2e-5 of peak (the JAX scan is validated
    against scipy to ~1e-4, filters.py:161); on long series the port's
    error from float64 is held to 1.25 x the JAX scan's own plus 1e-6 of
    peak, and to 1.05 x that of its own arithmetic run sequentially
  - the twin of the kernel's schedule and the plain version: bit for bit
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
    return m.group(1).strip()


def test_kernel_constants_match_the_wrapper():
    """The kernel's chunk and tile are filters.CHUNK and filters.TILE (the
    plain version's schedule and the wrapper's block count), its rows
    padded by one float, a tile one warp."""
    assert int(_cu_constant("kChunk")) == pf.CHUNK == biquad_cuda.CHUNK
    assert int(_cu_constant("kLanes")) == pf.TILE == biquad_cuda.TILE == 32
    assert _cu_constant("kStride") == "kChunk + 1"
    assert _cu_constant("kTileSamples") == "kChunk * kLanes"


def _twin_transitions(a1, a2, chunk, lanes):
    """The kernel's transitions(): A^chunk and A^(chunk * lanes) by float64
    repeated squaring."""
    m = [-np.float64(a1), np.float64(1.0), -np.float64(a2), np.float64(0.0)]

    def square(m):
        m00, m01, m10, m11 = m
        return [m00 * m00 + m01 * m10, m00 * m01 + m01 * m11,
                m10 * m00 + m11 * m10, m10 * m01 + m11 * m11]

    out = []
    for steps in (chunk, lanes):
        i = 1
        while i < steps:
            m = square(m)
            i <<= 1
        out.append(list(m))
    return out


def _twin_carry(m, z, e):
    """The kernel's carry() in float64: M z + e."""
    d = np.float64
    return (d(d(m[0] * z[0]) + d(m[1] * z[1])) + d(e[0]),
            d(d(m[2] * z[0]) + d(m[3] * z[1])) + d(e[1]))


def _kernel_twin(x, coeffs, reverse, content, chunk, lanes):
    """The schedule of csrc/biquad_scan.cu in numpy float32 (``content`` an
    int, or one length per series as the kernel's ``contents`` gives them),
    its blocks run in ticket order: ticket = series x tiles + tile. A block
    writes its share [n + j * tile, n + (j + 1) * tile) of the tail as +0;
    loads its tile's pass-order samples (from n - 1 down when reverse) into
    rows of chunk + 1 floats, one per lane; each lane runs its chunk from
    zero (A); in float64, the tile's aggregate is the lane-order chain of P
    from zero, published under its ticket; the tile's start is the chain
    of Q over the published aggregates of the tiles before it, from zero;
    each lane's start is the chain of P from the tile's start over the
    lanes before it (B); each lane runs its chunk again from its start,
    rounded to float32, over its row (C); the warp stores the tile.
    Unwritten outputs stay NaN."""
    s_count, t = x.shape
    f = np.float32
    y = np.full((s_count, t), np.nan, np.float32)
    span = chunk * lanes
    tiles = -(-t // span)
    stride = chunk + 1
    lens = np.broadcast_to(np.asarray(content), (s_count,))
    agg = {}
    for ticket in range(s_count * tiles):
        s, j = divmod(ticket, tiles)
        n = int(lens[s])
        b0, b1, b2, a1, a2 = (f(v) for v in coeffs[s])
        y[s, n + j * span:min(t, n + (j + 1) * span)] = f(0.0)
        first = j * span
        length = max(0, min(span, n - first))
        if length == 0:
            continue
        at = [n - 1 - first - p if reverse else first + p for p in range(length)]
        buf = np.full(lanes * stride, np.nan, np.float32)
        for p in range(length):
            buf[(p // chunk) * stride + p % chunk] = x[s, at[p]]

        def walk(lane, z, write):
            z1, z2 = z
            for k in range(max(0, min(chunk, length - lane * chunk))):
                i = lane * stride + k
                xv = buf[i]
                out = f(xv * b0) + z1
                z1, z2 = f(f(xv * b1) + z2) - f(a1 * out), f(xv * b2) - f(a2 * out)
                if write:
                    buf[i] = out
            return z1, z2

        e = [walk(lane, (f(0.0), f(0.0)), False) for lane in range(lanes)]
        p_mat, q_mat = _twin_transitions(a1, a2, chunk, lanes)
        z = (0.0, 0.0)
        for i in range(lanes):
            z = _twin_carry(p_mat, z, e[i])
        agg[ticket] = z
        c = (0.0, 0.0)
        for i in range(j):
            c = _twin_carry(q_mat, c, agg[ticket - j + i])
        starts = [c]
        for i in range(lanes - 1):
            c = _twin_carry(p_mat, c, e[i])
            starts.append(c)
        for lane in range(lanes):
            walk(lane, (f(starts[lane][0]), f(starts[lane][1])), True)
        for p in range(length):
            y[s, at[p]] = buf[(p // chunk) * stride + p % chunk]
    return y


TWIN_CHUNK, TWIN_LANES, TWIN_SAMPLES = 16, 4, 200  # tiles of 64 samples


def _twin_coeffs(series):
    return np.tile(np.stack([_lp_coeffs(), pf.bandpass_biquad_coeffs(700.0, 1400.0, SR)]),
                   (-(-series // 2), 1))[:series].astype(np.float32)


def _twin_vs_plain(x, coeffs, reverse, content):
    twin = _kernel_twin(x, coeffs, reverse, content, TWIN_CHUNK, TWIN_LANES)
    lens = torch.from_numpy(content) if isinstance(content, np.ndarray) else content
    plain = pf.biquad_onepass_plain(torch.from_numpy(x), torch.from_numpy(coeffs),
                                    reverse=reverse, content_len=lens,
                                    chunk=TWIN_CHUNK, tile=TWIN_LANES).numpy()
    assert not np.isnan(twin).any()
    assert twin.tobytes() == plain.tobytes()
    return plain


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("content", [0, 1, 15, 16, 17, 63, 64, 65, 129, 200])
def test_kernel_schedule_twin_matches_plain(rng, reverse, content):
    """The twin (chunks of 16, tiles of 4 chunks, 200-sample series: three
    full tiles and a partial one) equals biquad_onepass_plain at the same
    chunk and tile bit for bit for every content length around the chunk
    and tile edges, forward and reverse, and writes every sample; the tail
    is +0, and chunk 0 is the sequential pass."""
    x = _signals(rng, (3, TWIN_SAMPLES))
    coeffs = _twin_coeffs(3)
    plain = _twin_vs_plain(x, coeffs, reverse, content)
    assert not np.any(np.signbit(plain[:, content:]))
    head = min(content, TWIN_CHUNK)
    seq = pf.biquad_onepass_plain(torch.from_numpy(x), torch.from_numpy(coeffs), reverse=reverse,
                                  content_len=content, chunk=256, tile=1).numpy()
    first = slice(content - head, content) if reverse else slice(0, head)
    assert plain[:, first].tobytes() == seq[:, first].tobytes()


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_schedule_twin_per_series_lengths_matches_plain(rng, reverse):
    """The twin with one content length per series (0, 1, around the chunk
    edges of 16 and the tile edges of 64, and full), in one launch, equals
    biquad_onepass_plain given the same (S,) lengths bit for bit, writes
    every sample, and each series equals the scalar form at its length."""
    lens = np.array([0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 191, 199, 200], np.int32)
    x = _signals(rng, (len(lens), TWIN_SAMPLES))
    coeffs = _twin_coeffs(len(lens))
    plain = _twin_vs_plain(x, coeffs, reverse, lens)
    for s, n in enumerate(lens):
        one = pf.biquad_onepass_plain(torch.from_numpy(x[s:s + 1]),
                                      torch.from_numpy(coeffs[s:s + 1]), reverse=reverse,
                                      content_len=int(n), chunk=TWIN_CHUNK, tile=TWIN_LANES)
        assert plain[s].tobytes() == one[0].numpy().tobytes(), f"series {s}"


def test_chunk_transitions_are_powers_of_the_state_map():
    """P and Q are A^chunk and A^(chunk * tile) of the state map A =
    [[-a1, 1], [-a2, 0]] (numpy's float64 matrix power), and the twin
    computes them bit for bit alike."""
    coeffs = torch.from_numpy(_twin_coeffs(2))
    p, q = pf.chunk_transitions(coeffs, 16, 4)
    for s in range(2):
        a = np.array([[-coeffs[s, 3].item(), 1.0], [-coeffs[s, 4].item(), 0.0]])
        for got, power in ((p, 16), (q, 64)):
            want = np.linalg.matrix_power(a, power).reshape(-1)
            np.testing.assert_allclose([v[s].item() for v in got], want, rtol=1e-9, atol=1e-12)
        tp, tq = _twin_transitions(coeffs[s, 3].item(), coeffs[s, 4].item(), 16, 4)
        assert [v[s].item() for v in p] == tp and [v[s].item() for v in q] == tq
    with pytest.raises(ValueError, match="powers of two"):
        pf.chunk_transitions(coeffs, 24, 4)


# ---------------------------------------------------------------------------
# the chunked bank on long series, against the sequential float32 scans
# ---------------------------------------------------------------------------

LONG_SR, LONG_HIPASS, LONG_SAMPLES = 44100.0, 60.0, 65_536  # the vault's bank


def _bank_f64(x, passes):
    """The bank's passes in float64 (scipy lfilter on the float32
    coefficients), flips as filter_bank takes them."""
    out = x.astype(np.float64)
    flips = 0
    for coeffs, flip in passes:
        if flip:
            out = out[..., ::-1]
            flips += 1
        c = coeffs.astype(np.float32).astype(np.float64)
        out = np.stack([sps.lfilter(c[b, :3], [1.0, *c[b, 3:]], out[..., b, :], axis=-1)
                        for b in range(8)], axis=-2)
    return out[..., ::-1] if flips % 2 else out


def _bank_f32_sequential(x, passes):
    """The bank's passes as one sequential float32 chain per series, each
    multiply and add rounded on its own (numpy ufuncs do not contract): the
    port's arithmetic without the chunks, equal bit for bit to
    biquad_onepass_plain with a single chunk."""
    out = np.ascontiguousarray(x, np.float32)
    flips = 0
    for coeffs, flip in passes:
        if flip:
            out = np.ascontiguousarray(out[..., ::-1])
            flips += 1
        b0, b1, b2, a1, a2 = np.asarray(coeffs, np.float32).T
        z1 = np.zeros(out.shape[:-1], np.float32)
        z2 = np.zeros_like(z1)
        y = np.empty_like(out)
        for k in range(out.shape[-1]):
            xk = out[..., k]
            y[..., k] = o = xk * b0 + z1
            z1 = xk * b1 + z2 - a1 * o
            z2 = xk * b2 - a2 * o
        out = y
    return out[..., ::-1] if flips % 2 else out


_LONG = {}


def _long_bank():
    """The vault's Linkwitz-Riley bank (44.1 kHz, hipass 60 Hz) on 2 x 8 x
    65,536 samples (256 chunks and 8 tiles per series): the input, the
    port's chunked scan, the JAX scan and the float64 reference, computed
    once for the tests below."""
    if not _LONG:
        x = _signals(np.random.default_rng(7), (2, 8, LONG_SAMPLES))
        passes = pf._band_coeffs(PortFilter.LINKWITZ_RILEY, LONG_SR, LONG_HIPASS)
        _LONG.update(
            x=x, passes=passes, ref=_bank_f64(x, passes),
            port=pf.filter_bank(torch.from_numpy(x), LONG_SR, LONG_HIPASS,
                                PortFilter.LINKWITZ_RILEY,
                                method="scan").numpy().astype(np.float64),
            jax=np.asarray(jf.filter_bank(x, LONG_SR, LONG_HIPASS, JaxFilter.LINKWITZ_RILEY,
                                          method="scan"), np.float64))
    return _LONG


def _err_over_peak(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_filter_bank_scan_long_series_as_accurate_as_jax():
    """The port's chunked bank is within 1.25 x the JAX scan's own error
    from scipy's float64 lfilter, plus 1e-6 of peak, and agrees with the
    JAX scan to 1e-5 of peak. Readings on an x86-64 CPU: 4.33e-6 of peak for the
    port, 2.76e-6 for the JAX scan (1.57x), against a limit of 4.45e-6:
    the limit lies 2.9 % above the reading. The gap is not the chunks (the next test: the
    port's own sequential arithmetic reads 4.34e-6) but XLA's CPU scan,
    which fuses the step's multiply-adds and so rounds 5 times a sample
    where the port rounds 9 (test_jax_cpu_scan_fuses_multiply_adds). The
    limit rests on XLA's CPU rounding, which a JAX release may change."""
    d = _long_bank()
    err_port = _err_over_peak(d["port"], d["ref"])
    err_jax = _err_over_peak(d["jax"], d["ref"])
    assert err_port <= 1.25 * err_jax + 1e-6, (err_port, err_jax)
    _close(d["port"], d["jax"], 1e-5)


def test_filter_bank_scan_long_series_chunks_cost_no_accuracy():
    """The chunked bank's error from float64 lfilter is at most 1.05 x that
    of the same arithmetic run as one sequential chain per series: the
    chunks and the float64 carry cost no accuracy. Readings on an x86-64 CPU:
    4.327e-6 of peak chunked, 4.343e-6 sequential (0.996x), both on the
    lowest band; on the card at 16 x 524,288 the chunked kernel reads
    0.86x the sequential one (PERF.md)."""
    d = _long_bank()
    err_port = _err_over_peak(d["port"], d["ref"])
    err_seq = _err_over_peak(_bank_f32_sequential(d["x"], d["passes"]).astype(np.float64),
                             d["ref"])
    assert err_port <= 1.05 * err_seq, (err_port, err_seq)


def test_jax_cpu_scan_fuses_multiply_adds(rng):
    """Why the JAX scan is the more accurate on the CPU: XLA compiles its
    step with fused multiply-adds, out = fma(x, b0, z1), z1' = fma(-a1,
    out, fma(x, b1, z2)), z2' = fma(x, b2, -(a2 * out)), and equals that
    chain bit for bit; the port's step, each operation rounded on its own
    (the kernel is built with --fmad=false so that it equals its plain
    version), differs from it. The fused chain is emulated in float64,
    where a product of float32s is exact."""
    c = _lp_coeffs().astype(np.float32)
    x = _signals(rng, (16, 4096))
    want = np.asarray(jf.biquad_onepass(x, c))
    b0, b1, b2, a1, a2 = c.astype(np.float64)

    def r(v):
        return v.astype(np.float32).astype(np.float64)

    z1 = z2 = np.zeros(16)
    fused = np.empty(x.shape)
    for k in range(x.shape[1]):
        xk = x[:, k].astype(np.float64)
        fused[:, k] = o = r(xk * b0 + z1)
        z1, z2 = r(r(xk * b1 + z2) - a1 * o), r(xk * b2 - r(a2 * o))
    assert np.array_equal(fused.astype(np.float32), want)
    port = pf.biquad_onepass(torch.from_numpy(x), c).numpy()
    assert not np.array_equal(port, want)
