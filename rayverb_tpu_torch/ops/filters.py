"""The multiband crossover filter bank (PyTorch counterpart of
rayverb_tpu/ops/filters.py).

The four reference filters (rayverb/filters.{h,cpp}):

  - windowed-sinc FIR  -> torch.fft convolution (FastConvolution parity:
    output grows by KERNEL_LENGTH - 1 samples, filters.cpp:96-154)
  - biquad one-pass    -> direct form II transposed scan (filters.cpp:156-168)
  - biquad two-pass    -> forward + reverse scans (filters.cpp:185-191)
  - Linkwitz-Riley     -> zero-phase 4th-order LP+HP from twice-applied
    2nd-order butterworth sections (filters.cpp:230-266)

The scan is the hand-written CUDA kernel biquad_scan (ops/biquad_cuda.py,
csrc/biquad_scan.cu), a chunked parallel recurrence, for a CUDA tensor and
its plain version, ``biquad_onepass_plain``, which repeats its schedule,
for a CPU tensor; ``biquad_onepass`` is the only route to either. Each IIR
filter also has the FFT-domain path (``method='fft'``): the transfer
function on the rFFT grid, applied with zero padding and truncated to the
input length.

Tensors stay on their device; array input goes to the card
(device.resolve_device). A device failure raises: there is no fallback to
the host.

Band edges: {lo_cutoff, 175, 350, 700, 1400, 2800, 5600, 11200, 20000}
(filters.cpp:295-305).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config.schema import FilterType
from ..constants import FILTER_EDGES_UPPER
from ..device import resolve_device
from ..utils import profiling

KERNEL_LENGTH = 29  # filters.h:123,139


def _f32(x, device=None):
    """float32 tensor: a tensor keeps its device, anything else goes to
    ``device`` (None: the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


# ---------------------------------------------------------------------------
# windowed-sinc kernels (host-side construction, filters.cpp:9-81)
# ---------------------------------------------------------------------------

def sinc_kernel(cutoff_ratio: float, length: int) -> np.ndarray:
    """Un-windowed lowpass sinc kernel (filters.cpp:17-33)."""
    if length % 2 == 0:
        raise ValueError("Length of sinc filter kernel must be odd.")
    i = np.arange(length, dtype=np.float64)
    center = (length - 1) / 2.0
    x = 2 * cutoff_ratio * (i - center)
    with np.errstate(invalid="ignore"):
        k = np.sin(np.pi * x) / (np.pi * x)
    k[int(center)] = 1.0
    return k


def blackman(length: int) -> np.ndarray:
    """Exact blackman coefficients (filters.cpp:35-54)."""
    a0, a1, a2 = 7938.0 / 18608.0, 9240.0 / 18608.0, 1430.0 / 18608.0
    off = np.arange(length, dtype=np.float64) / (length - 1.0)
    return a0 - a1 * np.cos(2 * np.pi * off) + a2 * np.cos(4 * np.pi * off)


def lopass_kernel(sr: float, cutoff: float, length: int) -> np.ndarray:
    """Windowed, max-normalised lowpass kernel (filters.cpp:56-71)."""
    k = blackman(length) * sinc_kernel(cutoff / sr, length)
    return (k / np.max(np.abs(k))).astype(np.float32)


def hipass_kernel(sr: float, cutoff: float, length: int) -> np.ndarray:
    """Spectral inversion of the lowpass (filters.cpp:73-81)."""
    k = -lopass_kernel(sr, cutoff, length).astype(np.float64)
    k[(length - 1) // 2] += 1
    return k.astype(np.float32)


def bandpass_sinc_kernel(sr: float, lo: float, hi: float) -> np.ndarray:
    """Bandpass = lowpass(hi) (*) hipass(lo), each of length 1 + 29//2
    (BandpassWindowedSinc::bandpassKernel, filters.cpp:126-137)."""
    half = 1 + KERNEL_LENGTH // 2
    lop = lopass_kernel(sr, hi, half).astype(np.float64)
    hip = hipass_kernel(sr, lo, half).astype(np.float64)
    return np.convolve(lop, hip)[:KERNEL_LENGTH].astype(np.float32)


def fir_filter(data, kernel):
    """Full linear convolution via FFT (FastConvolution semantics: output
    length = len(data) + len(kernel) - 1, the 14-sample sinc delay is NOT
    compensated, filters.cpp:104-107). data: (..., T)."""
    data = _f32(data)
    kernel = _f32(kernel, data.device).to(data.device)
    out_len = data.shape[-1] + kernel.shape[-1] - 1
    d = torch.fft.rfft(data, n=out_len)
    k = torch.fft.rfft(kernel, n=out_len)
    return torch.fft.irfft(d * k, n=out_len).to(torch.float32)[..., :out_len]


# ---------------------------------------------------------------------------
# biquad coefficients (filters.cpp:193-266)
# ---------------------------------------------------------------------------

def bandpass_biquad_coeffs(lo: float, hi: float, sr: float):
    """RBJ cookbook constant-skirt bandpass (filters.cpp:193-218)."""
    c = math.sqrt(lo * hi)
    omega = 2 * math.pi * c / sr
    cs = math.cos(omega)
    sn = math.sin(omega)
    bandwidth = math.log2(hi / lo)
    q = sn / (math.log(2) * bandwidth * omega)
    alpha = sn * math.sinh(1 / (2 * q))
    a0 = 1 + alpha
    nrm = 1 / a0
    return (
        nrm * alpha,        # b0
        0.0,                # b1
        nrm * -alpha,       # b2
        nrm * (-2 * cs),    # a1
        nrm * (1 - alpha),  # a2
    )


def _get_c(co: float, sr: float) -> float:
    wct = math.pi * co / sr
    return math.cos(wct) / math.sin(wct)


def linkwitz_riley_coeffs(lo: float, hi: float, sr: float):
    """2nd-order butterworth LP(hi) and HP(lo) sections; each is applied
    twice forward-backward for 4th-order zero-phase (filters.cpp:236-266)."""
    c = _get_c(hi, sr)
    a0 = c * c + c * math.sqrt(2) + 1
    lopass = (
        1 / a0,
        2 / a0,
        1 / a0,
        (-2 * (c * c - 1)) / a0,
        (c * c - c * math.sqrt(2) + 1) / a0,
    )
    c = _get_c(lo, sr)
    a0 = c * c + c * math.sqrt(2) + 1
    hipass = (
        (c * c) / a0,
        (-2 * c * c) / a0,
        (c * c) / a0,
        (-2 * (c * c - 1)) / a0,
        (c * c - c * math.sqrt(2) + 1) / a0,
    )
    return lopass, hipass


# ---------------------------------------------------------------------------
# biquad application
# ---------------------------------------------------------------------------

# the biquad_scan kernel's schedule (csrc/biquad_scan.cu's kChunk and
# kLanes): samples per chunk (one warp lane each) and chunks per tile (one
# warp, one thread block); both powers of two
CHUNK = 256
TILE = 32


def _content_lengths(content_len, t: int):
    """A biquad pass's content lengths: an int (every series), or None for
    t, or a tensor of per-series lengths, each in [0, t]."""
    if isinstance(content_len, torch.Tensor):
        lens = content_len.reshape(-1).to(torch.int64)
        if lens.numel():
            lo, hi = (int(v) for v in torch.aminmax(lens))
            if not (0 <= lo and hi <= t):
                raise ValueError(f"content lengths must lie in [0, {t}], got [{lo}, {hi}]")
        return lens
    n = t if content_len is None else int(content_len)
    if not 0 <= n <= t:
        raise ValueError(f"content_len must lie in [0, {t}], got {n}")
    return n


def chunk_transitions(coeffs, chunk: int = CHUNK, tile: int = TILE):
    """The zero-input transitions of the chunked scan, per series: P =
    A**chunk and Q = A**(chunk * tile) for A = [[-a1, 1], [-a2, 0]], the
    map of the state (z1, z2) over one sample. Float64 repeated squaring of
    the float32 a1 and a2, each multiply and add rounded on its own, in the
    order of the kernel's transitions(). coeffs (S, 5) -> (P, Q), each a
    list [m00, m01, m10, m11] of (S,) float64 tensors."""
    if chunk < 1 or tile < 1 or chunk & (chunk - 1) or tile & (tile - 1):
        raise ValueError(f"chunk and tile must be powers of two, got {chunk}, {tile}")
    a1 = coeffs[:, 3].to(torch.float64)
    a2 = coeffs[:, 4].to(torch.float64)
    m = [-a1, torch.ones_like(a1), -a2, torch.zeros_like(a1)]

    def square(m):
        m00, m01, m10, m11 = m
        return [m00 * m00 + m01 * m10, m00 * m01 + m01 * m11,
                m10 * m00 + m11 * m10, m10 * m01 + m11 * m11]

    for _ in range(chunk.bit_length() - 1):
        m = square(m)
    p = m
    for _ in range(tile.bit_length() - 1):
        m = square(m)
    return p, m


def _carry(m, z1, z2, e1, e2):
    """One carry step of the chunked scan in float64, M (z1, z2) + (e1,
    e2), each multiply and add rounded on its own (the kernel's carry())."""
    return m[0] * z1 + m[1] * z2 + e1, m[2] * z1 + m[3] * z2 + e2


def biquad_onepass_plain(data, coeffs, *, reverse: bool = False, content_len=None,
                         chunk: int = CHUNK, tile: int = TILE):
    """The plain PyTorch version of the biquad_scan kernel: (S, T) float32
    series, (S, 5) float32 coefficients [b0, b1, b2, a1, a2] per series.
    Direct form II transposed from zero state (Biquad::onepass,
    filters.cpp:156-168), one step per sample,

        out = x*b0 + z1;  z1' = (x*b1 + z2) - a1*out;  z2' = x*b2 - a2*out

    each multiply and add rounded on its own, over the samples [0, n) (a
    reverse pass: from n - 1 down to 0), n = content_len; samples at and
    after n are +0. content_len None means T; an (S,) tensor gives each
    series its own length.

    The pass runs as the kernel's chunked recurrence, which this function
    repeats operation for operation, vectorised over series and chunks.
    The pass-order samples are cut into chunks of ``chunk`` samples,
    counted from the pass's first sample, and the chunks into tiles of
    ``tile``. (A) Each chunk runs from zero state to its end state e_c.
    (B) The carry, in float64: a tile's aggregate E_j is the chain T <- P T
    + e_c over its chunks from 0; a tile's start is the chain S <- Q S +
    E_i from 0 over the tiles before it; a chunk's start is the chain U <-
    P U + e_c from its tile's start over the chunks before it in the tile
    (P and Q from chunk_transitions, each step _carry). (C) Each chunk
    runs again from its start, rounded to float32, and writes its outputs.
    Chunk 0 is the sequential pass. (A float32 carry would cost accuracy:
    the entries of P for the lowest band's poles are ~100x the state they
    carry, so their products cancel.)"""
    s, t = data.shape
    n = _content_lengths(content_len, t)
    dev = data.device
    if s == 0 or t == 0:
        return torch.zeros_like(data)
    lens = (n.to(dev) if isinstance(n, torch.Tensor)
            else torch.full((s,), n, dtype=torch.int64, device=dev))
    tiles = -(-t // (chunk * tile))
    nchunks = tiles * tile
    # each (chunk, step)'s pass-order position, and the sample it reads
    # (column t, a zero pad, where it lies past the series' length)
    pos = torch.arange(nchunks * chunk, device=dev).view(nchunks, chunk)
    valid = pos[None] < lens[:, None, None]  # (S, C, L)
    phys = lens[:, None, None] - 1 - pos[None] if reverse else pos[None].expand(s, -1, -1)
    phys = torch.where(valid, phys, t).reshape(s, -1)
    xs = torch.gather(torch.nn.functional.pad(data, (0, 1)), 1, phys)
    xs = xs.view(s, nchunks, chunk).permute(2, 0, 1).contiguous()  # (L, S, C)
    on = valid.permute(2, 0, 1).contiguous()
    b0, b1, b2, a1, a2 = (v[:, None] for v in coeffs.T.contiguous())

    def run(z1, z2, out=None):
        # a chunk's steps past the series' length leave its state as it is
        for k in range(chunk):
            x = xs[k]
            y = x * b0 + z1
            z1 = torch.where(on[k], x * b1 + z2 - a1 * y, z1)
            z2 = torch.where(on[k], x * b2 - a2 * y, z2)
            if out is not None:
                out[k] = y
        return z1, z2

    zero = torch.zeros((s, nchunks), dtype=torch.float32, device=dev)
    e1, e2 = (v.view(s, tiles, tile).to(torch.float64) for v in run(zero, zero))
    p, q = chunk_transitions(coeffs, chunk, tile)
    pc = [v[:, None] for v in p]
    agg1 = agg2 = torch.zeros((s, tiles), dtype=torch.float64, device=dev)
    for i in range(tile):
        agg1, agg2 = _carry(pc, agg1, agg2, e1[:, :, i], e2[:, :, i])
    u1, u2 = torch.empty_like(e1), torch.empty_like(e2)
    c1 = c2 = torch.zeros((s,), dtype=torch.float64, device=dev)
    for j in range(tiles):
        u1[:, j, 0], u2[:, j, 0] = c1, c2
        c1, c2 = _carry(q, c1, c2, agg1[:, j], agg2[:, j])
    c1, c2 = u1[:, :, 0].clone(), u2[:, :, 0].clone()
    for i in range(tile - 1):
        c1, c2 = _carry(pc, c1, c2, e1[:, :, i], e2[:, :, i])
        u1[:, :, i + 1], u2[:, :, i + 1] = c1, c2
    ys = torch.empty_like(xs)
    run(u1.view(s, nchunks).to(torch.float32), u2.view(s, nchunks).to(torch.float32), ys)
    ys = torch.where(on, ys, 0.0).permute(1, 2, 0).reshape(s, -1)
    out = torch.zeros((s, t + 1), dtype=torch.float32, device=dev)
    return out.scatter_(1, phys, ys)[:, :t].contiguous()


def biquad_onepass(data, coeffs, *, reverse: bool = False, content_len=None):
    """Direct-form II transposed scan (Biquad::onepass, filters.cpp:156-168;
    rayverb_tpu/ops/filters.py::biquad_onepass, :157). data: (..., T);
    coeffs: (5,) [b0, b1, b2, a1, a2], or (..., 5) broadcastable to data's
    leading dims (one set per series). Coefficients are cast to float32, as
    the JAX function casts them; the state is float32.

    reverse=True runs back to front over the unflipped signal (the JAX
    lax.scan(reverse=True)). content_len: samples at and after it are
    written as 0 and a reverse pass starts at content_len - 1 (the fused
    finalize's per-pass mask); None means T. A tensor broadcastable to
    data's leading dims gives each series its own length (the batched
    finalize's per-pair content lengths), so one launch covers them all.

    A CUDA tensor goes to the biquad_scan kernel (ops/biquad_cuda.py), a CPU
    tensor to biquad_onepass_plain; there is no other route."""
    data = _f32(data)
    coeffs = _f32(coeffs, data.device).to(data.device)
    shape = data.shape
    t = shape[-1]
    x = data.reshape(-1, t).contiguous()
    c = torch.broadcast_to(coeffs, shape[:-1] + (5,)).reshape(-1, 5).contiguous()
    if isinstance(content_len, torch.Tensor):
        content_len = torch.broadcast_to(
            content_len.to(device=data.device, dtype=torch.int32), shape[:-1]
        ).reshape(-1).contiguous()
    if x.is_cuda:
        from .biquad_cuda import biquad_scan_cuda

        out = biquad_scan_cuda(x, c, reverse=reverse, content_len=content_len)
    else:
        out = biquad_onepass_plain(x, c, reverse=reverse, content_len=content_len)
    return out.reshape(shape)


def biquad_twopass(data, coeffs):
    """Forward-backward (zero phase) (Biquad::twopass, filters.cpp:185-191)."""
    return biquad_onepass(biquad_onepass(data, coeffs), coeffs, reverse=True)


def _biquad_response(coeffs, nfft: int):
    """H(e^{jw}) of a biquad on the rFFT grid (float64 on host)."""
    b0, b1, b2, a1, a2 = [float(c) for c in coeffs]
    w = np.exp(-2j * np.pi * np.arange(nfft // 2 + 1) / nfft)
    num = b0 + b1 * w + b2 * w * w
    den = 1.0 + a1 * w + a2 * w * w
    return num / den


def _fft_len(t: int, pad: int = 8192) -> int:
    n = t + pad
    return 1 << (n - 1).bit_length()


def fft_biquad_onepass(data, coeffs):
    """One causal biquad pass as FFT convolution, truncated to the input
    length (zero initial conditions == zero-extended input; the response
    beyond the zero padding has decayed below float32 noise)."""
    data = _f32(data)
    t = data.shape[-1]
    nfft = _fft_len(t)
    h = torch.from_numpy(_biquad_response(coeffs, nfft).astype(np.complex64)).to(data.device)
    out = torch.fft.irfft(torch.fft.rfft(data, n=nfft) * h, n=nfft)
    return out[..., :t].to(torch.float32)


def fft_biquad_twopass(data, coeffs):
    """Forward-backward with the same inter-pass truncation as the scan
    path (Biquad::twopass parity, filters.cpp:185-191)."""
    out = fft_biquad_onepass(data, coeffs)
    out = torch.flip(out, dims=(-1,))
    out = fft_biquad_onepass(out, coeffs)
    return torch.flip(out, dims=(-1,))


# ---------------------------------------------------------------------------
# the public bank (RayverbFiltering::filter, filters.cpp:268-306)
# ---------------------------------------------------------------------------

def band_edges(lo_cutoff: float, sample_rate: float | None = None):
    """Crossover edges {lo_cutoff, 175, ..., 20000} (filters.cpp:297-298),
    clamped below Nyquist and kept strictly increasing when a sample rate
    is given (the JAX package's documented deviation)."""
    edges = [float(lo_cutoff)] + list(FILTER_EDGES_UPPER)
    if sample_rate is not None:
        cap = 0.49 * float(sample_rate)
        edges = [min(e, cap) for e in edges]
        for i in range(len(edges) - 1, 0, -1):
            if edges[i] <= edges[i - 1]:
                edges[i - 1] = edges[i] / 1.2
    return tuple(edges)


def _bank_scan_onepass(data, coeffs):
    """data (..., 8, T), coeffs (8, 5): per-band causal biquads, every
    band and channel in one scan."""
    return biquad_onepass(data, coeffs)


def _scan_onepass_multi(data, coeff_stack, content_len=None):
    """Apply a sequence of (8, 5) coefficient sets, with optional
    time-reversal between passes encoded as (coeffs, flip) pairs. A pass
    whose cumulative flip parity is odd runs as a reverse scan on the
    unflipped signal (the same bits as flip, scan, flip back), so the
    output keeps the input's time order. content_len: biquad_onepass's
    per-pass mask (an int, or per-series lengths).

    Each pass adds the samples it is given, series x content length
    (summed over per-series lengths), to the counter
    biquad.series_samples, whatever runs the pass."""
    out = _f32(data)
    samples = _series_samples(out, content_len) if profiling.counting() else 0
    reverse = False
    for coeffs, do_flip in coeff_stack:
        reverse ^= bool(do_flip)
        out = biquad_onepass(out, coeffs, reverse=reverse, content_len=content_len)
        profiling.count("biquad.series_samples", samples)
    return out


def _series_samples(data, content_len) -> int:
    """The samples of (..., T) series that one pass of _scan_onepass_multi
    filters: series x content length, or the sum of per-series lengths
    (broadcast to the leading dims; read from the device)."""
    t = data.shape[-1]
    series = data.numel() // t if t else 0
    if isinstance(content_len, torch.Tensor):
        lens = torch.broadcast_to(content_len.to(data.device), data.shape[:-1])
        return int(lens.sum())
    return series * (t if content_len is None else int(content_len))


def _bank_fft_passes(data, responses, flips: tuple, nfft: int):
    """data (..., 8, T); responses (P, 8, nfft//2+1) complex64 on data's
    device; flips: flip time order before pass p. Each pass convolves band
    b with responses[p, b] and truncates to T."""
    out = _f32(data)
    t = out.shape[-1]
    nflips = 0
    for p, do_flip in enumerate(flips):
        if do_flip:
            out = torch.flip(out, dims=(-1,))
            nflips += 1
        spec = torch.fft.rfft(out, n=nfft)
        out = torch.fft.irfft(spec * responses[p], n=nfft)[..., :t]
    if nflips % 2:
        out = torch.flip(out, dims=(-1,))
    return out.to(torch.float32)


def _fir_bank(data, kernels):
    """data (..., 8, T), kernels (8, K) -> full convolution per band."""
    data = _f32(data)
    k = _f32(kernels, data.device).to(data.device)
    out_len = data.shape[-1] + k.shape[-1] - 1
    spec = torch.fft.rfft(data, n=out_len)
    kspec = torch.fft.rfft(k, n=out_len)
    return torch.fft.irfft(spec * kspec, n=out_len).to(torch.float32)


def _band_coeffs(filter_type: FilterType, sample_rate: float, lo_cutoff: float):
    """Host-side coefficient stacks: list of ((8, 5) array, flip_before)
    passes replaying the reference's per-band filter sequence. The
    windowed-sinc filter, which has no IIR passes, gets the Linkwitz-Riley
    stacks, as in the JAX function."""
    edges = band_edges(lo_cutoff, sample_rate)
    per_band = [(edges[i], edges[i + 1]) for i in range(8)]
    if filter_type in (FilterType.BIQUAD_ONEPASS, FilterType.BIQUAD_TWOPASS):
        c = np.array(
            [bandpass_biquad_coeffs(lo, hi, sample_rate) for lo, hi in per_band],
            dtype=np.float64,
        )
        if filter_type == FilterType.BIQUAD_ONEPASS:
            return [(c, False)]
        return [(c, False), (c, True)]  # forward then reversed
    lp = np.array(
        [linkwitz_riley_coeffs(lo, hi, sample_rate)[0] for lo, hi in per_band],
        dtype=np.float64,
    )
    hp = np.array(
        [linkwitz_riley_coeffs(lo, hi, sample_rate)[1] for lo, hi in per_band],
        dtype=np.float64,
    )
    # lopass.twopass then hipass.twopass (filters.cpp:262-266)
    return [(lp, False), (lp, True), (hp, True), (hp, True)]


def sinc_bank_kernels(sample_rate: float, lo_cutoff: float) -> np.ndarray:
    """(8, KERNEL_LENGTH) float32 bandpass kernels of the windowed-sinc
    bank."""
    edges = band_edges(lo_cutoff, sample_rate)
    return np.stack(
        [bandpass_sinc_kernel(sample_rate, edges[i], edges[i + 1]) for i in range(8)]
    )


def filter_bank(
    data,
    sample_rate: float,
    lo_cutoff: float,
    filter_type: FilterType,
    *,
    method: str = "scan",
):
    """Filter (..., 8, T) band signals on data's device in place of the
    reference's per-channel loop. Returns (..., 8, T'): T' = T + 28 for the
    sinc filter (FastConvolution growth), T otherwise.

    method: 'scan' (the causal time-domain recurrence, as the biquad_scan
    kernel's chunked scan on the card and biquad_onepass_plain on the CPU)
    or 'fft' (each causal pass as a truncated FFT convolution)."""
    data = _f32(data)
    if filter_type == FilterType.WINDOWED_SINC:
        return _fir_bank(data, sinc_bank_kernels(sample_rate, lo_cutoff))
    if method not in ("scan", "fft"):
        raise ValueError(f"method must be 'scan' or 'fft', not {method!r}")
    passes = _band_coeffs(filter_type, sample_rate, lo_cutoff)
    if method == "fft":
        nfft = _fft_len(data.shape[-1])
        responses = np.stack(
            [
                np.stack([_biquad_response(c, nfft).astype(np.complex64) for c in coeffs])
                for coeffs, _ in passes
            ]
        )
        flips = tuple(bool(f) for _, f in passes)
        return _bank_fft_passes(data, torch.from_numpy(responses).to(data.device),
                                flips, nfft)
    return _scan_onepass_multi(data, passes)
