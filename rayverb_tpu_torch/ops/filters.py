"""The crossover filter bank's host-side coefficients (numpy), a subset of
rayverb_tpu/ops/filters.py: the biquad and Linkwitz-Riley coefficient
stacks and the FFT length the render's ``fft`` finalize uses.

Not ported yet: the windowed-sinc FIR bank and the sequential-scan and
FFT applicators of the modular pipeline.

Band edges: {lo_cutoff, 175, 350, 700, 1400, 2800, 5600, 11200, 20000}
(filters.cpp:295-305).
"""

from __future__ import annotations

import math

import numpy as np

from ..config.schema import FilterType
from ..constants import FILTER_EDGES_UPPER


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


def _fft_len(t: int, pad: int = 8192) -> int:
    n = t + pad
    return 1 << (n - 1).bit_length()


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


def _band_coeffs(filter_type: FilterType, sample_rate: float, lo_cutoff: float):
    """Host-side coefficient stacks: list of ((8, 5) array, flip_before)
    passes replaying the reference's per-band filter sequence."""
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
    if filter_type != FilterType.LINKWITZ_RILEY:
        raise NotImplementedError(
            f"the {filter_type.value} filter bank is not ported yet"
        )
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
