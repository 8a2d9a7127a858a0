"""HRTF gain tables: construction, interpolation, and synthesis (numpy copy
of rayverb_tpu/hrtf/table.py; the port imports nothing of that package).

The reference ships a generated C++ table `HRTF_DATA`
[channel][azimuth 360][elevation 180] of 8-band energy gains, produced by
hrtf_analysis/analyse_hrtf.py from the IRCAM Listen HRIR corpus:
  - each measured HRIR is FFT'd and reduced to mean |X|^2 per band, with
    band edges HRTF_BAND_EDGES (analyse_hrtf.py:138-154, :10)
  - the sparse measurement grid is bilinearly interpolated to a 1-degree
    grid with the bracketing rules of write_file (analyse_hrtf.py:41-101)

That corpus is not redistributable here, so the shipped default table is
*synthetic but physically motivated*: HRIR magnitude responses from the
Brown–Duda spherical-head shadow model (one-pole/one-zero, head radius
8.75 cm) sampled on the same 15-degree grid and pushed through the exact
same band-reduction + interpolation pipeline. Users with the IRCAM WAVs can
regenerate a measured table with `analyze_hrir_directory`.

The identifiable test table of generate_test_hrtf_data.py:4-15 is
reproduced by `test_table()` for the HRTF lookup tests.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache

import numpy as np

from ..constants import (
    HRTF_AZIMUTHS,
    HRTF_BAND_EDGES,
    HRTF_ELEVATIONS,
    NUM_BANDS,
    SPEED_OF_SOUND,
)

TABLE_SHAPE = (2, HRTF_AZIMUTHS, HRTF_ELEVATIONS, NUM_BANDS)


# ---------------------------------------------------------------------------
# interpolation (write_file semantics, analyse_hrtf.py:41-101)
# ---------------------------------------------------------------------------

def interpolate_measurements(entries) -> np.ndarray:
    """Bilinear interpolation of sparse (azimuth, elevation) measurements to
    the dense (2, 360, 180, 8) table.

    ``entries`` is a list of ((a, e), left8, right8) with integer grid
    coordinates: a in [0, 360], e in [0, 180]. Bracketing matches the
    reference exactly: candidate neighbours default to a in {0, 360} and
    e in {0, 180}; missing (a, e) pairs read as zeros (get_entry,
    analyse_hrtf.py:36-41); a == 360 wraps to 0.
    """
    # get_entry matches the RAW stored azimuth against the query a % 360
    # (analyse_hrtf.py:36-41): entries at a == 360 are unreachable, and the
    # first matching entry wins — hence raw-indexed, first-write-wins fill.
    dense = np.zeros((361, 181, 2, NUM_BANDS), dtype=np.float64)
    filled = np.zeros((361, 181), dtype=bool)
    for (a, e), left, right in entries:
        if not filled[a, e]:
            dense[a, e, 0] = left
            dense[a, e, 1] = right
            filled[a, e] = True

    a_set = np.zeros(361, dtype=bool)
    e_set = np.zeros(181, dtype=bool)
    for (a, e), _, _ in entries:
        a_set[a] = True
        e_set[e] = True
    a_measured = np.nonzero(a_set)[0]
    e_measured = np.nonzero(e_set)[0]

    def brackets(q, measured, top):
        """(min, max) per query: min = largest measured <= q (else 0),
        max = smallest measured > q (else top)."""
        lo = np.zeros_like(q)
        hi = np.full_like(q, top)
        if measured.size:
            i = np.searchsorted(measured, q, side="right")
            has_lo = i > 0
            lo = np.where(has_lo, measured[np.clip(i - 1, 0, None)], 0)
            has_hi = i < measured.size
            hi = np.where(has_hi, measured[np.clip(i, None, measured.size - 1)], top)
        return lo, hi

    aq = np.arange(HRTF_AZIMUTHS)
    eq = np.arange(HRTF_ELEVATIONS)
    a_min, a_max = brackets(aq, a_measured, 360)
    e_min, e_max = brackets(eq, e_measured, 180)

    a_ratio = (aq - a_min) / (a_max - a_min).astype(np.float64)
    e_ratio = (eq - e_min) / (e_max - e_min).astype(np.float64)

    am = a_min[:, None]
    ax = a_max[:, None] % 360
    em = e_min[None, :]
    ex = e_max[None, :]
    c00 = dense[am, em]  # (360, 180, 2, 8)
    c10 = dense[ax, em]
    c01 = dense[am, ex]
    c11 = dense[ax, ex]
    ar = a_ratio[:, None, None, None]
    er = e_ratio[None, :, None, None]
    a0 = c00 + (c10 - c00) * ar
    a1 = c01 + (c11 - c01) * ar
    out = a0 + (a1 - a0) * er  # (360, 180, 2, 8)
    return np.ascontiguousarray(out.transpose(2, 0, 1, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# band reduction (analyse_hrtf.py:138-154)
# ---------------------------------------------------------------------------

def band_energies(signal: np.ndarray, sample_rate: float) -> np.ndarray:
    """Mean power of the rFFT per HRTF band — the reference's reduction of
    an HRIR to 8 gains (bin boundaries i * nframes / sr, integer division
    like the Python-2 original)."""
    n = signal.shape[-1]
    fft = np.fft.rfft(signal, axis=-1)
    power = np.abs(fft) ** 2
    bounds = [int(f * n // sample_rate) for f in HRTF_BAND_EDGES]
    out = np.zeros(signal.shape[:-1] + (NUM_BANDS,), dtype=np.float64)
    for b in range(NUM_BANDS):
        lo, hi = bounds[b], bounds[b + 1]
        if hi > lo:
            out[..., b] = power[..., lo:hi].mean(axis=-1)
    return out


# ---------------------------------------------------------------------------
# synthetic measurement model (Brown–Duda spherical head)
# ---------------------------------------------------------------------------

HEAD_RADIUS = 0.0875  # metres
_THETA_MIN = 150.0    # degrees; angle of deepest shadow
_ALPHA_MIN = 0.1


def _head_shadow_power(freqs: np.ndarray, theta_deg: np.ndarray) -> np.ndarray:
    """|H|^2 of the Brown–Duda one-pole/one-zero head-shadow filter.

    H(s) = (1 + alpha(theta) s / (2 w0)) / (1 + s / (2 w0)),
    w0 = c / a, alpha sweeping 2 (ear side) -> ALPHA_MIN (far side).
    theta is the angle between the arrival direction and the ear axis.
    """
    w0 = SPEED_OF_SOUND / HEAD_RADIUS
    alpha = (1 + _ALPHA_MIN / 2.0) + (1 - _ALPHA_MIN / 2.0) * np.cos(
        np.radians(theta_deg) * (180.0 / _THETA_MIN)
    )
    w = 2 * np.pi * freqs
    num = 1 + (alpha[..., None] * w / (2 * w0)) ** 2
    den = 1 + (w / (2 * w0)) ** 2
    return num / den


def synthetic_measurements(step: int = 15, n: int = 512, sample_rate: float = 44100.0):
    """Synthesise band gains on the reference's 15-degree measurement grid.

    Grid coordinates are *table* coordinates: a = azimuth index (0 at the
    back, 180 = straight ahead), e = 90 - elevation. For table entry (a, e)
    the arrival direction in head coordinates is
        phi = a - 180 (azimuth from +z facing), th = 90 - e,
        d = (sin phi cos th, sin th, cos phi cos th),
    matching the lookup in kernel.cpp:563-584. Channel 0's ear sits at -x.
    """
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    entries = []
    for a in range(0, 361, step):
        for e in range(0, 181, step):
            phi = np.radians(a - 180.0)
            th = np.radians(90.0 - e)
            d = np.array(
                [np.sin(phi) * np.cos(th), np.sin(th), np.cos(phi) * np.cos(th)]
            )
            gains = []
            for ear_x in (-1.0, 1.0):  # channel 0 = -x ear (kernel.cpp:602)
                cos_inc = np.clip(d @ np.array([ear_x, 0.0, 0.0]), -1, 1)
                theta = np.degrees(np.arccos(cos_inc))
                power = _head_shadow_power(freqs, np.asarray(theta))
                # reuse the band reduction on the magnitude response directly
                bounds = [int(f * n // sample_rate) for f in HRTF_BAND_EDGES]
                g = np.zeros(NUM_BANDS)
                for b in range(NUM_BANDS):
                    lo, hi = bounds[b], bounds[b + 1]
                    if hi > lo:
                        g[b] = power[lo:hi].mean()
                gains.append(g)
            entries.append(((a, e), gains[0], gains[1]))
    return entries


@lru_cache(maxsize=1)
def default_table() -> np.ndarray:
    """The default (2, 360, 180, 8) table: the synthetic model, built on
    first use (~0.2 s) and cached. It equals the JAX package's shipped
    hrtf_table.npz bit for bit, so no binary table is shipped here."""
    table = interpolate_measurements(synthetic_measurements())
    table.flags.writeable = False  # one cached array is shared by callers
    return table


@lru_cache(maxsize=1)
def test_table() -> np.ndarray:
    """The identifiable fixture table: value (azimuth, elevation, 0, ...)
    every 15 degrees, interpolated — generate_test_hrtf_data.py:4-15."""
    entries = []
    for a in range(0, 361, 15):
        for e in range(0, 181, 15):
            v = np.array([a, e, 0, 0, 0, 0, 0, 0], dtype=np.float64)
            entries.append(((a, e), v, v))
    table = interpolate_measurements(entries)
    table.flags.writeable = False
    return table


# ---------------------------------------------------------------------------
# measured-corpus analysis (component 9 parity for users with IRCAM data)
# ---------------------------------------------------------------------------

_IRCAM_RE = re.compile(r"^(.+)_(.+)_(.+)_R(\d+)_T(\d+)_P(\d+)$")


def decode_ircam_filename(fname: str):
    """IRCAM Listen filename -> (radius, azimuth, elevation)
    (analyse_hrtf.py:12-26)."""
    stem = os.path.splitext(os.path.basename(fname))[0]
    parts = stem.split("_")
    if len(parts) != 6:
        raise ValueError("Filename isn't in the IRCAM Listen filename format")
    return int(parts[3][1:]), int(parts[4][1:]), int(parts[5][1:])


def analyze_hrir_directory(folder: str) -> np.ndarray:
    """Re-implementation of analyse_hrtf.main: stereo HRIR WAVs ->
    (2, 360, 180, 8) table (elevation remapped e = (90 + 360 - el) % 360,
    analyse_hrtf.py:129)."""
    from ..io.audio import read_audio

    entries = []
    for fname in sorted(os.listdir(folder)):
        path = os.path.join(folder, fname)
        if not os.path.isfile(path):
            continue
        _, azimuth, elevation = decode_ircam_filename(fname)
        elevation = (90 + 360 - elevation) % 360
        channels, sr, _ = read_audio(path)
        if channels.shape[0] != 2:
            raise ValueError(f"{fname}: expected stereo HRIR")
        gains = band_energies(channels, sr)
        entries.append(((azimuth, elevation), gains[0], gains[1]))
    return interpolate_measurements(entries)
