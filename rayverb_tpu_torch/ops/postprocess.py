"""Post-processing: mixdown, normalise, scale, trim, predelay removal
(PyTorch counterpart of rayverb_tpu/ops/postprocess.py).

Mirrors the reference pipeline step by step:
  - mixdown: sum of the 8 band signals        (rayverb.cpp:80-92)
  - normalize: divide by global max amplitude (generic_functions.h:56-62)
  - volume scale                              (cmd/main.cpp:334, mul)
  - trimTail: cut below amplitude 1e-5        (rayverb.cpp:96-122)
  - find/fixPredelay on attenuated impulses   (rayverb.h:49-97)
  - process(): the composition               (rayverb.cpp:125-149)
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.schema import FilterType
from ..constants import TRIM_TAIL_FLOOR
from ..utils import profiling
from .filters import filter_bank


def mixdown(band_signals):
    """(..., 8, T) -> (..., T) band sum (rayverb.cpp:80-92). Stays on the
    input's side of the host/device boundary (numpy or tensor)."""
    if isinstance(band_signals, np.ndarray):
        return band_signals.sum(axis=-2)
    return torch.sum(band_signals, dim=-2)


def normalize(channels):
    """Divide all channels by the global max |amplitude|
    (generic_functions.h:56-62). Zero signals pass through unchanged."""
    if isinstance(channels, np.ndarray):
        peak = np.max(np.abs(channels))
        return channels * (1.0 / peak if peak > 0 else 1.0)
    peak = torch.amax(torch.abs(channels))
    return channels * torch.where(peak > 0, 1.0 / peak, 1.0)


def trim_tail_length(channels, min_vol: float = TRIM_TAIL_FLOOR) -> int:
    """Reference trimTail length (rayverb.cpp:96-122), including its
    off-by-one: the kept length is the *index* of the last sample with
    |x| >= min_vol (that sample itself is dropped); 0 when nothing
    qualifies. ``channels``: (C, T) numpy."""
    x = np.abs(np.asarray(channels))
    length = 0
    for ch in x:
        loud = np.nonzero(ch >= min_vol)[0]
        contribution = int(loud[-1]) if loud.size else -1
        length = max(length, contribution)
    return max(0, length)


def trim_tail(channels, min_vol: float = TRIM_TAIL_FLOOR):
    n = trim_tail_length(channels, min_vol)
    return np.asarray(channels)[..., :n]


def find_predelay(times) -> float:
    """Earliest non-zero impulse time; zeros mean 'no impulse'
    (findPredelay, rayverb.h:49-73). The reduction runs on the tensor's
    device; only the scalar is pulled (the wait: rv.sync site
    predelay)."""
    if times.numel() == 0:
        return 0.0
    with profiling.span("rv.sync", site="predelay"):
        m = float(torch.amin(torch.where(times > 0, times, float("inf"))))
    return 0.0 if m == float("inf") else m


def fix_predelay(times, predelay: float | None = None):
    """Subtract the predelay, clamping at zero (fixPredelay,
    rayverb.h:77-97)."""
    if predelay is None:
        predelay = find_predelay(times)
    p = np.float32(predelay)
    return torch.where(times > p, times - p, 0.0)


def process(
    band_signals,
    sample_rate: float,
    *,
    filter_type: FilterType,
    lo_cutoff: float,
    do_normalize: bool,
    volume_scale: float = 1.0,
    do_trim_tail: bool = True,
    filter_method: str = "scan",
) -> np.ndarray:
    """The reference `process` (rayverb.cpp:125-149): filter each channel's
    8 bands, mix down, then optional normalise / scale / tail trim.

    band_signals: (C, 8, T) tensor, filtered on its device. Returns (C, T')
    numpy float32. Its stages are the phases rv.filter (the bank) and
    rv.mix (mixdown, normalisation, scale, the pull to the host, rv.sync
    site pull, and the tail trim)."""
    with profiling.phase("rv.filter"):
        filtered = filter_bank(
            band_signals,
            sample_rate,
            lo_cutoff,
            filter_type,
            method=filter_method,
        )
    with profiling.phase("rv.mix"):
        mixed = mixdown(filtered)
        if do_normalize:
            mixed = normalize(mixed)
        if volume_scale != 1.0:
            mixed = mixed * np.float32(volume_scale)
        with profiling.span("rv.sync", site="pull"):
            out = mixed.cpu().numpy().astype(np.float32)
        if do_trim_tail:
            out = trim_tail(out)
    return out
