"""Impulse flattening: impulses binned into per-band sample histograms
(PyTorch counterpart of rayverb_tpu/ops/histogram.py).

flattenImpulses (reference rayverb/rayverb.cpp:28-77): each attenuated
impulse lands at sample round(time * sr) and its 8-band volume is summed
into an (8, L) buffer. round() is C's round-half-away-from-zero; times are
non-negative, so floor(t * sr + 0.5) in float32 reproduces it (never
torch.round, which rounds half to even).

The sums go through the render's scatter-free sorted binning (stable sort
by bin, segmented run totals, dense gather: ops/render.py), not a float
``index_add_``, whose order of additions on the card changes from run to
run: a render on the card repeats bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from .render import _sorted_hist, _time_bins


def max_sample(times, sample_rate: float) -> int:
    """Index of the final sample + 1 (rayverb.cpp:53-57). The reduction
    runs on the tensor's device; only the scalar crosses to the host (the
    wait: rv.sync site hist_len)."""
    with profiling.span("rv.sync", site="hist_len"):
        t = float(torch.amax(times)) if times.numel() else 0.0
    return int(np.floor(t * sample_rate + 0.5)) + 1


def flatten_impulses(volumes, times, sample_rate, *, length: int):
    """(M, 8) volumes + (M,) times -> (8, length) band signals
    (rayverb.cpp:48-77). Impulses outside [0, length) are dropped (cannot
    happen when length >= max_sample)."""
    idx = _time_bins(times, sample_rate)
    key = torch.where((idx >= 0) & (idx < length), idx, length)
    return _sorted_hist(key, volumes.to(torch.float32), length)


def flatten_channels(volumes, times, sample_rate, *, length: int | None = None):
    """Flatten (C, M, 8) multi-channel impulses with (C, M) times to
    (C, 8, L). Every channel shares L = max over channels (the JAX
    package's well-defined version of the reference's per-channel
    lengths, cmd/main.cpp:34-38)."""
    if length is None:
        length = max(1, max_sample(times, sample_rate))
    return torch.stack(
        [
            flatten_impulses(volumes[c], times[c], sample_rate, length=length)
            for c in range(volumes.shape[0])
        ]
    )
