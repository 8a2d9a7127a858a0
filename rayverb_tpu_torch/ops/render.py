"""Fused render: trace -> attenuate -> histogram -> filter, with nothing
but the finished IR leaving the device (PyTorch counterpart of
rayverb_tpu/ops/render.py::render_fused, :1157).

  trace + bin  = one pass over the rays of a chunk (``_fused_trace_bin``):
                 the trace's diffuse rows are collected per bounce and
                 binned at once by the scatter-free sorted binning (sort
                 rows by bin, segmented suffix sums, dense histogram by
                 searchsorted), or with bin_mode 'scatter' added into the
                 histogram bounce by bounce; per-ray image records carry
                 32-bit chain hashes for the dedup
  finalize     = cross-ray image dedup (sort by chain hash, keep first),
                 image attenuation + binning, predelay shift, content length
                 (``_finalize_hist``); crossover filter bank as FFT passes
                 (or, with RAYVERB_FINALIZE_FILTER=scan, as causal scans on
                 the biquad_scan kernel; the windowed-sinc bank as one
                 FIR convolution), mixdown, normalise, volume, trim length
                 (``_finalize_filter``)

Attenuation is per speaker (polar patterns) or binaural (HRTF: per-ear
8-band gains from a (2, 360, 180, 8) table and ITD-shifted arrival times;
predelay comes from the shifted times).

Chunking bounds device memory only. ``ray_chunk=None`` renders all rays in
one pass when ``render_bytes`` (a planned peak from the shapes) fits in
MEMORY_SHARE of the card's memory, and otherwise in chunks of the largest
power of two of rays that fits; on the CPU there is no limit. An explicit
``ray_chunk`` always chunks at that size. The rays are Morton-sorted once,
on the device (``ray_schedule``), and cut into consecutive chunks (chunk k
holds the rays of the JAX render's chunk k); the histogram and the min/max
arrival times carry across chunks, the last chunk runs short, and the
image records of all chunks are concatenated and deduplicated once, in
``_finalize_hist``.

Not ported, because they answer TPU limits: the segmentation of the chunk
loop into programs of SEG_PAIR_BUDGET issued pairs, the ``img_cap``
compaction and the ``seg_budget_rows`` cap of the image-validation rows
(JAX trace.py:675-684). Here the gated validation rows and the admitted
image rows are compacted with ``nonzero`` (ops/trace.py, ``_finalize_hist``),
whose shapes may depend on the data, so results equal the uncapped
trace's.

Documented deviations from the reference are those of the JAX render
(hash-pair chain identity, whole-bin predelay shift, power-of-two histogram
bound).
"""

from __future__ import annotations

import contextlib
import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config.schema import FilterType, OutputMode, RenderConfig
from ..constants import (
    NUM_BANDS,
    NUM_IMAGE_SOURCE,
    SECONDS_PER_METER,
    TRIM_TAIL_FLOOR,
)
from ..device import resolve_device
from ..utils.directions import morton_order_torch
from ..utils import profiling
from .attenuate import _f32, head_basis, hrtf_gain_time, speaker_gain
from .filters import _band_coeffs, _fft_len
from .intersect import SWEEP_RAYS, TriangleSoup, cached_soup
from .trace import SWEEP_KINDS, _trace_impl, sweep_count

MAX_HIST_LEN = 1 << 23  # ~190 s at 44.1 kHz; hard cap on the static bound

RAY_BLOCK_SORT = 512  # Morton-sort rays once several thread blocks are in play

# share of the card's memory that a render plans to use (render_bytes);
# the rest is left to the allocator's caching and to other work
MEMORY_SHARE = 0.5

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# chain hashing (identity of an image-source chain for the dedup)
# ---------------------------------------------------------------------------

def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow (c split into 16-bit halves)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def chain_hashes(image_index):
    """(N, S) integer chains -> two (N, S) int64 tensors holding the uint32
    cumulative prefix hashes of rayverb_tpu/ops/render.py:92-105. Prefix
    equality (the reference's map key, rayverb.cpp:662-666) becomes
    hash-pair equality."""
    idx = image_index.to(torch.int64) & _U32
    shape = idx.shape[:-1]
    h1 = torch.full(shape, 0x9E3779B9, dtype=torch.int64, device=idx.device)
    h2 = torch.full(shape, 0x85EBCA6B, dtype=torch.int64, device=idx.device)
    out1, out2 = [], []
    for k in range(idx.shape[-1]):
        h1 = _mix32(h1 ^ idx[..., k])
        h2 = _mix32(((h2 + idx[..., k]) & _U32) ^ 0x27D4EB2F)
        out1.append(h1)
        out2.append(h2)
    return torch.stack(out1, dim=-1), torch.stack(out2, dim=-1)


# ---------------------------------------------------------------------------
# attenuation: speakers and HRTF
# ---------------------------------------------------------------------------

class AttenSpec(NamedTuple):
    """Attenuation mode and its parameters on the render's device: speaker
    directions and shapes, or the HRTF table and head orientation."""

    is_hrtf: bool
    nchannels: int
    speaker_dirs: torch.Tensor | None = None    # (C, 3)
    speaker_coeffs: torch.Tensor | None = None  # (C,)
    table: torch.Tensor | None = None           # (2, 360, 180, 8)
    facing: torch.Tensor | None = None          # (3,)
    up: torch.Tensor | None = None              # (3,)


def make_atten_spec(model, device=None, table=None) -> AttenSpec:
    """AttenSpec of an attenuation model (render.py:140-181) on ``device``
    (None: the card). HRTF models take ``table`` (numpy or tensor, (2, 360,
    180, 8)), by default hrtf.table.default_table()."""
    device = resolve_device(device)
    if model.is_hrtf:
        if table is None:
            from ..hrtf.table import default_table

            table = default_table()
        f32 = lambda x: _f32(x, device)  # noqa: E731
        return AttenSpec(
            is_hrtf=True,
            nchannels=2,
            table=f32(table),
            facing=f32(model.hrtf.facing),
            up=f32(model.hrtf.up),
        )
    dirs = np.stack([np.asarray(s.direction, np.float32) for s in model.speakers])
    coeffs = np.asarray([s.shape for s in model.speakers], np.float32)
    return AttenSpec(
        is_hrtf=False,
        nchannels=len(model.speakers),
        speaker_dirs=torch.from_numpy(dirs).to(device),
        speaker_coeffs=torch.from_numpy(coeffs).to(device),
    )


def _head(spec: AttenSpec):
    """The head basis of an HRTF spec, else None."""
    return head_basis(spec.facing, spec.up) if spec.is_hrtf else None


def _channel(spec: AttenSpec, basis, mic, positions, times, c: int):
    """Channel c's per-row gain ((M, 8) for HRTF, (M, 1) for a speaker) and
    its arrival times: ITD-shifted for HRTF (_hrtf_channel, render.py:124),
    unchanged for a speaker."""
    if spec.is_hrtf:
        return hrtf_gain_time(mic, positions, times, spec.table, basis, c)
    gain = speaker_gain(mic, positions, spec.speaker_dirs[c], spec.speaker_coeffs[c])
    return gain[:, None], times


def _time_stats(ok, times, min_t, max_t):
    """Running (min over ok rows with t > 0, max over ok rows)."""
    if times.numel() == 0:
        return min_t, max_t
    return (
        torch.minimum(min_t, torch.amin(torch.where(ok & (times > 0), times, float("inf")))),
        torch.maximum(max_t, torch.amax(torch.where(ok, times, 0.0))),
    )


def _no_time_stats(dev):
    return torch.tensor(float("inf"), device=dev), torch.zeros((), device=dev)


def _time_bins(times, sample_rate):
    """Bin index floor(t * sr + 0.5) in float32, int64."""
    return torch.floor(times * np.float32(sample_rate) + 0.5).to(torch.int64)


def _attenuate_and_bin(mic, volumes, positions, times, spec: AttenSpec,
                       length: int, sample_rate, init_hist=None):
    """(M, 8) impulses -> ((C, 8, length) histogram, min time, max time) by
    scatter-add (flattenImpulses, rayverb.cpp:48-77; render.py:184-230).
    The time stats are over the attenuated (for HRTF ITD-shifted) times of
    the non-zero rows: min over t > 0, max over all. Zero-volume impulses
    and bins outside [0, length) contribute nothing. With ``init_hist``
    the rows are added into it, in place."""
    dev = volumes.device
    nonzero = torch.any(volumes != 0, dim=-1)
    basis = _head(spec)
    hist = (
        torch.zeros((spec.nchannels, NUM_BANDS, length), device=dev)
        if init_hist is None
        else init_hist
    )
    min_t, max_t = _no_time_stats(dev)
    for c in range(spec.nchannels):
        gain, t_c = _channel(spec, basis, mic, positions, times, c)
        min_t, max_t = _time_stats(nonzero, t_c, min_t, max_t)
        idx = _time_bins(t_c, sample_rate)
        keep = nonzero & (idx >= 0) & (idx < length)
        hist[c].index_add_(1, idx[keep], (volumes * gain)[keep].T)
    return hist, min_t, max_t


def _segmented_run_totals(sorted_keys, sorted_vals):
    """Inclusive segmented SUFFIX sums over equal-key runs of an ascending
    key array (render.py:265-284): afterwards the FIRST row of each run
    holds the run total. Hillis-Steele with a same-key carry mask."""
    m = sorted_keys.shape[0]
    d = 1
    while d < m:
        same = sorted_keys[:-d] == sorted_keys[d:]
        shifted = torch.zeros_like(sorted_vals)
        shifted[:-d] = torch.where(same[:, None], sorted_vals[d:], 0.0)
        sorted_vals = sorted_vals + shifted
        d *= 2
    return sorted_vals


def _dense_from_runs(sorted_keys, run_totals, length: int):
    """(8, length) dense histogram from run-start totals (render.py:287-297):
    bin j's value sits at searchsorted(keys, j) when that row's key is j.
    Keys >= length (the drop sentinel) lie past every query."""
    m = sorted_keys.shape[0]
    if m == 0:
        return torch.zeros((NUM_BANDS, length), device=run_totals.device)
    j = torch.arange(length, dtype=sorted_keys.dtype, device=sorted_keys.device)
    pos = torch.searchsorted(sorted_keys, j, side="left")
    posc = torch.clamp(pos, max=m - 1)
    found = (pos < m) & (sorted_keys[posc] == j)
    return torch.where(found[:, None], run_totals[posc], 0.0).T


def _sorted_hist(key, vals, length: int):
    """(8, length) histogram of rows (M, 8) by bin ``key``: stable sort,
    segmented run totals, dense gather."""
    perm = torch.argsort(key, stable=True)
    sk = key[perm]
    return _dense_from_runs(sk, _segmented_run_totals(sk, vals[perm]), length)


def _bin_rows_sorted(mic, volumes, positions, times, spec: AttenSpec,
                     length: int, sample_rate, init_hist=None):
    """Scatter-free binning of all diffuse rows (render.py:300-368):
    returns ((C, 8, length) histogram (+ init_hist), min time, max time) as
    0-dim tensors, with _attenuate_and_bin's admission rules. Speaker
    channels share one stable sort by bin; HRTF's ITD shift makes bins
    channel-specific, so each ear sorts its own."""
    nonzero = torch.any(volumes != 0, dim=-1)
    basis = _head(spec)

    def key_for(t_c):
        idx = _time_bins(t_c, sample_rate)
        return torch.where(nonzero & (idx >= 0) & (idx < length), idx, length)

    min_t, max_t = _no_time_stats(volumes.device)
    hists = []
    if spec.is_hrtf:
        for c in range(spec.nchannels):
            gain, t_c = _channel(spec, basis, mic, positions, times, c)
            min_t, max_t = _time_stats(nonzero, t_c, min_t, max_t)
            hists.append(_sorted_hist(key_for(t_c), volumes * gain, length))
    else:
        min_t, max_t = _time_stats(nonzero, times, min_t, max_t)
        key = key_for(times)
        perm = torch.argsort(key, stable=True)
        sk = key[perm]
        svol = volumes[perm]
        spos = positions[perm]
        for c in range(spec.nchannels):
            gain, _ = _channel(spec, basis, mic, spos, times, c)
            hists.append(
                _dense_from_runs(sk, _segmented_run_totals(sk, svol * gain), length)
            )
    hist = torch.stack(hists)
    if init_hist is not None:
        hist = init_hist + hist
    return hist, min_t, max_t


def _bin_mode() -> str:
    """The diffuse binning of a render whose bin_mode is None: RAYVERB_BIN,
    'sorted' by default (render.py:261-262)."""
    return os.environ.get("RAYVERB_BIN", "sorted")


class _Images(NamedTuple):
    """Per-ray image-source records, (N, S, ...) with S = NUM_IMAGE_SOURCE
    slots per ray; slot 0 is the direct path."""

    volume: torch.Tensor    # (N, S, 8)
    position: torch.Tensor  # (N, S, 3)
    time: torch.Tensor      # (N, S)
    valid: torch.Tensor     # (N, S) bool (reference map-admission rule)
    h1: torch.Tensor        # (N, S) int64 uint32 hash
    h2: torch.Tensor        # (N, S)


def _admitted(imgs: _Images, remove_direct: bool):
    """(N, S) rows the dedup admits: valid, and not slot 0 with
    remove_direct. Flat rows (M,) carry no slot: they must have been
    admitted already, and come with remove_direct False."""
    ok = imgs.valid
    if remove_direct:
        if ok.dim() != 2 or ok.shape[1] != NUM_IMAGE_SOURCE:
            raise ValueError(f"remove_direct needs (N, {NUM_IMAGE_SOURCE}) per-ray "
                             f"records, not {tuple(ok.shape)}")
        ok = ok & (torch.arange(NUM_IMAGE_SOURCE, device=ok.device) != 0)
    return ok


def _fused_trace_bin(soup, mic, source, directions, spec: AttenSpec, *,
                     nreflections: int, length: int, sample_rate, impl: str,
                     include_diffuse: bool, resort: bool,
                     bin_mode: str = "sorted", init_hist=None, stats=None):
    """Trace and bin one population of rays (render.py:409-523, 542-641):
    returns (hist (C,8,L) (+ init_hist), max_t, min_t, images).

    'sorted' collects every bounce's diffuse rows into (R, N, .) buffers
    and bins them once (_bin_rows_sorted); 'scatter' adds each bounce's
    rows into the carried histogram as they come (_attenuate_and_bin).
    ``stats`` is _trace_impl's executed-pair accumulator, or None. The
    consumer of each bounce's rows and the binning after the trace are
    the span rv.bin."""
    dev = soup.device
    n = directions.shape[0]
    mic_t = torch.as_tensor(np.asarray(mic, np.float32), device=dev)
    hist = (
        torch.zeros((spec.nchannels, NUM_BANDS, length), device=dev)
        if init_hist is None
        else init_hist
    )
    min_t, max_t = _no_time_stats(dev)
    if not include_diffuse:
        # without the diffuse population, it takes no part in predelay
        def consume(row):
            return None
    elif bin_mode == "scatter":
        carry = [hist, min_t, max_t]

        def consume(row):
            with profiling.span("rv.bin"):
                carry[0], mn, mx = _attenuate_and_bin(
                    mic_t, *row, spec, length, sample_rate, init_hist=carry[0]
                )
                carry[1] = torch.minimum(carry[1], mn)
                carry[2] = torch.maximum(carry[2], mx)
    else:
        # (R, N, .) bounce-major, as the JAX row buffers
        bufs = (
            torch.empty((nreflections, n, NUM_BANDS), device=dev),
            torch.empty((nreflections, n, 3), device=dev),
            torch.empty((nreflections, n), device=dev),
        )
        bounce = iter(range(nreflections))

        def consume(row):
            b = next(bounce)
            with profiling.span("rv.bin"):
                for buf, x in zip(bufs, row):
                    buf[b] = x

    img_vol, img_pos, img_time, img_idx = _trace_impl(
        soup,
        mic,
        source,
        directions,
        nreflections=nreflections,
        impl=impl,
        consume_row=consume,
        resort=resort,
        stats=stats,
    )
    if include_diffuse and bin_mode == "scatter":
        hist, min_t, max_t = carry
    elif include_diffuse and nreflections > 0:
        with profiling.span("rv.bin"):
            hist, min_t, max_t = _bin_rows_sorted(
                mic_t,
                bufs[0].view(-1, NUM_BANDS),
                bufs[1].view(-1, 3),
                bufs[2].view(-1),
                spec,
                length,
                sample_rate,
                init_hist=init_hist,
            )
        del bufs
    h1, h2 = chain_hashes(img_idx)
    slots = torch.arange(NUM_IMAGE_SOURCE, device=dev)
    valid = (slots == 0) | (img_idx != 0)
    return hist, max_t, min_t, _Images(img_vol, img_pos, img_time, valid, h1, h2)


def _image_time_stats(imgs: _Images, mic, spec: AttenSpec, remove_direct: bool):
    """(earliest, latest) image arrival time over the admitted population,
    ITD-shifted per ear for HRTF (render.py:1506-1547); duplicates share
    times, so pre-dedup is exact."""
    ok = _admitted(imgs, remove_direct) & torch.any(imgs.volume != 0, dim=-1)
    with profiling.span("rv.sync", site="image_rows"):
        rows = torch.nonzero(ok.reshape(-1)).squeeze(1)
    times = imgs.time.reshape(-1)[rows]
    positions = imgs.position.reshape(-1, 3)[rows]
    basis = _head(spec)
    min_t, max_t = _no_time_stats(mic.device)
    every = torch.ones_like(times, dtype=torch.bool)
    for c in range(spec.nchannels if spec.is_hrtf else 1):
        _, t_c = _channel(spec, basis, mic, positions, times, c)
        min_t, max_t = _time_stats(every, t_c, min_t, max_t)
    return min_t, max_t


def _dedup_rows(imgs: _Images, remove_direct: bool):
    """Flat (N * S) indices, ascending, of the image rows the dedup keeps:
    of the admitted rows, the first in row order of each equal (h1, h2)
    chain identity (render.py:828-860). The admitted rows are compacted
    first (the JAX img_cap compaction, exact here because the shape may
    depend on the data)."""
    m = imgs.h1.numel()
    with profiling.span("rv.sync", site="dedup"):
        rows = torch.nonzero(_admitted(imgs, remove_direct).reshape(m)).squeeze(1)
    k1 = imgs.h1.reshape(m)[rows]
    k2 = imgs.h2.reshape(m)[rows]
    # lexicographic (h1, h2) order: stable sort by the minor key, then by
    # the major key
    perm = torch.argsort(k2, stable=True)
    perm = perm[torch.argsort(k1[perm], stable=True)]
    s1 = k1[perm]
    s2 = k2[perm]
    first = torch.ones_like(s1, dtype=torch.bool)
    first[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    return torch.sort(rows[perm][first]).values  # keep row order


def _finalize_hist(hist, imgs: _Images, mic, spec: AttenSpec, predelay,
                   sample_rate, *, length: int, include_images: bool,
                   remove_direct: bool):
    """Image dedup + binning (the span rv.dedup), predelay shift, content
    length (render.py:828-936). Returns (hist, content_len 0-dim int64)."""
    dev = hist.device
    if include_images:
        with profiling.span("rv.dedup"):
            m = imgs.h1.numel()
            chosen = _dedup_rows(imgs, remove_direct)
            # sorted binning, as for the diffuse rows: its sums do not
            # depend on the device's scheduling, so renders repeat bit for
            # bit
            img_hist, _, _ = _bin_rows_sorted(
                mic,
                imgs.volume.reshape(m, NUM_BANDS)[chosen],
                imgs.position.reshape(m, 3)[chosen],
                imgs.time.reshape(m)[chosen],
                spec,
                length,
                sample_rate,
            )
            hist = hist + img_hist

    if predelay is not None:
        # whole-histogram fixPredelay (rayverb.h:77-97): bins shifted past
        # the origin CLAMP into bin 0, they are not dropped
        shift = int(
            np.floor(np.float32(predelay) * np.float32(sample_rate) + np.float32(0.5))
        )
        pos = torch.arange(length, device=dev)
        src = pos + shift
        shifted = hist[..., torch.clamp(src, 0, length - 1)]
        shifted = torch.where(src < length, shifted, 0.0)
        head = torch.sum(torch.where(pos <= shift, hist, 0.0), dim=-1)
        shifted[..., 0] = head
        hist = shifted

    # exact content length: one past the last occupied bin
    occupied = torch.any(torch.any(hist != 0, dim=0), dim=0)
    content_len = (
        torch.amax(
            torch.where(occupied, torch.arange(length, device=dev), -1)
        )
        + 1
    )
    return hist, content_len


def _finalize_filter(hist, content_len, responses, volume_scale, *,
                     flips: tuple, nfft: int, do_normalize: bool,
                     filter_method: str):
    """Crossover filter bank, mixdown, normalise, volume, trim length
    (render.py:943-1029) of a batch of pairs: hist (B, C, 8, L), content_len
    (B,) int64; returns (mixed (B, C, L'), trim_len (B,)), each pair's as
    the JAX ``jax.vmap(filter_one)`` of datagen.py:515-517 gives it (one
    render is B = 1). The reference's arrays END at the content length, so
    after every pass the samples at or after it are zeroed.

    filter_method 'fft': flip-free truncated FFT passes, ``responses`` (P,
    8, nfft//2+1, 2) float32 (re, im), reversed passes pre-conjugated.
    'scan': the causal time-domain biquads (the biquad_scan kernel on the
    card, one launch per pass for every pair's series), ``responses`` (P,
    8, 5) float32 coefficients; a reversed pass runs as a reverse scan on
    the unflipped signal, from content_len - 1 (the direction is the
    cumulative parity of ``flips``), and the scan itself writes the zeros
    at and after the content length. 'fir': the windowed-sinc bank as one
    full FFT convolution per band (``responses`` (1, 8, nfft//2+1, 2)
    kernel spectra); the output grows by KERNEL_LENGTH - 1 samples, as does
    the content length (FastConvolution, filters.cpp:96-154). Normalise
    and trim are per pair."""
    out = hist
    t = out.shape[-1]
    content = content_len.reshape(-1, 1, 1, 1)
    if filter_method == "fir":
        from .filters import KERNEL_LENGTH

        t = t + KERNEL_LENGTH - 1
        content = content + KERNEL_LENGTH - 1
        resp = torch.complex(responses[0, ..., 0], responses[0, ..., 1])
        spec_f = torch.fft.rfft(out, n=nfft)
        out = torch.fft.irfft(spec_f * resp, n=nfft)[..., :t]
        out = out * (torch.arange(t, device=out.device) < content)
    elif filter_method == "scan":
        from .filters import _scan_onepass_multi

        out = _scan_onepass_multi(out, zip(responses, flips), content[..., 0])
    else:
        in_content = (torch.arange(t, device=out.device) < content).to(out.dtype)
        for p in range(responses.shape[0]):
            resp = torch.complex(responses[p, ..., 0], responses[p, ..., 1])
            spec_f = torch.fft.rfft(out, n=nfft)
            out = torch.fft.irfft(spec_f * resp, n=nfft)[..., :t]
            out = out * in_content
    mixed = torch.sum(out, dim=-2)  # (B, C, L)
    if do_normalize:
        peak = torch.amax(torch.abs(mixed), dim=(-2, -1), keepdim=True)
        mixed = mixed * torch.where(peak > 0, 1.0 / peak, 1.0)
    mixed = mixed * np.float32(volume_scale)
    positions = torch.arange(mixed.shape[-1], device=mixed.device)
    loud = (torch.abs(mixed) >= TRIM_TAIL_FLOOR) & (positions < content[..., 0])
    last = torch.amax(torch.where(loud, positions, -1), dim=(-2, -1))
    trim_len = torch.clamp(last, min=0)
    return mixed, trim_len


def _finalize_method(filter_type, method=None) -> str:
    """The finalize's filter method: 'fir' for the windowed-sinc bank (it
    has no IIR form); else ``method``, by default RAYVERB_FINALIZE_FILTER,
    'fft' when unset (render.py:1055-1056)."""
    if filter_type == FilterType.WINDOWED_SINC:
        return "fir"
    if method is None:
        method = os.environ.get("RAYVERB_FINALIZE_FILTER", "fft")
    if method not in ("fft", "scan"):
        raise ValueError(f"finalize filter method must be 'fft' or 'scan', not {method!r}")
    return method


def finalize_filter_params(filter_type, sample_rate: float, lo_cutoff: float,
                           length: int, method: str | None = None):
    """Host-side numpy parameters of the finalize's filter section
    (render.py:1032-1122); returns (params, flips, nfft, method), as the
    JAX function does. method None reads RAYVERB_FINALIZE_FILTER ('fft'
    when unset); the windowed-sinc bank always takes 'fir'.

      - 'fft': (P, 8, nfft//2+1, 2) float32 (re, im) responses of the
        passes on the rFFT grid, reversed passes pre-conjugated
      - 'scan': (P, 8, 5) float32 biquad coefficients, nfft 0
      - 'fir': (1, 8, nfft//2+1, 2) float32 spectra of the sinc kernels,
        nfft = _fft_len(length + KERNEL_LENGTH - 1)

    Cached per (filter, sr, cutoff, length, method)."""
    return _finalize_filter_params_cached(
        filter_type, float(sample_rate), float(lo_cutoff), int(length),
        _finalize_method(filter_type, method),
    )


@lru_cache(maxsize=16)
def _finalize_filter_params_cached(filter_type, sample_rate: float,
                                   lo_cutoff: float, length: int, method: str):
    if method == "fir":
        from .filters import KERNEL_LENGTH, sinc_bank_kernels

        nfft = _fft_len(length + KERNEL_LENGTH - 1)
        kernels = sinc_bank_kernels(sample_rate, lo_cutoff)
        kspec = np.fft.rfft(kernels.astype(np.float64), n=nfft)[None]
        params = np.stack([kspec.real, kspec.imag], axis=-1).astype(np.float32)
        return params, (False,), nfft, "fir"
    passes = _band_coeffs(filter_type, sample_rate, lo_cutoff)
    flips = tuple(bool(f) for _, f in passes)
    if method == "scan":
        return np.stack([c for c, _ in passes]).astype(np.float32), flips, 0, "scan"
    nfft = _fft_len(length)
    k = nfft // 2 + 1
    w = np.exp((-2j * np.pi / nfft) * np.arange(k))
    w2 = w * w
    params = np.empty((len(passes), NUM_BANDS, k, 2), np.float32)
    orientation = False
    for p, (coeffs, do_flip) in enumerate(passes):
        orientation ^= do_flip
        sign = -1.0 if orientation else 1.0  # conj == negated imag
        for band, cf in enumerate(coeffs):
            b0, b1, b2, a1, a2 = [float(c) for c in cf]
            r = (b0 + b1 * w + b2 * w2) / (1.0 + a1 * w + a2 * w2)
            params[p, band, :, 0] = r.real
            params[p, band, :, 1] = sign * r.imag
    return params, flips, nfft, "fft"


@lru_cache(maxsize=4)
def _device_filter_params(filter_type, sample_rate, lo_cutoff, length, device,
                          method):
    """finalize_filter_params uploaded to ``device`` once per key (the
    vault's fft responses are ~134 MB)."""
    params, flips, nfft, method = finalize_filter_params(
        filter_type, sample_rate, lo_cutoff, length, method
    )
    return torch.from_numpy(params).to(device), flips, nfft, method


def device_filter_params(filter_type, sample_rate, lo_cutoff, length, device, method):
    """_device_filter_params in the span rv.filter_params, counted as
    filter_params.hits (the device cache served), filter_params.uploads
    (the host cache served, and the parameters were uploaded) or
    filter_params.builds (computed on the host)."""
    with profiling.span("rv.filter_params"):
        if not profiling.counting():
            return _device_filter_params(filter_type, sample_rate, lo_cutoff, length,
                                         device, method)
        on_device = _device_filter_params.cache_info().hits
        on_host = _finalize_filter_params_cached.cache_info().hits
        out = _device_filter_params(filter_type, sample_rate, lo_cutoff, length, device,
                                    method)
        if _device_filter_params.cache_info().hits > on_device:
            profiling.count("filter_params.hits")
        elif _finalize_filter_params_cached.cache_info().hits > on_host:
            profiling.count("filter_params.uploads")
        else:
            profiling.count("filter_params.builds")
        return out


def histogram_length(scene, nreflections: int, sample_rate: float) -> int:
    """Scene-derived upper bound on the IR length, rounded up to a power of
    two (render.py:1125-1141)."""
    lo, hi = np.asarray(scene.bounds)
    diag = float(np.linalg.norm(hi - lo))
    max_t = ((nreflections + 2) * max(diag, 1.0) + 1.0) * SECONDS_PER_METER
    length = int(np.floor(max_t * sample_rate + 0.5)) + 8
    length = 1 << (max(length, 256) - 1).bit_length()
    return min(length, MAX_HIST_LEN)


def sweep_pair_tests(nrays: int, ntris: int, nreflections: int) -> int:
    """Ray-triangle pair tests ISSUED by one trace before any cull, as the
    JAX render counts them (render.py:1144-1154)."""
    b = min(nreflections, NUM_IMAGE_SOURCE - 1)
    total = ntris
    for k in range(b):
        total += nrays * ntris
        total += nrays * (k + 3) * ntris
    total += (nreflections - b) * 2 * nrays * ntris
    return total


def render_bytes(nrays: int, nreflections: int, nblocks: int) -> int:
    """Planned peak device bytes of a one-pass render of ``nrays`` rays
    over a table of ``nblocks`` blocks, from the shapes:

      - diffuse rows, nrays x R: 48 B each in the row buffers (volume,
        position, time), and up to 208 B of the sorted binning's working
        set (sort key and permutation, the gathered HRTF gains, the sorted
        volumes and the segmented sums' buffers)
      - image records, nrays x NUM_IMAGE_SOURCE slots: 128 B each (volume,
        position, time, chain index, two hashes, and their temporaries)
      - the trace state, 1 KiB per ray (the mirrored triangle chain and its
        stack, the image phase's validation geometry)
      - the largest sweep, at most nrays x (NUM_IMAGE_SOURCE + 1) rows
        (shadow, segments, visibility), 32 B each of inputs and outputs,
        and its order table of rows / SWEEP_RAYS x nblocks x 4 B
    """
    rows = nrays * nreflections
    sweep_rows = nrays * (NUM_IMAGE_SOURCE + 1)
    return (
        rows * (48 + 208)
        + nrays * NUM_IMAGE_SOURCE * 128
        + nrays * 1024
        + sweep_rows * 32
        + -(-sweep_rows // SWEEP_RAYS) * nblocks * 4
    )


def ray_schedule(directions: torch.Tensor, nblocks: int):
    """The ray schedule that _prepare (render_fused, the sharded render and
    the batched datagen) and trace.trace share; ray order is semantically
    free.
    directions: (N, 3), or (B, N, 3) for B pairs' ray sets, a tensor on the
    device that traces them. Returns (order, resort): ``order`` the Morton
    permutation (utils.directions.morton_order_torch, made on that device)
    of the rows once a set holds 4 x RAY_BLOCK_SORT rays (coherent bundles
    let neighbouring threads share triangle tiles), else None; for B sets
    it orders the (B * N, 3) rows pair-major, each set in its own Morton
    order. The rows it orders are the call's counter ray_order.rows.
    ``resort`` whether each bounce sweep re-sorts its rows, which pays once
    the population fills many thread blocks and the table has enough
    blocks to cull (the JAX render's rule, on the whole population)."""
    n = directions.shape[-2]
    rows = n * (directions.shape[0] if directions.ndim == 3 else 1)
    order = None
    if n >= 4 * RAY_BLOCK_SORT:
        order = morton_order_torch(directions)
        profiling.count("ray_order.rows", rows)
    return order, resort_sweeps(rows, nblocks)


def resort_sweeps(nrays: int, nblocks: int) -> bool:
    """ray_schedule's ``resort`` for a population of ``nrays`` rays."""
    return nrays >= 4096 and nblocks >= 32


def choose_ray_chunk(nrays: int, nreflections: int, nblocks: int,
                     ray_chunk=None, budget=None, plan=None) -> int:
    """Rays per chunk: ``ray_chunk`` when given (at most nrays); else all
    rays when ``budget`` is None or the plan (render_bytes, or ``plan``
    with its arguments, e.g. trace.trace_bytes) fits in it; else the
    largest power of two of rays that fits (at least 1)."""
    plan = render_bytes if plan is None else plan
    if ray_chunk is not None:
        if int(ray_chunk) < 1:
            raise ValueError(f"ray_chunk must be >= 1, got {ray_chunk}")
        return min(int(ray_chunk), nrays)
    if budget is None or plan(nrays, nreflections, nblocks) <= budget:
        return nrays
    chunk = 1 << (nrays.bit_length() - 1)
    while chunk > 1 and plan(chunk, nreflections, nblocks) > budget:
        chunk //= 2
    return chunk


def memory_budget(dev):
    """Bytes a render may plan to use on ``dev``: MEMORY_SHARE of a CUDA
    card's memory; None (no limit) on the CPU."""
    if dev.type != "cuda":
        return None
    return int(MEMORY_SHARE * torch.cuda.get_device_properties(dev).total_memory)


class _Prepared(NamedTuple):
    """What _prepare decides for one call."""

    bin_mode: str
    spec: AttenSpec
    soup: TriangleSoup
    length: int                # histogram_length
    directions: torch.Tensor   # (rows, 3) on the device, in trace order
    resort: bool
    include_diffuse: bool
    include_images: bool
    pair_stats: torch.Tensor | None  # profiling.pair_sums()

    @property
    def nblocks(self) -> int:
        return self.soup.block_aabb.shape[0]


def _prepare(scene, config: RenderConfig, directions, dev, *, hrtf_table=None,
             bin_mode: str | None = None, soup: TriangleSoup | None = None) -> _Prepared:
    """The per-call preparation of render_fused, the sharded render and the
    batched datagen, run inside the caller's span rv.prepare: bin_mode
    resolved (None reads RAYVERB_BIN) and checked; the attenuation spec
    (span rv.atten_spec); unless ``soup`` is given, the sweep table (span
    rv.sweep_table, attribute hit): the process's soup of the scene's
    content on ``dev``, built by the first call that asks for it
    (intersect.cached_soup, counter sweep_table.hits or .builds); the
    histogram bound (counter hist.len); the rays on
    ``dev`` in ray_schedule's order, with its resort decided on the whole
    population (span rv.ray_order): directions (N, 3) come back as (N, 3)
    rows, (B, N, 3) for B pairs' ray sets as pair-major (B * N, 3) rows;
    the output mode's flags; and the call's executed-pair accumulator.
    Raises ValueError on an unknown bin_mode and on a set without rays."""
    if bin_mode is None:
        bin_mode = _bin_mode()
    if bin_mode not in ("sorted", "scatter"):
        raise ValueError(f"bin_mode must be 'sorted' or 'scatter', not {bin_mode!r}")
    shape = np.shape(directions)
    if len(shape) < 2 or shape[-2] == 0:
        raise ValueError("need at least one ray")
    with profiling.span("rv.atten_spec"):
        spec = make_atten_spec(config.attenuation_model, dev, hrtf_table)
    if soup is None:
        with profiling.span("rv.sweep_table") as sp:
            soup, hit = cached_soup(scene, dev)
            sp.set(hit=hit)
    length = histogram_length(scene, config.reflections, config.sample_rate)
    profiling.count("hist.len", length)
    with profiling.span("rv.ray_order"):
        directions = _f32(directions, dev)
        order, resort = ray_schedule(directions, soup.block_aabb.shape[0])
        directions = directions.reshape(-1, 3)
        if order is not None:
            directions = directions[order]
    return _Prepared(
        bin_mode, spec, soup, length, directions, resort,
        include_diffuse=config.output_mode in (OutputMode.ALL, OutputMode.DIFFUSE_ONLY),
        include_images=config.output_mode in (OutputMode.ALL, OutputMode.IMAGE_ONLY),
        pair_stats=profiling.pair_sums(),
    )


def _trace_chunks(prep: _Prepared, config: RenderConfig, directions, chunk: int, impl: str,
                  consume_images):
    """Trace and bin ``directions`` (rows of prep.directions) in consecutive
    chunks of ``chunk`` rays, one span rv.trace each (_fused_trace_bin),
    the histogram and the diffuse time stats carried across chunks; each
    chunk's per-ray image records go to ``consume_images`` before the next
    chunk runs. Returns (hist (C, 8, L), None without rows; max_t, min_t:
    0-dim device tensors)."""
    dev = directions.device
    hist = None
    max_t = torch.zeros((), device=dev)
    min_t = torch.tensor(float("inf"), device=dev)
    for first in range(0, directions.shape[0], chunk):
        with profiling.span("rv.trace", first=first):
            hist, mx, mn, part = _fused_trace_bin(
                prep.soup,
                config.mic_position,
                config.source_position,
                directions[first : first + chunk],
                prep.spec,
                nreflections=config.reflections,
                length=prep.length,
                sample_rate=config.sample_rate,
                impl=impl,
                include_diffuse=prep.include_diffuse,
                resort=prep.resort,
                bin_mode=prep.bin_mode,
                init_hist=hist,
                stats=prep.pair_stats,
            )
            max_t = torch.maximum(max_t, mx)
            min_t = torch.minimum(min_t, mn)
            consume_images(part)
            del part
    return hist, max_t, min_t


# render_fused's flat timings (info["timings"]) and the spans they read;
# trace_bin is a mark (profiling.mark) and total the root's wall
FLAT_TIMINGS = {"time_stats": "rv.time_stats", "finalize": "rv.finalize",
                "pull": "rv.pull"}


def render_fused(
    scene,
    config: RenderConfig,
    directions,
    *,
    hrtf_table=None,
    impl: str = "auto",
    device=None,
    ray_chunk: int | None = None,
    soup: TriangleSoup | None = None,
    stats: bool = False,
    bin_mode: str | None = None,
):
    """Full render on ``device`` (default cuda). Returns (channels (C, T')
    float32 numpy, info dict).

    directions: (N, 3) unit vectors, numpy or a tensor; they go to the
    device once and are put in ray_schedule's Morton order there (span
    rv.ray_order, counter ray_order.rows), then cut into chunks.

    hrtf_table: the (2, 360, 180, 8) table of HRTF configs (numpy or
    tensor), by default hrtf.table.default_table(). impl: closest-hit
    implementation, 'auto' | 'cuda' | 'plain' (see intersect.closest_hit).
    ray_chunk: rays per chunk, None to choose by memory (module docstring).
    bin_mode: 'sorted' or 'scatter' diffuse binning, None to read
    RAYVERB_BIN.

    The call is the root span rv.render (utils.profiling): rv.prepare
    (_prepare: rv.atten_spec, rv.sweep_table, rv.ray_order), one rv.trace
    per chunk (rv.phase_a, rv.phase_b: rv.bounce, rv.closest_hit, rv.bin),
    rv.time_stats, rv.finalize (rv.filter_params, rv.dedup), rv.pull, and
    rv.sync where the host waits for the device.
    With stats=True the info dict gains ``timings``: the device-
    synchronised phase walls trace_bin, time_stats, finalize, pull and
    total, the call's ``spans`` and ``counters`` (the executed pair tests
    by sweep kind among them, counted in the sweeps' own launches and
    copied to the host with the IR), ``call`` and ``once``; the issued pair
    tests, and the executed ones by kind. With RAYVERB_PROFILE_DIR set a
    stats=True call runs under torch.profiler and writes its Chrome trace,
    the spans in it, into that directory (utils.profiling.trace_into; JAX
    render.py:1184-1189)."""
    dev = resolve_device(device)
    profile_dir = os.environ.get("RAYVERB_PROFILE_DIR") if stats else None
    timings: dict = {}
    with (profiling.trace_into(profile_dir, dev) if profile_dir
          else contextlib.nullcontext()), \
            profiling.call("rv.render", dev, stats=stats, timings=timings,
                           flat=FLAT_TIMINGS):
        with profiling.span("rv.prepare"):
            prep = _prepare(scene, config, directions, dev, hrtf_table=hrtf_table,
                            bin_mode=bin_mode, soup=soup)
            n = prep.directions.shape[0]
            chunk = choose_ray_chunk(n, config.reflections, prep.nblocks, ray_chunk,
                                     memory_budget(dev))

        parts = []
        hist, max_t_dev, min_t_dev = _trace_chunks(prep, config, prep.directions, chunk,
                                                   impl, parts.append)
        imgs = parts[0] if len(parts) == 1 else _Images(*map(torch.cat, zip(*parts)))
        del parts
        profiling.mark("trace_bin")
        with profiling.span("rv.sync", site="trace_stats"):
            max_t, min_t = float(max_t_dev), float(min_t_dev)
        channels, info = _finish_render(
            hist, imgs, max_t, min_t, config, prep, dev, remove_direct=config.remove_direct,
        )
        info.update({
            "sweeps": sweep_count(config.reflections) * -(-n // chunk),
            "ray_chunk": chunk,
            "chunks": -(-n // chunk),
            "bin_mode": prep.bin_mode,
        })
    if stats:
        info["timings"] = timings
        info["pair_tests_issued"] = sweep_pair_tests(n, prep.soup.num_padded,
                                                     config.reflections)
        info["ray_bounces_per_s"] = n * config.reflections / max(timings["total"], 1e-9)
        info["memory_estimate_bytes"] = render_bytes(chunk, config.reflections, prep.nblocks)
        info.update(executed_pairs(timings))
    return channels, info


def executed_pairs(timings: dict) -> dict:
    """The info's ``pair_tests_executed`` (by sweep kind) and
    ``pair_tests_executed_total``, read from a stats call's counters."""
    executed = {k: timings["counters"].get(f"pair_tests.{k}", 0) for k in SWEEP_KINDS}
    return {"pair_tests_executed": executed,
            "pair_tests_executed_total": sum(executed.values())}


def _finish_render(hist, imgs: _Images, max_t: float, min_t: float,
                   config: RenderConfig, prep: _Prepared, dev, *, remove_direct: bool):
    """Everything of a render after its trace: the image time stats and
    predelay, the content bucket, the image dedup and binning, the filter
    bank and the host IR (render.py:1157-1299 after the trace). hist: the
    (C, 8, prep.length) diffuse histogram; max_t, min_t: the diffuse time
    stats; imgs: the image records ((N, S, ...) per ray, or flat rows
    already admitted, which must come with remove_direct False). Returns
    (channels (C, T') float32 numpy, info). Its spans are rv.time_stats,
    rv.finalize (which in a stats call ends with a device synchronisation)
    and rv.pull, before which the call's executed-pair counters are
    staged."""
    spec, length, include_images = prep.spec, prep.length, prep.include_images
    with profiling.span("rv.time_stats"):
        mic_t = torch.as_tensor(np.asarray(config.mic_position, np.float32), device=dev)
        # direct-path + image times take part in predelay like the
        # reference's findPredelay over attenuated impulses (rayverb.h:49-73)
        if include_images:
            img_min, img_max = _image_time_stats(imgs, mic_t, spec, remove_direct)
            with profiling.span("rv.sync", site="time_stats"):
                min_t = min(min_t, float(img_min))
                max_t = max(max_t, float(img_max))

        predelay = None
        if config.trim_predelay and np.isfinite(min_t):
            predelay = float(min_t)

    with profiling.phase("rv.finalize"):
        # finalize over a power-of-two bucket that covers the actual content
        bucket = length
        if max_t > 0:
            need = int(
                np.floor((max_t + 0.1 * SECONDS_PER_METER) * config.sample_rate + 0.5)
            ) + 8
            bucket = min(length, max(4096, 1 << (need - 1).bit_length()))
        profiling.count("finalize.bucket", bucket)
        if bucket < length:
            hist = hist[..., :bucket].contiguous()
        params, flips, nfft, filter_method = device_filter_params(
            config.filter, float(config.sample_rate), float(config.hipass), bucket,
            str(dev), _finalize_method(config.filter),
        )

        hist, content_len = _finalize_hist(
            hist,
            imgs,
            mic_t,
            spec,
            predelay,
            config.sample_rate,
            length=bucket,
            include_images=include_images,
            remove_direct=remove_direct,
        )
        mixed, trim_len = _finalize_filter(
            hist[None],
            content_len.reshape(1),
            params,
            config.volume_scale,
            flips=flips,
            nfft=nfft,
            do_normalize=config.normalize,
            filter_method=filter_method,
        )
        if filter_method == "fir":
            # the sinc bank grows the IR (FastConvolution, filters.h:55-80)
            from .filters import KERNEL_LENGTH

            content_len = content_len + KERNEL_LENGTH - 1

    with profiling.span("rv.pull"):
        profiling.stage()
        with profiling.span("rv.sync", site="content"):
            content = int(content_len)
            trim = int(trim_len[0])
        out_len = min(trim, content) if config.trim_tail else content
        with profiling.span("rv.sync", site="pull"):
            channels = mixed[0].cpu().numpy()[:, :out_len].astype(np.float32)
    info = {
        "predelay": predelay or 0.0,
        "histogram_length": length,
        "content_length": content,
        "trim_length": trim,
        "max_diffuse_time": max_t,
        "filter_method": filter_method,
        "device": str(dev),
    }
    return channels, info
