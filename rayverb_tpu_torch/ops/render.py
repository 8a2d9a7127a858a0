"""Fused render: trace -> attenuate -> histogram -> filter, with nothing
but the finished IR leaving the device (PyTorch counterpart of
rayverb_tpu/ops/render.py::render_fused, :1157).

  trace + bin  = one pass over ALL rays (``_fused_trace_bin``): the trace's
                 diffuse rows are collected per bounce and binned at once by
                 the scatter-free sorted binning (sort rows by bin, segmented
                 suffix sums, dense histogram by searchsorted); per-ray image
                 records carry 32-bit chain hashes for the dedup
  finalize     = cross-ray image dedup (sort by chain hash, keep first),
                 image attenuation + binning, predelay shift, content length
                 (``_finalize_hist``); crossover filter bank as FFT passes,
                 mixdown, normalise, volume, trim length (``_finalize_filter``)

The JAX render splits large populations into chunked, segmented programs
to bound TPU program size and run time; here the render is always one pass
(chunking for memory is not ported yet). Speaker attenuation only: HRTF
attenuation is not ported yet.

Documented deviations from the reference are those of the JAX render
(hash-pair chain identity, whole-bin predelay shift, power-of-two histogram
bound).
"""

from __future__ import annotations

import time
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
from ..utils.directions import morton_sort
from .filters import _band_coeffs, _fft_len
from .intersect import TriangleSoup, soup_from_scene
from .trace import _trace_impl, sweep_count

MAX_HIST_LEN = 1 << 23  # ~190 s at 44.1 kHz; hard cap on the static bound

RAY_BLOCK_SORT = 512  # Morton-sort rays once several thread blocks are in play

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
# speaker attenuation
# ---------------------------------------------------------------------------

def _safe_normalize(v):
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.where(mag > 0, mag, 1.0)


def _speaker_gain(mic, positions, direction, coefficient):
    """(1-c) + c*cos (kernel.cpp:505-513)."""
    return (1.0 - coefficient) + coefficient * torch.sum(
        _safe_normalize(positions - mic) * _safe_normalize(direction), dim=-1
    )


class AttenSpec(NamedTuple):
    """Speaker attenuation parameters on the render's device."""

    nchannels: int
    speaker_dirs: torch.Tensor    # (C, 3)
    speaker_coeffs: torch.Tensor  # (C,)


def make_atten_spec(model, device="cpu") -> AttenSpec:
    if model.is_hrtf:
        raise NotImplementedError("HRTF attenuation is not ported yet")
    dirs = np.stack([np.asarray(s.direction, np.float32) for s in model.speakers])
    coeffs = np.asarray([s.shape for s in model.speakers], np.float32)
    return AttenSpec(
        nchannels=len(model.speakers),
        speaker_dirs=torch.from_numpy(dirs).to(device),
        speaker_coeffs=torch.from_numpy(coeffs).to(device),
    )


def _time_bins(times, sample_rate):
    """Bin index floor(t * sr + 0.5) in float32, int64."""
    return torch.floor(times * np.float32(sample_rate) + 0.5).to(torch.int64)


def _attenuate_and_bin(mic, volumes, positions, times, spec: AttenSpec,
                       length: int, sample_rate):
    """(M, 8) impulses -> (C, 8, length) histogram by scatter-add
    (flattenImpulses, rayverb.cpp:48-77). Zero-volume impulses and bins
    outside [0, length) contribute nothing."""
    nonzero = torch.any(volumes != 0, dim=-1)
    idx = _time_bins(times, sample_rate)
    keep = nonzero & (idx >= 0) & (idx < length)
    idx = idx[keep]
    vol = volumes[keep]
    pos = positions[keep]
    hists = []
    for c in range(spec.nchannels):
        gain = _speaker_gain(mic, pos, spec.speaker_dirs[c], spec.speaker_coeffs[c])
        hist = torch.zeros((NUM_BANDS, length), device=volumes.device)
        hist.index_add_(1, idx, (vol * gain[:, None]).T)
        hists.append(hist)
    return torch.stack(hists)


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


def _bin_rows_sorted(mic, volumes, positions, times, spec: AttenSpec,
                     length: int, sample_rate):
    """Scatter-free binning of all diffuse rows (render.py:300-368):
    returns ((C, 8, length) histogram, min time, max time) as 0-dim
    tensors. One stable sort by bin serves every speaker channel."""
    nonzero = torch.any(volumes != 0, dim=-1)
    min_t = torch.amin(torch.where(nonzero & (times > 0), times, float("inf")))
    max_t = torch.amax(torch.where(nonzero, times, 0.0))
    idx = _time_bins(times, sample_rate)
    key = torch.where(nonzero & (idx >= 0) & (idx < length), idx, length)
    perm = torch.argsort(key, stable=True)
    sk = key[perm]
    svol = volumes[perm]
    spos = positions[perm]
    hists = []
    for c in range(spec.nchannels):
        gain = _speaker_gain(mic, spos, spec.speaker_dirs[c], spec.speaker_coeffs[c])
        hists.append(
            _dense_from_runs(
                sk, _segmented_run_totals(sk, svol * gain[:, None]), length
            )
        )
    return torch.stack(hists), min_t, max_t


class _Images(NamedTuple):
    volume: torch.Tensor    # (N, S, 8)
    position: torch.Tensor  # (N, S, 3)
    time: torch.Tensor      # (N, S)
    slot: torch.Tensor      # (N, S) int64
    valid: torch.Tensor     # (N, S) bool (reference map-admission rule)
    h1: torch.Tensor        # (N, S) int64 uint32 hash
    h2: torch.Tensor        # (N, S)


def _fused_trace_bin(soup, mic, source, directions, spec: AttenSpec, *,
                     nreflections: int, length: int, sample_rate, impl: str,
                     include_diffuse: bool, resort: bool):
    """One pass over all rays (render.py:542-641): trace, collect every
    bounce's diffuse rows, bin them; returns (hist (C,8,L), max_t, min_t,
    images)."""
    dev = soup.device
    rows = []
    images = _trace_impl(
        soup,
        mic,
        source,
        directions,
        nreflections=nreflections,
        impl=impl,
        consume_row=rows.append if include_diffuse else lambda row: None,
        resort=resort,
    )
    mic_t = torch.as_tensor(np.asarray(mic, np.float32), device=dev)
    if rows:
        # (R, N, .) bounce-major, as the JAX row buffers
        vol = torch.stack([r[0] for r in rows]).reshape(-1, NUM_BANDS)
        pos = torch.stack([r[1] for r in rows]).reshape(-1, 3)
        tim = torch.stack([r[2] for r in rows]).reshape(-1)
        rows.clear()
        hist, min_t, max_t = _bin_rows_sorted(
            mic_t, vol, pos, tim, spec, length, sample_rate
        )
    else:
        # without the diffuse population, it takes no part in predelay
        hist = torch.zeros((spec.nchannels, NUM_BANDS, length), device=dev)
        min_t = torch.tensor(float("inf"), device=dev)
        max_t = torch.zeros((), device=dev)
    img_vol, img_pos, img_time, img_idx = images
    h1, h2 = chain_hashes(img_idx)
    slots = torch.arange(NUM_IMAGE_SOURCE, device=dev).expand(img_idx.shape)
    valid = (slots == 0) | (img_idx != 0)
    return hist, max_t, min_t, _Images(img_vol, img_pos, img_time, slots, valid, h1, h2)


def _image_time_stats(imgs: _Images, remove_direct: bool):
    """(earliest, latest) image time over the admitted population
    (render.py:1506-1547); duplicates share times, so pre-dedup is exact."""
    ok = imgs.valid & torch.any(imgs.volume != 0, dim=-1)
    if remove_direct:
        ok = ok & (imgs.slot != 0)
    times = imgs.time.reshape(-1)
    ok = ok.reshape(-1)
    min_t = torch.amin(torch.where(ok & (times > 0), times, float("inf")))
    max_t = torch.amax(torch.where(ok, times, 0.0))
    return min_t, max_t


def _finalize_hist(hist, imgs: _Images, mic, spec: AttenSpec, predelay,
                   sample_rate, *, length: int, include_images: bool,
                   remove_direct: bool):
    """Image dedup + binning, predelay shift, content length
    (render.py:828-936). Returns (hist, content_len 0-dim int64)."""
    dev = hist.device
    if include_images:
        m = imgs.h1.numel()
        valid = imgs.valid.reshape(m)
        if remove_direct:
            valid = valid & (imgs.slot.reshape(m) != 0)
        # the admitted rows, in row order (the JAX img_cap compaction,
        # exact here because the shape may depend on the data)
        rows = torch.nonzero(valid).squeeze(1)
        k1 = imgs.h1.reshape(m)[rows]
        k2 = imgs.h2.reshape(m)[rows]
        # lexicographic (h1, h2) order: stable sort by the minor key, then
        # by the major key
        perm = torch.argsort(k2, stable=True)
        perm = perm[torch.argsort(k1[perm], stable=True)]
        s1 = k1[perm]
        s2 = k2[perm]
        first = torch.ones_like(s1, dtype=torch.bool)
        first[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
        chosen = torch.sort(rows[perm][first]).values  # keep row order
        img_hist = _attenuate_and_bin(
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
                     nfft: int, do_normalize: bool):
    """Crossover filter bank as flip-free FFT passes (reversed passes carry
    pre-conjugated responses), mixdown, normalise, volume, trim length
    (render.py:943-1029, method 'fft'). After every pass, samples at or
    after the content length are zeroed."""
    out = hist
    t = out.shape[-1]
    in_content = (torch.arange(t, device=out.device) < content_len).to(out.dtype)
    for p in range(responses.shape[0]):
        resp = torch.complex(responses[p, ..., 0], responses[p, ..., 1])
        spec_f = torch.fft.rfft(out, n=nfft)
        out = torch.fft.irfft(spec_f * resp, n=nfft)[..., :t]
        out = out * in_content
    mixed = torch.sum(out, dim=-2)  # (C, L)
    if do_normalize:
        peak = torch.amax(torch.abs(mixed))
        mixed = mixed * torch.where(peak > 0, 1.0 / peak, 1.0)
    mixed = mixed * np.float32(volume_scale)
    positions = torch.arange(mixed.shape[-1], device=mixed.device)[None, :]
    loud = (torch.abs(mixed) >= TRIM_TAIL_FLOOR) & (positions < content_len)
    last = torch.amax(torch.where(loud, positions, -1))
    trim_len = torch.clamp(last, min=0)
    return mixed, trim_len


def finalize_filter_params(filter_type, sample_rate: float, lo_cutoff: float,
                           length: int):
    """Host-side (P, 8, nfft//2+1, 2) float32 (re, im) responses of the
    filter passes on the rFFT grid, reversed passes pre-conjugated; returns
    (params, nfft). Cached per (filter, sr, cutoff, length)
    (render.py:1032-1122, method 'fft')."""
    return _finalize_filter_params_cached(
        filter_type, float(sample_rate), float(lo_cutoff), int(length)
    )


@lru_cache(maxsize=16)
def _finalize_filter_params_cached(filter_type, sample_rate: float,
                                   lo_cutoff: float, length: int):
    if filter_type == FilterType.WINDOWED_SINC:
        raise NotImplementedError(
            "the windowed-sinc (fir) finalize is not ported yet"
        )
    passes = _band_coeffs(filter_type, sample_rate, lo_cutoff)
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
    return params, nfft


@lru_cache(maxsize=4)
def _device_filter_params(filter_type, sample_rate, lo_cutoff, length, device):
    """finalize_filter_params uploaded to ``device`` once per key (the
    vault's responses are ~134 MB)."""
    params, nfft = finalize_filter_params(filter_type, sample_rate, lo_cutoff, length)
    return torch.from_numpy(params).to(device), nfft


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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_fused(
    scene,
    config: RenderConfig,
    directions,
    *,
    impl: str = "auto",
    device=None,
    soup: TriangleSoup | None = None,
    stats: bool = False,
):
    """Full render on ``device`` (default cuda). Returns (channels (C, T')
    float32 numpy, info dict).

    impl: closest-hit implementation, 'auto' | 'cuda' | 'plain' (see
    intersect.closest_hit). With stats=True the info dict gains
    device-synchronised phase walls and issued pair tests."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    timings: dict = {}
    model = config.attenuation_model
    spec = make_atten_spec(model, dev)
    if soup is None:
        soup = soup_from_scene(scene, device=dev)
    length = histogram_length(scene, config.reflections, config.sample_rate)

    directions = np.asarray(directions, dtype=np.float32)
    n = directions.shape[0]
    if n == 0:
        raise ValueError("need at least one ray")
    if n >= 4 * RAY_BLOCK_SORT:
        # coherent bundles let neighbouring threads share triangle tiles;
        # ray order is semantically free
        directions = morton_sort(directions)
    include_diffuse = config.output_mode in (OutputMode.ALL, OutputMode.DIFFUSE_ONLY)
    include_images = config.output_mode in (OutputMode.ALL, OutputMode.IMAGE_ONLY)
    # per-bounce re-sorting of the sweep rows (semantically invisible) pays
    # once the population fills many thread blocks and the table has enough
    # blocks to cull: the JAX render's rule
    resort = n >= 4096 and soup.block_aabb.shape[0] >= 32

    hist, max_t_dev, min_t_dev, imgs = _fused_trace_bin(
        soup,
        config.mic_position,
        config.source_position,
        directions,
        spec,
        nreflections=config.reflections,
        length=length,
        sample_rate=config.sample_rate,
        impl=impl,
        include_diffuse=include_diffuse,
        resort=resort,
    )
    if stats:
        _sync(dev)
        timings["trace_bin"] = time.perf_counter() - t_start
        t_mark = time.perf_counter()
    max_t = float(max_t_dev)
    min_t = float(min_t_dev)

    # direct-path + image times take part in predelay like the reference's
    # findPredelay over attenuated impulses (rayverb.h:49-73)
    if include_images:
        img_min, img_max = _image_time_stats(imgs, config.remove_direct)
        min_t = min(min_t, float(img_min))
        max_t = max(max_t, float(img_max))

    predelay = None
    if config.trim_predelay and np.isfinite(min_t):
        predelay = float(min_t)
    if stats:
        timings["time_stats"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()

    # finalize over a power-of-two bucket that covers the actual content
    bucket = length
    if max_t > 0:
        need = int(
            np.floor((max_t + 0.1 * SECONDS_PER_METER) * config.sample_rate + 0.5)
        ) + 8
        bucket = min(length, max(4096, 1 << (need - 1).bit_length()))
    if bucket < length:
        hist = hist[..., :bucket].contiguous()
    params, nfft = _device_filter_params(
        config.filter, float(config.sample_rate), float(config.hipass), bucket,
        str(dev),
    )

    mic_t = torch.as_tensor(np.asarray(config.mic_position, np.float32), device=dev)
    hist, content_len = _finalize_hist(
        hist,
        imgs,
        mic_t,
        spec,
        predelay,
        config.sample_rate,
        length=bucket,
        include_images=include_images,
        remove_direct=config.remove_direct,
    )
    mixed, trim_len = _finalize_filter(
        hist,
        content_len,
        params,
        config.volume_scale,
        nfft=nfft,
        do_normalize=config.normalize,
    )
    if stats:
        _sync(dev)
        timings["finalize"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()

    content = int(content_len)
    trim = int(trim_len)
    out_len = min(trim, content) if config.trim_tail else content
    channels = mixed.cpu().numpy()[:, :out_len].astype(np.float32)
    info = {
        "predelay": predelay or 0.0,
        "histogram_length": length,
        "content_length": content,
        "trim_length": trim,
        "max_diffuse_time": max_t,
        "sweeps": sweep_count(config.reflections),
        "device": str(dev),
    }
    if stats:
        timings["pull"] = time.perf_counter() - t_mark
        total = time.perf_counter() - t_start
        timings["total"] = total
        pairs = sweep_pair_tests(n, soup.num_padded, config.reflections)
        info["timings"] = timings
        info["pair_tests_issued"] = pairs
        info["pair_tests_per_s"] = pairs / max(timings["trace_bin"], 1e-9)
        info["ray_bounces_per_s"] = n * config.reflections / max(total, 1e-9)
    return channels, info
