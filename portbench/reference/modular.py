"""The plain reference of the modular pipeline: the published raytracer's
stages one by one (reuk/parallel-reverb-raytracer cmd/main.cpp:241-337:
Raytracer::raytrace, getAllRaw with its image dedup, the speaker or HRTF
attenuation, fixPredelay, flattenImpulses and process), which the port
runs as ``--pipeline modular``. It imports nothing of the program and no
JAX.

reference/render.py's trace, image dedup (``distinct_images``, under each
ray order of RAY_ORDERS) and attenuation (``_channel``) are used unchanged.
This module adds the modular pipeline's own conventions, where the fused
render and reference/render.py shift whole bins and size the histogram by
a power-of-two bound:

  - the population: every diffuse row of every ray and reflection, then
    the distinct image records (getAllRaw, rayverb.cpp:708-714)
  - per-arrival predelay (findPredelay and fixPredelay, rayverb.h:49-97):
    with trim_predelay the earliest time above 0 over every channel's
    attenuated arrivals is subtracted from each arrival, and times at or
    below it become 0, before binning
  - the histogram's length from the last arrival, floor(t * sr + 0.5) + 1
    (flattenImpulses, rayverb.cpp:53-57), shared by every channel
  - the crossover bank: Linkwitz-Riley (RayverbFiltering::filter,
    filters.cpp:230-266) per band the second-order Butterworth low-pass at
    its upper edge forward and then reversed, then the high-pass at its
    lower edge forward and then reversed (Biquad::twopass, :185-191), each
    pass the direct form II transposed recurrence from zero state
    (Biquad::onepass, :156-168) over the whole histogram, so that samples at
    and after the content are zeroed after each pass; the biquad banks as
    reference/biquad.py gives them
  - mixdown, normalisation of all channels together to a peak of 1, the
    volume scale, and the tail trim after the last sample of magnitude 1e-5
    or more, with the published off-by-one (that sample itself is cut,
    rayverb.cpp:96-122)

Departures from the published code:

  - the filters run in float64 with float64 coefficients, applied as their
    frequency responses on an FFT grid long enough that nothing wraps
    (reference/render.py's ``_filter``); ``recurrence`` is the same bank
    sample by sample, and the tests hold the two together
  - an arrival of zero volume is written as zeros (volume and time) where
    the published code skips it: it takes no part in the predelay or the
    length, and bins nothing
  - every channel shares one histogram length, the longest (the published
    code sizes each channel by its own last arrival)
  - image chains are identified by triangle indices, the first ray in the
    order keeping its record (reference/render.py)

``dtype`` sets the arithmetic as in reference/render.py: float32, as the
configurations state, or bfloat16 for the lower-precision control (the
filters then round each pass's signal to bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import biquad
from . import render as base


def filter_passes(doc: dict, sr: float):
    """[(coefficients (8, 5) b0 b1 b2 a1 a2, reversed)] of the
    configuration's crossover: Linkwitz-Riley, or a biquad bank."""
    kind = doc.get("filter", "onepass")
    if kind == "linkwitz_riley":
        return base.filter_passes(kind, sr, biquad.hipass(doc))
    return biquad.filter_passes(kind, sr, biquad.hipass(doc))


def recurrence(x, passes) -> np.ndarray:
    """The bank's passes over x (..., 8, L) as the published recurrence in
    float64, band b with coeffs[b]: direct form II transposed from zero
    state, out = x b0 + z1, z1 = x b1 + z2 - a1 out, z2 = x b2 - a2 out, a
    reversed pass from the last sample back to the first."""
    y = np.array(x, np.float64)
    for coeffs, reverse in passes:
        b0, b1, b2, a1, a2 = (np.asarray(coeffs, np.float64)[:, k] for k in range(5))
        src = y
        y = np.zeros_like(src)
        z1 = np.zeros(src.shape[:-1])
        z2 = np.zeros(src.shape[:-1])
        steps = range(src.shape[-1] - 1, -1, -1) if reverse else range(src.shape[-1])
        for i in steps:
            xi = src[..., i]
            out = xi * b0 + z1
            z1 = xi * b1 + z2 - a1 * out
            z2 = xi * b2 - a2 * out
            y[..., i] = out
    return y


def attenuate(model: dict, mic, vol, pos, times):
    """(C, M, 8) volumes and (C, M) times of the arrivals at each channel;
    an arrival of zero volume stays zero, with time 0."""
    nonzero = torch.any(vol != 0, dim=-1)
    vols, ts = [], []
    for c in range(model["channels"]):
        gain, tc = base._channel(model, mic, pos, times, c)
        vols.append(torch.where(nonzero[:, None], vol * gain, torch.zeros_like(vol)))
        ts.append(torch.where(nonzero, tc, torch.zeros_like(tc)))
    return torch.stack(vols), torch.stack(ts)


def fix_predelay(times):
    """(times less the predelay, clamped at 0; the predelay): the earliest
    time above 0 over every channel, subtracted from each arrival."""
    live = times > 0
    if not bool(torch.any(live)):
        return times, 0.0
    pre = torch.amin(times[live])
    return torch.where(times > pre, times - pre, torch.zeros_like(times)), float(pre)


def histogram(vols, times, sr: float):
    """(C, 8, L) of the arrivals, L = floor(t * sr + 0.5) + 1 of the last
    arrival over every channel; an arrival at time t lands in sample
    floor(t * sr + 0.5), in the arithmetic of its times."""
    last = float(torch.amax(times)) if times.numel() else 0.0
    length = max(1, int(math.floor(last * sr + 0.5)) + 1)
    idx = torch.floor(times * np.float32(sr) + 0.5).to(torch.int64)
    hist = torch.zeros((vols.shape[0], base.NUM_BANDS, length), dtype=vols.dtype,
                       device=vols.device)
    for c in range(vols.shape[0]):
        keep = (idx[c] >= 0) & (idx[c] < length)
        hist[c].index_add_(1, idx[c][keep], vols[c][keep].T)
    return hist


def finish(doc: dict, hist, sr: float, dt) -> np.ndarray:
    """The (C, 8, L) histogram to the (C, T) response: the bank over the
    whole histogram, mixdown, normalisation, volume, tail trim."""
    length = hist.shape[-1]
    content = torch.tensor([length], device=hist.device)
    mixed = base._filter(hist[None], content, filter_passes(doc, sr), dt)[0]
    if doc.get("normalize", True):
        peak = mixed.abs().amax()
        mixed = mixed * torch.where(peak > 0, 1.0 / peak, torch.ones_like(peak))
    mixed = mixed * float(doc.get("volumme_scale", 1.0))
    if dt != torch.float32:
        mixed = mixed.to(dt).to(torch.float64)
    out = mixed.cpu().numpy()
    if doc.get("trim_tail", True):
        loud = np.abs(out) >= base.TRIM_FLOOR
        last = max(int(np.nonzero(ch)[0][-1]) if ch.any() else -1 for ch in loud)
        out = out[:, :max(last, 0)]
    return out


def render(scene: base.Scene, doc: dict, sources, mics, dirs, hrtf_table=None, tick=None,
           orders=base.RAY_ORDERS):
    """The modular pipeline's impulse response of one pair: sources, mics
    (1, 3) and dirs (1, N, 3) numpy float32; doc the configuration
    document. Returns, for each ray order of ``orders``, (1, C, T) float64
    numpy. ``tick`` is called once per bounce."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt, dev = scene.dtype, scene.device
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device=dev, dtype=dt)  # noqa: E731
    dirs = np.asarray(dirs, np.float32)
    b, n = dirs.shape[:2]
    if b != 1:
        raise ValueError("the modular reference renders one pair at a time")
    sr = float(doc["sample_rate"])
    mics_t, srcs_t = f(mics), f(sources)
    pair = torch.zeros((n,), dtype=torch.int64, device=dev)
    model = base.attenuation_model(doc, hrtf_table, dt, dev)
    mode = doc.get("output_mode", "all")
    diffuse, images = base.trace(scene, mics_t, srcs_t, pair, f(dirs[0]),
                                 int(doc["reflections"]), tick)
    outs = []
    for order in orders:
        rows = [diffuse[:3]] if mode in ("all", "diffuse_only") else []
        if mode in ("all", "image_only"):
            rank = torch.from_numpy(base.ray_rank(order, dirs[0])).to(dev)
            keep = base.distinct_images(images, pair, bool(doc.get("remove_direct", False)),
                                        rank)
            vol, pos, time_, _ = images
            rows.append((vol.reshape(-1, base.NUM_BANDS)[keep], pos.reshape(-1, 3)[keep],
                         time_.reshape(-1)[keep]))
        vol, pos, times = (torch.cat([r[i] for r in rows]) for i in range(3))
        vols, times = attenuate(model, mics_t[0], vol, pos, times)
        del vol, pos
        if doc.get("trim_predelay", False):
            times, _ = fix_predelay(times)
        hist = histogram(vols, times, sr)
        del vols, times
        outs.append(finish(doc, hist, sr, dt)[None])
    return outs
