"""The plain reference render with the biquad crossovers: the one-pass and
the two-pass band-pass banks of the published raytracer (filters.cpp:156-228,
RayverbFiltering::filter :268-306), which reference/render.py lacks. The
trace, the image dedup, the binning and the frequency-domain filter are
reference/render.py's, used unchanged; this module adds the passes of the
two banks and the finish that applies them. It imports nothing of the
program and no JAX.

  - each band is the RBJ cookbook's constant-skirt band-pass between the
    band's edges (filters.cpp:193-218): centre c = sqrt(lo * hi), w = 2 pi c
    / sr, bandwidth log2(hi / lo) octaves, q = sin w / (ln 2 * bandwidth *
    w), alpha = sin w * sinh(1 / (2 q)); b = (alpha, 0, -alpha) / (1 +
    alpha), a = (-2 cos w, 1 - alpha) / (1 + alpha)
  - ``onepass`` runs the bank forward (Biquad::onepass, filters.cpp:156-168);
    ``twopass`` forward and then reversed, over the forward pass's output
    (Biquad::twopass, filters.cpp:185-191): a zero-phase response
  - the band edges are reference/render.py's: {hipass, 175, 350, ..., 20000}
    below 0.49 of the sample rate
  - ``"hipass": false``, which three of the upstream demo configurations
    write, keeps the default cutoff of 45 Hz (cmd/main.cpp:140-157), as the
    rebuild's configuration schema reads it; the published reader would
    reject the configuration

As in reference/render.py, ``dtype`` sets the arithmetic (float32, or
bfloat16 for the lower-precision control) and the filters run in float64,
each pass's signal rounded to ``dtype`` where it is not float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import render as base

DEFAULT_HIPASS = 45.0


def hipass(doc: dict) -> float:
    """The lowest band edge of a configuration document: its ``hipass``, or
    DEFAULT_HIPASS where it is absent or false."""
    value = doc.get("hipass", DEFAULT_HIPASS)
    return DEFAULT_HIPASS if value is False else float(value)


def bandpass_rows(sr: float, lo_cutoff: float) -> np.ndarray:
    """(8, 5) b0 b1 b2 a1 a2 of the constant-skirt band-pass of each band."""
    edges = base.band_edges(lo_cutoff, sr)
    rows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        w = 2 * math.pi * math.sqrt(lo * hi) / sr
        q = math.sin(w) / (math.log(2) * math.log2(hi / lo) * w)
        alpha = math.sin(w) * math.sinh(1 / (2 * q))
        a0 = 1 + alpha
        rows.append((alpha / a0, 0.0, -alpha / a0, -2 * math.cos(w) / a0, (1 - alpha) / a0))
    return np.array(rows)


def filter_passes(kind: str, sr: float, lo_cutoff: float):
    """[(coefficients (8, 5), reversed)] of the biquad bank ``kind``."""
    rows = bandpass_rows(sr, lo_cutoff)
    if kind == "onepass":
        return [(rows, False)]
    if kind == "twopass":
        return [(rows, False), (rows, True)]
    raise ValueError(f"the biquad reference has no filter {kind!r}")


def render(scene: base.Scene, doc: dict, sources, mics, dirs, hrtf_table=None, tick=None,
           orders=base.RAY_ORDERS):
    """reference/render.py's ``render`` with the configuration's biquad
    bank: for each ray order of ``orders``, (B, C, L) float64 numpy."""
    dt, dev = scene.dtype, scene.device
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device=dev, dtype=dt)  # noqa: E731
    dirs = np.asarray(dirs, np.float32)
    b, n = dirs.shape[:2]
    sr = float(doc["sample_rate"])
    refl = int(doc["reflections"])
    mics_t, srcs_t = f(mics), f(sources)
    pair = torch.arange(b, device=dev).repeat_interleave(n)
    model = base.attenuation_model(doc, hrtf_table, dt, dev)
    length = base.histogram_length(scene.bounds, refl, sr)
    mode = doc.get("output_mode", "all")
    diffuse, images = base.trace(scene, mics_t, srcs_t, pair, f(dirs.reshape(b * n, 3)), refl,
                                 tick)

    hist0 = torch.zeros((b, model["channels"], base.NUM_BANDS, length), dtype=dt, device=dev)
    tmin0 = torch.full((b,), float("inf"), device=dev)
    tmax0 = torch.zeros((b,), device=dev)
    if mode in ("all", "diffuse_only"):
        base._bin(model, mics_t, diffuse[3], *diffuse[:3], hist0, sr, tmin0, tmax0)
    del diffuse
    outs = []
    for order in orders:
        hist, tmin, tmax = hist0.clone(), tmin0.clone(), tmax0.clone()
        if mode in ("all", "image_only"):
            rank = np.concatenate([p * n + base.ray_rank(order, dirs[p]) for p in range(b)])
            keep = base.distinct_images(images, pair, bool(doc.get("remove_direct", False)),
                                        torch.from_numpy(rank).to(dev))
            vol, pos, time_, _ = images
            base._bin(model, mics_t, pair[keep // base.NUM_IMAGE],
                      vol.reshape(-1, base.NUM_BANDS)[keep], pos.reshape(-1, 3)[keep],
                      time_.reshape(-1)[keep], hist, sr, tmin, tmax)
        outs.append(finish(doc, hist, tmin, sr, dt))
    return outs


def finish(doc: dict, hist, tmin, sr: float, dt):
    """reference/render.py's ``_finish`` (predelay trim, filters,
    normalisation, volume, tail trim) with the biquad bank's passes."""
    b, length = hist.shape[0], hist.shape[-1]
    dev = hist.device
    positions = torch.arange(length, device=dev)
    if doc.get("trim_predelay", False):
        pre = torch.where(torch.isfinite(tmin), tmin, 0.0)
        shift = torch.floor(pre * np.float32(sr) + np.float32(0.5)).to(torch.int64)
        src = positions[None, :] + shift[:, None]  # (B, L)
        h = hist.reshape(b, -1, length)
        moved = torch.gather(h, 2, torch.clamp(src, 0, length - 1)[:, None, :].expand(h.shape))
        moved = torch.where(src[:, None, :] < length, moved, torch.zeros_like(moved))
        moved[..., 0] = torch.sum(torch.where(positions[None, None, :] <= shift[:, None, None], h,
                                              torch.zeros_like(h)), dim=-1)
        hist = moved.reshape(hist.shape)
    occupied = torch.any(torch.any(hist != 0, dim=2), dim=1)  # (B, L)
    content = torch.amax(torch.where(occupied, positions, -1), dim=-1) + 1
    passes = filter_passes(doc.get("filter", "onepass"), sr, hipass(doc))
    mixed = base._filter(hist, content, passes, dt)
    if doc.get("normalize", True):
        peak = mixed.abs().amax(dim=(1, 2), keepdim=True)
        mixed = mixed * torch.where(peak > 0, 1.0 / peak, torch.ones_like(peak))
    mixed = mixed * float(doc.get("volumme_scale", 1.0))
    if dt != torch.float32:
        mixed = mixed.to(dt).to(torch.float64)
    out = mixed.cpu().numpy()
    if doc.get("trim_tail", True):
        if b != 1:
            raise ValueError("trim_tail cuts one pair's response only")
        cnt = int(content[0])
        loud = (np.abs(out[0]) >= base.TRIM_FLOOR) & (np.arange(out.shape[-1]) < cnt)
        last = int(np.max(np.where(loud, np.arange(out.shape[-1]), -1)))
        out = out[:, :, :min(max(last, 0), cnt)]
    return out
