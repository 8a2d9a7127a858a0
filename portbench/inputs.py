"""The benchmark's inputs, made from ``--seed``: ray directions, source and
mic pairs, the HRTF table and the scene files. Each generator is a frozen
copy of the repository's own (or draws as it does), named with the file
and commit it was taken from, so that later changes to the program do not
move the yardstick. Both the program and the reference receive what these
functions return.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
SOURCE_COMMIT = "eea2a64cd0196306bd927c9d58cc9bb86ca59de2"

NUM_BANDS = 8
HRTF_BAND_EDGES = (0.0, 190.0, 380.0, 760.0, 1520.0, 3040.0, 6080.0, 12160.0, 20000.0)
SPEED_OF_SOUND = 340.0


def directions(count: int, rays: int, seed, device) -> np.ndarray:
    """(count, rays, 3) float32 unit vectors, uniform on the sphere, made on
    ``device`` in one call of a torch.Generator seeded from ``seed`` (a
    numpy SeedSequence) and brought to the host: z uniform in [-1, 1), the
    azimuth uniform in [-pi, pi), as rayverb_tpu_torch/utils/directions.py::
    random_directions draws them (commit SOURCE_COMMIT). On the card a pool
    of a window's inputs takes milliseconds, where the numpy draw takes
    0.12 s per million rays on the host."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
    u = torch.rand((2, count, rays), generator=gen, device=device, dtype=torch.float32)
    z = 2.0 * u[0] - 1.0
    theta = np.float32(np.pi) * (2.0 * u[1] - 1.0)
    zt = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([zt * torch.cos(theta), zt * torch.sin(theta), z], dim=-1).cpu().numpy()


def unit_seed(seed: int, index: int, stream: int = 0) -> np.random.SeedSequence:
    """The seed of pool entry ``index`` of a run seeded ``seed``."""
    return np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(index), int(stream)])


def datagen_pairs(bounds, pairs: int, seed) -> tuple:
    """Config 5's pairs: sources and mics at 20-80 % of the scene's bounds.
    Frozen copy of chip_smoke.py::_datagen_inputs (commit SOURCE_COMMIT;
    there default_rng(17)), drawn from ``seed``; the ray sets come from
    ``directions``."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bounds, np.float32)
    span = hi - lo
    sources = (lo + span * (0.2 + 0.6 * rng.random((pairs, 3)))).astype(np.float32)
    mics = (lo + span * (0.2 + 0.6 * rng.random((pairs, 3)))).astype(np.float32)
    return sources, mics


# ---------------------------------------------------------------------------
# the HRTF table: frozen copy of rayverb_tpu_torch/hrtf/table.py
# (interpolate_measurements, _head_shadow_power, synthetic_measurements,
# default_table; commit SOURCE_COMMIT)
# ---------------------------------------------------------------------------

def _interpolate(entries) -> np.ndarray:
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
        lo = np.zeros_like(q)
        hi = np.full_like(q, top)
        if measured.size:
            i = np.searchsorted(measured, q, side="right")
            has_lo = i > 0
            lo = np.where(has_lo, measured[np.clip(i - 1, 0, None)], 0)
            has_hi = i < measured.size
            hi = np.where(has_hi, measured[np.clip(i, None, measured.size - 1)], top)
        return lo, hi

    aq = np.arange(360)
    eq = np.arange(180)
    a_min, a_max = brackets(aq, a_measured, 360)
    e_min, e_max = brackets(eq, e_measured, 180)
    a_ratio = (aq - a_min) / (a_max - a_min).astype(np.float64)
    e_ratio = (eq - e_min) / (e_max - e_min).astype(np.float64)
    am = a_min[:, None]
    ax = a_max[:, None] % 360
    em = e_min[None, :]
    ex = e_max[None, :]
    c00 = dense[am, em]
    c10 = dense[ax, em]
    c01 = dense[am, ex]
    c11 = dense[ax, ex]
    ar = a_ratio[:, None, None, None]
    er = e_ratio[None, :, None, None]
    a0 = c00 + (c10 - c00) * ar
    a1 = c01 + (c11 - c01) * ar
    out = a0 + (a1 - a0) * er
    return np.ascontiguousarray(out.transpose(2, 0, 1, 3)).astype(np.float32)


def _head_shadow_power(freqs, theta_deg):
    w0 = SPEED_OF_SOUND / 0.0875
    alpha = (1 + 0.1 / 2.0) + (1 - 0.1 / 2.0) * np.cos(np.radians(theta_deg) * (180.0 / 150.0))
    w = 2 * np.pi * freqs
    return (1 + (alpha[..., None] * w / (2 * w0)) ** 2) / (1 + (w / (2 * w0)) ** 2)


def hrtf_table(step: int = 15, n: int = 512, sample_rate: float = 44100.0) -> np.ndarray:
    """The (2, 360, 180, 8) table of 8-band ear gains: the Brown-Duda
    spherical-head model on a 15-degree grid, band-reduced and bilinearly
    interpolated (the program's default table, bit for bit)."""
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    bounds = [int(f * n // sample_rate) for f in HRTF_BAND_EDGES]
    entries = []
    for a in range(0, 361, step):
        for e in range(0, 181, step):
            phi = np.radians(a - 180.0)
            th = np.radians(90.0 - e)
            d = np.array([np.sin(phi) * np.cos(th), np.sin(th), np.cos(phi) * np.cos(th)])
            gains = []
            for ear_x in (-1.0, 1.0):
                cos_inc = np.clip(d @ np.array([ear_x, 0.0, 0.0]), -1, 1)
                power = _head_shadow_power(freqs, np.asarray(np.degrees(np.arccos(cos_inc))))
                g = np.zeros(NUM_BANDS)
                for b in range(NUM_BANDS):
                    lo, hi = bounds[b], bounds[b + 1]
                    if hi > lo:
                        g[b] = power[lo:hi].mean()
                gains.append(g)
            entries.append(((a, e), gains[0], gains[1]))
    return _interpolate(entries)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def scene_files(config: dict) -> tuple:
    """(OBJ path, materials path) of a configuration, given relative to
    portbench/ (the scene files of the repository's assets/ are read where
    they are); a generated scene is written once into the fixed cache
    directory (atomically, so a run cut short leaves no half file)."""
    scene = config["scene"]
    materials = os.path.normpath(os.path.join(HERE, scene["materials"]))
    if "obj" in scene:
        return os.path.normpath(os.path.join(HERE, scene["obj"])), materials
    gen = scene["generator"]
    path = os.path.join(CACHE, f"{gen['name']}-{gen['triangles']}.obj")
    if not os.path.exists(path):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "gen_hall", os.path.join(HERE, gen["module"]))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.part"
        mod.generate(tmp, gen["triangles"])
        os.replace(tmp, path)
    return path, materials


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
