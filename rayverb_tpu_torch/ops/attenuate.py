"""Microphone attenuation: polar-pattern speakers and multiband HRTF
(PyTorch counterpart of rayverb_tpu/ops/attenuate.py).

The reference's `attenuate` and `hrtf` OpenCL kernels (kernel.cpp:505-625)
and their per-channel host loops (rayverb.cpp:716-892), one pass per
channel. As in the JAX module, zero-volume impulses are written as zeros
(volume and time) where the reference skips them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import HRTF_EAR_OFFSET, SECONDS_PER_METER
from ..device import resolve_device

# float32 degrees per radian, the constant jnp.degrees multiplies by
_DEGREES = np.float32(180.0 / np.pi)


def _safe_normalize(v):
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.where(mag > 0, mag, 1.0)


def _f32(x, device):
    """float32 tensor on ``device`` from a tensor, array or sequence (numpy
    input is copied, so read-only cached tables stay untouched)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def speaker_gain(mic, positions, direction, coefficient):
    """Polar-pattern gain (kernel.cpp:505-513): (1 - c) + c *
    dot(normalize(p - mic), normalize(dir)); 0 omni, 0.5 cardioid, 1
    figure-8 (negative rear lobe kept)."""
    return (1.0 - coefficient) + coefficient * torch.sum(
        _safe_normalize(positions - mic) * _safe_normalize(direction), dim=-1
    )


def speaker_attenuate(mic, volumes, positions, times, direction, coefficient):
    """One speaker (the `attenuate` kernel, kernel.cpp:515-535). Returns
    (volumes_out (M, 8), times_out (M,))."""
    dev = volumes.device
    gain = speaker_gain(_f32(mic, dev), positions, _f32(direction, dev), coefficient)
    nonzero = torch.any(volumes != 0, dim=-1)
    vol_out = torch.where(nonzero[:, None], volumes * gain[:, None], 0.0)
    t_out = torch.where(nonzero, times, 0.0)
    return vol_out, t_out


def speaker_attenuate_all(mic, volumes, positions, times, speakers):
    """Per-speaker channels (rayverb.cpp:838-854). Returns (volumes
    (C, M, 8), times (C, M))."""
    outs = [
        speaker_attenuate(mic, volumes, positions, times, s.direction, float(s.shape))
        for s in speakers
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def head_basis(pointing, up):
    """The head frame's rows (kernel.cpp:537-549): x = normalize(cross(up,
    pointing)), y = cross(pointing, x), z = pointing; (3,) float32 tensors
    in, (3, 3) out."""
    x = _safe_normalize(torch.linalg.cross(up, pointing, dim=-1))
    y = torch.linalg.cross(pointing, x, dim=-1)
    return torch.stack([x, y, pointing])


def hrtf_lookup_indices(transformed):
    """Azimuth/elevation table indices of head-frame directions
    (kernel.cpp:563-584) with the C truncations:

        long a = degrees(atan2(x, z)) + 180;   a %= 360;
        long e = degrees(atan2(y, |xz|));      e = 90 - e;

    Degrees are float32 radians times float32(180/pi), as jnp.degrees
    computes them. ``a`` floors (floor-mod 360, torch.remainder); ``e``
    truncates toward zero before the flip; e == 180 (elevation exactly -90,
    out of bounds in the reference) is clamped to 179."""
    x, y, z = transformed[..., 0], transformed[..., 1], transformed[..., 2]
    az_deg = torch.atan2(x, z) * _DEGREES
    a = torch.remainder(torch.floor(az_deg + 180.0).to(torch.int64), 360)
    el_deg = torch.atan2(y, torch.hypot(x, z)) * _DEGREES
    e = 90 - torch.trunc(el_deg).to(torch.int64)
    return a, torch.clamp(e, 0, 179)


def hrtf_gain_time(mic, positions, times, table, basis, channel: int):
    """One ear's (M, 8) gains and ITD-shifted (M,) times (kernel.cpp:586-625):
    the ear sits at basis @ (-+HRTF_EAR_OFFSET, 0, 0) + mic (channel 0 at
    -x), the head-frame arrival direction indexes ``table``."""
    width = -HRTF_EAR_OFFSET if channel == 0 else HRTF_EAR_OFFSET
    offset = torch.tensor([width, 0.0, 0.0], dtype=torch.float32, device=mic.device)
    ear = basis @ offset + mic
    direction = _safe_normalize(positions - mic)
    a, e = hrtf_lookup_indices(direction @ basis.T)
    gains = table[channel, a, e]
    diff = torch.linalg.norm(positions - ear, dim=-1) - torch.linalg.norm(
        positions - mic, dim=-1
    )
    return gains, times + diff * SECONDS_PER_METER


def hrtf_attenuate_channel(mic, volumes, positions, times, table, pointing, up,
                           channel: int):
    """One ear (the `hrtf` kernel, kernel.cpp:586-625); table (2, 360, 180,
    8). Returns (volumes_out (M, 8), times_out (M,))."""
    dev = volumes.device
    table = _f32(table, dev)
    basis = head_basis(_f32(pointing, dev), _f32(up, dev))
    gains, t = hrtf_gain_time(_f32(mic, dev), positions, times, table, basis, channel)
    nonzero = torch.any(volumes != 0, dim=-1)
    vol_out = torch.where(nonzero[:, None], volumes * gains, 0.0)
    t_out = torch.where(nonzero, t, 0.0)
    return vol_out, t_out


def hrtf_attenuate(mic, volumes, positions, times, pointing, up, table=None):
    """Stereo HRTF attenuation (rayverb.cpp:745-763); the default table when
    none is given. Returns (volumes (2, M, 8), times (2, M))."""
    if table is None:
        from ..hrtf.table import default_table

        table = default_table()
    table = _f32(table, volumes.device)
    outs = [
        hrtf_attenuate_channel(mic, volumes, positions, times, table, pointing, up, ch)
        for ch in (0, 1)
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def attenuate(results, model, table=None, device=None):
    """Dispatch on the attenuation model (cmd/main.cpp:279-297). ``results``
    is any object with ``mic``, ``volume`` (M, 8), ``position`` (M, 3) and
    ``time`` (M,); returns (volumes (C, M, 8), times (C, M)) on ``device``
    (None: the card, device.resolve_device)."""
    device = resolve_device(device)
    vol = _f32(results.volume, device)
    pos = _f32(results.position, device)
    tim = _f32(results.time, device)
    if model.is_hrtf:
        return hrtf_attenuate(
            results.mic, vol, pos, tim, model.hrtf.facing, model.hrtf.up, table
        )
    if not model.speakers:
        raise ValueError("attenuation model has no speakers")
    return speaker_attenuate_all(results.mic, vol, pos, tim, model.speakers)
