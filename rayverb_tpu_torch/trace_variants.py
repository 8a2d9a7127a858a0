"""The JAX trace's other sweep schedules, for measurement only.

The JAX package selects these with environment variables (its README's
knob table): RAYVERB_SORT_KEY, RAYVERB_HORIZON, RAYVERB_SHADOW_FWD and
RAYVERB_NO_RESORT. None changes a result but the forward shadow rays,
whose verdicts may differ on geometry within EPSILON of the mic, and on
the H100 each was slower than the port's default at the north star
(PERF.md, Findings). So the port's renders read none
of them and run one schedule; the probe, probe_turns and the
trace_variants phase of chip_smoke.py install a variant by name for the
length of a ``with applied(name):`` block, which patches ops/trace.py and
ops/render.py:

  - ``sort_cell8``, ``sort_cell64``, ``sort_octant``: the between-bounce
    sort key (``_ray_sort_key``), bit for bit JAX trace.py:110-167's
  - ``horizon_<frac>``: each sorted bounce sweep in two passes
    (``_sorted_bounce_sweep``; JAX trace.py:556-594): pass 1 bounds every
    live ray at frac x the scene's bounding-box diagonal, pass 2 sorts the
    rays it left unresolved to the front and sweeps them unbounded, every
    other row parked dead; both at full width, so no shape depends on the
    data. R - 1 more sweeps per trace
  - ``shadow_fwd``: mic-shadow rays from the bounce point toward the mic
    (``_shadow_rows``; JAX trace.py:241-255, :740-745, :892-901)
  - ``no_resort``: no between-bounce resort (``resort_sweeps``; JAX
    render.py:1228-1232 reads it in render_fused)
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from .ops import render, trace
from .ops.intersect import Hit

SORT_KEYS = ("cell8", "cell64", "octant")
# the variants probe_turns runs at the north star: the JAX package's
# horizons (0.12, 0.25), and two past the north star's mean free path
# whose pass 2 is mostly, then all, dead groups (the split's fixed cost)
VARIANTS = (
    "default", "horizon_0.12", "horizon_0.25", "horizon_0.5", "horizon_1.0",
    "shadow_fwd", *(f"sort_{k}" for k in SORT_KEYS), "no_resort",
)

_default_sorted_sweep = trace._sorted_bounce_sweep


def sort_key(variant: str):
    """The between-bounce sort key ``variant`` with _ray_sort_key's
    signature: (N,) int64 holding a uint32, from the 27-bit position
    Morton code m and the 27-bit direction Morton code dm:
      - mix6 (the port's): a 1:1 interleave of the top 16 bits of each
      - cell8: the top 3 bits of m (a scene octant), then all of dm
      - cell64: the top 6 bits of m, then the top 26 bits of dm
      - any other name, octant: the direction's octant, then all of m"""
    if variant == "mix6":
        return trace._ray_sort_key

    def key(pos, direction, lo, inv_span):
        q = trace._quant9((pos - lo) * inv_span * 511.0)
        m = (
            trace._spread9(q[:, 0])
            | (trace._spread9(q[:, 1]) << 1)
            | (trace._spread9(q[:, 2]) << 2)
        )
        if variant == "cell8":
            out = ((m >> 24) << 27) | trace._dir_morton(direction)
        elif variant == "cell64":
            out = ((m >> 21) << 26) | (trace._dir_morton(direction) >> 1)
        else:
            octant = (
                (direction[:, 0] > 0).to(torch.int64)
                | ((direction[:, 1] > 0).to(torch.int64) << 1)
                | ((direction[:, 2] > 0).to(torch.int64) << 2)
            )
            out = (octant << 27) | m
        return out & trace._U32

    return key


def horizon_split(frac: float, live_rows: list | None = None):
    """_sorted_bounce_sweep split at frac x the soup's bounding-box diagonal
    (float32, as JAX trace.py:452-460). With ``live_rows`` a list, each
    split appends the counts of pass 1's live rows and of pass 2's
    unresolved ones, as 0-dim device tensors (nothing waits for the
    host)."""

    def split(sweep, soup, key, origins, dirs, t_max, kinds):
        alive = t_max > 0
        horizon = frac * torch.linalg.norm(soup.bounds[1] - soup.bounds[0])
        h1 = _default_sorted_sweep(sweep, soup, key, origins, dirs,
                                   torch.where(alive, horizon, 0.0), kinds)
        unresolved = alive & ~h1.hit
        if live_rows is not None:
            live_rows.append((alive.sum(), unresolved.sum()))
        h2 = _default_sorted_sweep(
            sweep, soup, torch.where(unresolved, key, trace._U32),
            torch.where(unresolved[:, None], origins, trace._DEAD_ORIGIN), dirs,
            torch.where(unresolved, float("inf"), 0.0), kinds,
        )
        return Hit(*(torch.where(unresolved, a, b) for a, b in zip(h2, h1)))

    return split


def forward_shadow_rows(mic, intersection, alive, mag, pair=None):
    """_shadow_rows in the reference's orientation, in row order: origin at
    the bounce point, direction toward the mic, bound ``_sweep_bound(mag)``
    and decide ``mag``, dead rows parked; the verdict reads the Hit as it
    comes (inv_perm an empty slice, mag_eff = mag). mic: (3,) or per-row
    (N, 3); ``pair`` is not needed, each row aims at its own mic."""
    al1 = alive[:, None]
    zhat = torch.tensor([0.0, 0.0, 1.0], device=intersection.device)
    origins = torch.where(al1, intersection, trace._DEAD_ORIGIN)
    dirs = torch.where(al1, trace._safe_normalize(mic - intersection), zhat)
    bounds = torch.where(alive, trace._sweep_bound(mag), 0.0)
    decide = torch.where(alive, mag, 0.0)
    return origins, dirs, bounds, decide, slice(None), mag


def _patches(name: str, live_rows):
    if name == "default":
        return []
    if name == "shadow_fwd":
        return [(trace, "_shadow_rows", forward_shadow_rows)]
    if name == "no_resort":
        return [(render, "resort_sweeps", lambda nrays, nblocks: False)]
    if name.startswith("sort_"):
        return [(trace, "_ray_sort_key", sort_key(name[len("sort_"):]))]
    if name.startswith("horizon_"):
        frac = float(name[len("horizon_"):])
        if frac > 0:
            return [(trace, "_sorted_bounce_sweep", horizon_split(frac, live_rows))]
    raise ValueError(f"unknown trace variant {name!r}")


@contextlib.contextmanager
def applied(name: str, live_rows: list | None = None):
    """Run the block with the trace variant ``name`` (module docstring)
    installed; ``live_rows`` as horizon_split's."""
    with contextlib.ExitStack() as stack:
        for module, attr, value in _patches(name, live_rows):
            stack.enter_context(mock.patch.object(module, attr, value))
        yield


def sweep_count(name: str, nreflections: int) -> int:
    """Closest-hit sweeps of one resorted trace under ``name``:
    trace.sweep_count, and under a horizon split one more per sorted
    bounce (all but the first)."""
    split = name.startswith("horizon_")
    return trace.sweep_count(nreflections) + (nreflections - 1 if split else 0)
