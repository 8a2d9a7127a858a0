"""The program's stages, and the device's idle time of a profiled window put
under the stage the host was in.

A stage is a set of the program's span names (its host-side profiler
ranges, utils/profiling.py). Each idle gap of the device goes to the stage
of the outermost stage range that covers the gap's middle, so that a span
nested in a stage (rv.bin or rv.sync inside rv.phase_a) counts for that
stage; a gap whose middle no stage range covers is unnamed: a call root's
own time, the trace's own code between its phases, or time between calls.
The stretches before the window's first device operation and after its
last, bounded by the program's first and last span (its rv.* ranges), count
as gaps too, so that the idle time of every stage and the unnamed time add
up to the window's idle wall (device_idle_pct), less the moments before
the first call's root and after the last one's. Host events of the
profiler itself can fall outside the timed window, so they bound
nothing."""

from __future__ import annotations

import statistics

import numpy as np

STAGES = {
    "pre": ("rv.prepare", "rv.config", "rv.load_scene", "rv.directions", "rv.inputs",
            "rv.sweep_table"),
    "phase_a": ("rv.phase_a",),
    "phase_b": ("rv.phase_b",),
    # every stage a call opens after its trace; rv.bin and rv.sync inside a
    # phase count for the phase (outermost range)
    "post": ("rv.bin", "rv.time_stats", "rv.finalize", "rv.pull", "rv.sync", "rv.dedup",
             "rv.population", "rv.attenuate", "rv.predelay", "rv.flatten", "rv.filter",
             "rv.mix", "rv.write"),
}
STAGE_OF = {name: stage for stage, names in STAGES.items() for name in names}
# the trace's two stage spans: a program that keeps neither names no stages
PHASES = ("rv.phase_a", "rv.phase_b")


def idle_by_stage(prof) -> dict | None:
    """{stage: idle seconds, None: unnamed idle seconds} over the profiled
    window ``prof`` (devtrace.DeviceTrace); None where it holds no device
    operation or no phase range.

    The gaps come from the device intervals sorted by start against the
    running furthest end. The stage ranges, sorted by start (the longer
    first), are cut into disjoint pieces, each the part of a range beyond
    every range that began before it: the outermost range open at a point
    owns it. Each gap's middle is then looked up among the pieces."""
    if prof is None or not prof.device_ops or not prof.host_ops:
        return None
    if not any(name in PHASES for name, _, _ in prof.host_ops):
        return None
    n = len(prof.device_ops)
    starts = np.fromiter((a for _, a, _ in prof.device_ops), np.float64, n)
    order = np.argsort(starts, kind="stable")
    stops = np.fromiter((b for _, _, b in prof.device_ops), np.float64, n)[order]
    lo = min(a for name, a, _ in prof.host_ops if name.startswith("rv."))
    hi = max(b for name, _, b in prof.host_ops if name.startswith("rv."))
    # gap k runs from the furthest end before device op k to its start;
    # the first from the window's start, the last to its end
    ends = np.concatenate(([lo], np.maximum.accumulate(stops)))
    begins = np.concatenate((starts[order], [hi]))
    gap = begins > ends
    mids = 0.5 * (ends[gap] + begins[gap])
    lengths = (begins[gap] - ends[gap]) / 1e6

    names = list(STAGES)
    pieces, reach = [], -np.inf
    # a phase range is among them, so there is at least one piece
    for a, neg_b, stage in sorted((a, -b, names.index(STAGE_OF[name]))
                                  for name, a, b in prof.host_ops if name in STAGE_OF):
        if -neg_b > reach:
            pieces.append((max(a, reach), -neg_b, stage))
            reach = -neg_b
    piece = np.array(pieces, dtype=np.float64)
    i = np.searchsorted(piece[:, 0], mids, side="right") - 1
    j = np.clip(i, 0, None)
    label = np.where((i >= 0) & (mids <= piece[j, 1]), piece[j, 2], len(names))
    sums = np.bincount(label.astype(np.int64), weights=lengths, minlength=len(names) + 1)
    return {**{stage: float(sums[k]) for k, stage in enumerate(names)}, None: float(sums[-1])}


def stage_idle_ms(ctx, stage: str):
    """Idle milliseconds per profiled call (IR or batch) in ``stage``."""
    sums = idle_by_stage(ctx.get("profile"))
    return None if sums is None else 1e3 * sums[stage] / ctx["profile"].units


def span_ms(ctx, name: str, *, within: str | None = None):
    """Milliseconds of the span ``name`` per window call (summed over its
    chunks or passes), median over the calls that have it, and, with
    ``within``, the span ``within`` too; None where none has."""
    xs = [s["spans"][name]["s"] for s in ctx.get("stats", [])
          if name in s.get("spans", {}) and (within is None or within in s["spans"])]
    return 1e3 * statistics.median(xs) if xs else None
