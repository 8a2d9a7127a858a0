"""The sweep kernel's table slices on the traffic of whole renders.

    python -m rayverb_tpu_torch.sweep_scan [--out FILE] [CELL ...]

A cell is a scene, a config and a ray count (CELLS below; default: all).
For each cell the script renders once on the card, recording the inputs of
every launch of the sweep kernel (1 + 2R per render, with the order table
sweep_schedule gave it), then runs the kernel on each recorded batch at
every slice count of SLICES that the table allows and at the one the port
chose: its executed-pair counters, and its device time under torch.profiler
(the sweep kernel, the mean of REPS launches; timed on the host's clock,
a small batch would time the wrapper's host work instead).
It prints one JSON line per cell: per slice count, the kernel time and
executed pairs summed over the render's sweeps, split into closest-hit
batches and decided batches (some rows with t_decide > 0); the same sums
under the port's policy (sweep_slices) and under the best slice count of
each batch. With --out, one JSON line per batch goes to FILE. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ASSETS = os.path.join(_REPO, "assets")

# name: (config, model, materials, rays; None keeps the config's)
CELLS = {
    "vault_50000": ("vault.json", "vault.obj", "vault.json", None),
    # the ray counts of config.json and config_hrtf.json on the vault:
    # those configs' source and mic lie outside every scene of the repo
    "vault_32768": ("vault.json", "vault.obj", "vault.json", 32768),
    "vault_10000": ("vault.json", "vault.obj", "vault.json", 10000),
    "bedroom_50000": ("bedroom.json", "bedroom.obj", "mat.json", None),
    "stonehenge_100000": ("stonehenge.json", "stonehenge.obj", "mat.json", None),
}
SLICES = (1, 2, 4, 8, 16)
REPS = 5


def record_sweeps(cell):
    """Render the cell once on the card; returns the kernel's argument
    tuples (origins, dirs, packed, aabb, t_max, t_decide, order, slices),
    cloned, in launch order (an absent bound kept as its +inf or 0
    tensor)."""
    from unittest import mock

    import torch

    from .config.schema import load_config
    from .ops import intersect_cuda, trace
    from .ops.intersect import _bounds
    from .ops.render import render_fused
    from .scene import load_scene
    from .utils.directions import random_directions

    cfg_name, model, mat, rays = CELLS[cell]
    cfg = load_config(os.path.join(_ASSETS, "configs", cfg_name))
    if rays is not None:
        cfg = dataclasses.replace(cfg, rays=rays)
    scene = load_scene(
        os.path.join(_ASSETS, "test_models", model),
        os.path.join(_ASSETS, "materials", mat),
    )
    batches = []
    kernel = intersect_cuda.closest_hit_cuda

    def recording(o, d, packed, aabb, t_max, t_decide, order, slices, **kwargs):
        bounds = _bounds(o.shape[0], t_max, t_decide, o.device)
        batches.append(tuple(
            a.clone() if isinstance(a, torch.Tensor) else a
            for a in (o, d, packed, aabb, *bounds, order, slices)
        ))
        return kernel(o, d, packed, aabb, t_max, t_decide, order, slices, **kwargs)

    intersect_cuda.closest_hit_cuda = recording
    try:
        # the eager loops: a replayed bounce makes no call to record
        with mock.patch.object(trace, "_graph_engages", lambda *a: False), \
                mock.patch.object(trace, "_image_graph_engages", lambda *a: False):
            render_fused(scene, cfg, random_directions(cfg.rays, seed=cfg.seed),
                         device="cuda")
    finally:
        intersect_cuda.closest_hit_cuda = kernel
    return cfg, batches


def _slice_counts(chosen, nb):
    return sorted({chosen, *(s for s in SLICES if s <= max(1, nb // 2))})


def _run_ms(events, runs):
    """Device ms per launch of each of ``runs`` runs from the profiler's
    (start, end, name) device events in time order: the sweep kernel after
    the run's fill marker, over the sweeps seen."""
    us = [[0.0, 0] for _ in range(runs)]
    k = -1
    for start, end, name in events:
        if "FillFunctor" in name:
            k += 1
        elif 0 <= k < runs and "closest_hit_" in name:
            us[k][0] += end - start
            us[k][1] += "closest_hit_sweep" in name
    if k != runs or any(n == 0 for _, n in us):
        raise RuntimeError("the profiler lost the marks between runs")
    return [t / n / 1e3 for t, n in us]


def scan(batches):
    """Every recorded batch at every slice count, each on its own culled
    order (the order kernel's, made before the timed runs): one row per
    batch, with per slice count the device time of one launch (the sweep
    kernel under torch.profiler, the mean over the launches it saw of
    REPS) and the executed pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .ops import intersect_cuda
    from .ops.intersect import SWEEP_RAYS, super_aabb

    rows, calls = [], []
    for o, d, packed, aabb, t_max, t_decide, order, chosen in batches:
        row = {
            "rows": o.shape[0],
            "groups": -(-o.shape[0] // SWEEP_RAYS),
            "live": int((t_max > 0).sum()),
            "decided": bool((t_decide > 0).any()),
            "policy": chosen,
            "slices": {},
        }
        boxes = torch.from_numpy(super_aabb(aabb.cpu().numpy())).to(aabb.device)
        for s in _slice_counts(chosen, aabb.shape[0]):
            culled, counts = intersect_cuda.block_order_cuda(
                o, d, t_max, aabb, boxes, s, t_decide=t_decide)
            call = (o, d, packed, aabb, t_max, t_decide, culled, s)
            ex = intersect_cuda.closest_hit_cuda(*call, counts=counts, with_stats=True)[1]
            row["slices"][s] = {"ms": 0.0, "pairs": int(ex.sum())}
            calls.append((row["slices"][s], call, counts))
        rows.append(row)
    # a fill kernel between the runs of two (batch, slices) pairs marks
    # where each run's kernels begin on the device's timeline
    marker = torch.zeros((1,), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, call, counts in calls[:REPS]:
            intersect_cuda.closest_hit_cuda(*call, counts=counts)
        for _, call, counts in calls:
            marker.fill_(1.0)
            for _ in range(REPS):
                intersect_cuda.closest_hit_cuda(*call, counts=counts)
        marker.fill_(1.0)
        torch.cuda.synchronize()
    events = sorted(
        (ev.time_range.start, ev.time_range.end, ev.name)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
    )
    for (rec, _, _), ms in zip(calls, _run_ms(events, len(calls))):
        rec["ms"] = ms
    return rows


def summarize(cell, cfg, nb, rows):
    def total(pick, kind=None):
        sel = [r for r in rows if kind is None or r["decided"] == (kind == "decided")]
        ms = sum(r["slices"][pick(r)]["ms"] for r in sel)
        pairs = sum(r["slices"][pick(r)]["pairs"] for r in sel)
        return {"ms": ms, "pairs": pairs, "sweeps": len(sel)}

    def best(r):
        return min(r["slices"], key=lambda s: r["slices"][s]["ms"])

    out = {"cell": cell, "rays": cfg.rays, "reflections": cfg.reflections,
           "nblocks": nb, "sweeps": len(rows)}
    for s in SLICES:
        if all(s in r["slices"] for r in rows):
            out[f"slices_{s}"] = {k: total(lambda r, s=s: s, k)
                                  for k in (None, "closest", "decided")}
    out["policy"] = {k: total(lambda r: r["policy"], k)
                     for k in (None, "closest", "decided")}
    out["best_per_batch"] = {k: total(best, k)
                             for k in (None, "closest", "decided")}
    for v in out.values():
        if isinstance(v, dict) and None in v:
            v["all"] = v.pop(None)
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cells", nargs="*", default=list(CELLS))
    parser.add_argument("--out", help="write one JSON line per batch here")
    ns = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_scan needs a CUDA device", file=sys.stderr)
        return 2
    sink = open(ns.out, "w") if ns.out else None
    try:
        for cell in ns.cells:
            cfg, batches = record_sweeps(cell)
            nb = batches[0][3].shape[0]
            rows = scan(batches)
            if sink:
                for i, row in enumerate(rows):
                    sink.write(json.dumps({"cell": cell, "sweep": i, **row}) + "\n")
            del batches
            torch.cuda.empty_cache()
            print(json.dumps(summarize(cell, cfg, nb, rows)), flush=True)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
