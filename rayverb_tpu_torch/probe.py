"""Sweep probe: the north star at a chosen ray count, with its executed pairs.

    python -m rayverb_tpu_torch.probe [--rays 65536] [--chunk N] [--runs 1]
        [--device cuda|cpu] [--profile]

Renders the north-star workload (NORTH_STAR: the 101,568-triangle hall of
scripts/gen_hall.py, generated into a temporary directory, stereo HRTF, 16
reflections) with ``--rays`` rays, once cold and ``--runs`` times warm,
with stats on (the executed pair tests are counted in the sweeps' own
launches), and prints one JSON line: the cold wall
(compile_wall_s: the first render of the process, which builds or loads
the kernels), the best warm wall and its trace_bin and finalize phases,
the executed pair tests by sweep kind in G, and every RAYVERB_* variable
of the environment, so that each variant of a knob runs in a fresh
process. --chunk sets the rays per chunk (default: chosen by memory).
On a CUDA device the line also holds the peak device memory of the warm runs, and
with --profile the device breakdown of one more warm render without
stats (profile_render.device_breakdown: the sweep and order kernels'
launches and device ms, device busy time).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the north star (bench.py:90-119): 1M rays x 16 reflections through the
# 100k-triangle hall of scripts/gen_hall.py, stereo HRTF
NORTH_STAR = {
    "rays": 1_000_000,
    "reflections": 16,
    "sample_rate": 44100,
    "bit_depth": 16,
    "source_position": [12.0, 6.0, 8.0],
    "mic_position": [28.0, 5.0, 20.0],
    "attenuation_model": {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
    "filter": "linkwitz_riley",
    "normalize": True,
    "trim_tail": False,
}
HALL_TRIANGLES = 100_000
HALL_MATERIALS = os.path.join(REPO, "assets", "materials", "mat.json")


def write_hall(path: str, triangles: int = HALL_TRIANGLES) -> int:
    """Write the north-star hall to ``path`` with scripts/gen_hall.py
    (loaded by path; it imports neither package). Returns its triangle
    count."""
    spec = importlib.util.spec_from_file_location(
        "gen_hall", os.path.join(REPO, "scripts", "gen_hall.py"))
    gen_hall = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_hall)
    return gen_hall.generate(path, triangles)


def hall_scene(tmp: str, triangles: int = HALL_TRIANGLES):
    """The hall written into directory ``tmp`` and loaded with mat.json."""
    from .scene import load_scene

    path = os.path.join(tmp, "hall.obj")
    write_hall(path, triangles)
    return load_scene(path, HALL_MATERIALS)


def probe(scene, config, *, runs: int = 1, chunk=None, device=None,
          seed: int = 1234, profile: bool = False) -> dict:
    """Render ``config`` on ``scene`` once cold and ``runs`` times warm
    with stats; returns the probe's record (module docstring)."""
    import torch

    from .ops.render import render_fused
    from .utils.directions import random_directions

    dirs = random_directions(config.rays, seed=seed)
    cuda = torch.device("cuda" if device is None else device).type == "cuda"

    def render(stats=True):
        return render_fused(scene, config, dirs, ray_chunk=chunk, device=device,
                            stats=stats)

    t0 = time.perf_counter()
    render()
    cold = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    best = None
    for _ in range(runs):
        t0 = time.perf_counter()
        _, info = render()
        wall = time.perf_counter() - t0
        if best is None or wall < best[0]:
            best = (wall, info)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if profile:
        from .profile_render import device_breakdown

        breakdown = device_breakdown(lambda: render(stats=False))
    wall, info = best
    out = {
        "rays": config.rays,
        "device": info["device"],
        "env": {k: v for k, v in os.environ.items() if k.startswith("RAYVERB_")},
        "compile_wall_s": cold,
        "wall_s": wall,
        "trace_bin_s": info["timings"]["trace_bin"],
        "finalize_s": info["timings"].get("finalize", 0.0),
        "ray_chunk": info["ray_chunk"],
        "memory_estimate_bytes": info["memory_estimate_bytes"],
    }
    if cuda:
        out["peak_memory_bytes"] = peak
    if "pair_tests_executed" in info:
        out["executed_G"] = {k: v / 1e9 for k, v in info["pair_tests_executed"].items()}
        out["executed_total_G"] = info["pair_tests_executed_total"] / 1e9
    if profile:
        out["profile"] = breakdown
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--chunk", type=int, default=None,
                    help="rays per chunk (default: chosen by memory)")
    ap.add_argument("--runs", type=int, default=1, help="warm runs to time")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="add the device breakdown of one more warm render (cuda)")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be >= 1")
    if args.profile and args.device != "cuda":
        ap.error("--profile needs --device cuda")
    from .config.schema import parse_config
    from .device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    config = parse_config(json.dumps(dict(NORTH_STAR, rays=args.rays)))
    with tempfile.TemporaryDirectory(prefix="rayverb_probe_") as tmp:
        scene = hall_scene(tmp)
    out = probe(scene, config, runs=args.runs, chunk=args.chunk, device=dev,
                profile=args.profile)
    if dev.type == "cuda":
        from .device import card_name_and_power

        out["card"] = card_name_and_power()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
