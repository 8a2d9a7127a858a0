"""Where the time of one render goes on the GPU.

    python -m rayverb_tpu_torch.profile_render [config model materials]

Renders the scene once to warm up, then once more under torch.profiler
(CPU and CUDA activities), and prints one JSON object: the render's wall,
device kernel time in total and by kernel (top 12), the closest-hit
kernel's launches and time, and the device's busy share (union of kernel
intervals over the wall). Defaults to the vault demo. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAULT = (
    os.path.join(_REPO, "assets", "configs", "vault.json"),
    os.path.join(_REPO, "assets", "test_models", "vault.obj"),
    os.path.join(_REPO, "assets", "materials", "vault.json"),
)


def _busy_us(intervals):
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(paths=VAULT, impl: str = "auto") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from .config.schema import load_config
    from .ops.render import render_fused
    from .scene import load_scene
    from .utils.directions import random_directions

    if not torch.cuda.is_available():
        raise RuntimeError("profile_render needs a CUDA device")
    cfg = load_config(paths[0])
    scene = load_scene(paths[1], paths[2])
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    render_fused(scene, cfg, dirs, impl=impl, device="cuda")
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_fused(scene, cfg, dirs, impl=impl, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    intervals = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        intervals.append((ev.time_range.start, ev.time_range.end))
        k = kernels.setdefault(ev.name, [0, 0.0])
        k[0] += 1
        k[1] += ev.time_range.end - ev.time_range.start
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    hit = [(n, v) for n, v in kernels.items() if "closest_hit" in n]
    device_ms = sum(v[1] for v in kernels.values()) / 1e3
    busy_ms = _busy_us(intervals) / 1e3
    return {
        "device": torch.cuda.get_device_name(0),
        "rays": cfg.rays,
        "reflections": cfg.reflections,
        "wall_ms": wall * 1e3,
        "device_events": len(intervals),
        "device_kernel_ms": device_ms if intervals else "not measured",
        "device_busy_ms": busy_ms if intervals else "not measured",
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3) if intervals else "not measured",
        "closest_hit_launches": sum(v[0] for _, v in hit),
        "closest_hit_ms": sum(v[1] for _, v in hit) / 1e3,
        "top_kernels": [
            {"name": n[:120], "count": v[0], "ms": v[1] / 1e3} for n, v in top[:12]
        ],
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = tuple(argv[:3]) if len(argv) >= 3 else VAULT
    print(json.dumps(profile(paths)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
