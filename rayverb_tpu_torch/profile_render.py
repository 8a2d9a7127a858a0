"""Where the time of one render goes on the GPU.

    python -m rayverb_tpu_torch.profile_render [config [model materials]]

Renders the scene once to warm up, then once more under torch.profiler
(CPU and CUDA activities), and prints one JSON object: the render's wall,
device kernel time in total and by kernel (top 12), the closest-hit
kernels' launches and time, and the device's busy share (union of kernel
intervals over the wall). It also prints the host's cost of one sweep
(host_cost): microseconds of host time per call of intersect.closest_hit
and of its parts, on a batch so small that the device keeps up. Defaults
to the vault demo; a config alone (e.g. assets/configs/hrtf_vault.json)
renders on the vault's model and materials. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

from .utils.profiling import profiler

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


def device_breakdown(fn) -> dict:
    """Device time of one call of ``fn`` (enqueueing CUDA work) under
    torch.profiler (CPU and CUDA activities), the device synchronised
    after it: the wall, device kernel time in total and by kernel (top 12),
    the closest-hit kernels' launches and time, and the device's busy share
    (union of kernel intervals over the wall)."""
    import torch

    with profiler() as prof:
        t0 = time.perf_counter()
        fn()
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
    hit = {n: v for n, v in kernels.items() if "closest_hit_" in n}
    device_ms = sum(v[1] for v in kernels.values()) / 1e3
    busy_ms = _busy_us(intervals) / 1e3
    return {
        "wall_ms": wall * 1e3,
        "device_events": len(intervals),
        "device_kernel_ms": device_ms if intervals else "not measured",
        "device_busy_ms": busy_ms if intervals else "not measured",
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3) if intervals else "not measured",
        # the sweep and block-order kernels of csrc/closest_hit.cu
        "closest_hit_kernels": {
            re.search(r"closest_hit_\w+", n).group(0): {
                "count": v[0], "ms": v[1] / 1e3
            }
            for n, v in hit.items()
        },
        "closest_hit_ms": sum(v[1] for v in hit.values()) / 1e3,
        "top_kernels": [
            {"name": n[:120], "count": v[0], "ms": v[1] / 1e3} for n, v in top[:12]
        ],
    }


def profile(paths=VAULT, impl: str = "auto") -> dict:
    import torch

    from .config.schema import load_config
    from .ops.intersect import soup_from_scene
    from .ops.render import render_fused
    from .scene import load_scene
    from .utils.directions import random_directions

    if not torch.cuda.is_available():
        raise RuntimeError("profile_render needs a CUDA device")
    cfg = load_config(paths[0])
    scene = load_scene(paths[1], paths[2])
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    soup = soup_from_scene(scene, device="cuda")
    render_fused(scene, cfg, dirs, impl=impl, device="cuda", soup=soup)
    torch.cuda.synchronize()
    host_us = host_cost(soup)
    out = device_breakdown(
        lambda: render_fused(scene, cfg, dirs, impl=impl, device="cuda", soup=soup))
    return {
        "device": torch.cuda.get_device_name(0),
        "config": paths[0],
        "rays": cfg.rays,
        "reflections": cfg.reflections,
        **out,
        "host_us_per_call": host_us,
    }


def host_cost(soup, calls: int = 200) -> dict:
    """Host microseconds per call, over ``calls`` calls enqueued back to
    back on one group of SWEEP_RAYS rays (the device's part is a few
    microseconds, so the wall is the host's): the whole closest_hit, its
    schedule (sweep_schedule: the order kernel), the kernel wrapper
    (intersect_cuda.closest_hit_cuda: checks, allocations, the sweep, whose
    epilogue writes the Hit), and one bare PyTorch launch for scale."""
    import torch

    from .ops import intersect_cuda
    from .ops.intersect import SWEEP_RAYS, closest_hit, sweep_schedule

    dev = soup.device
    gen = torch.Generator(device="cpu").manual_seed(0)
    d = torch.randn((SWEEP_RAYS, 3), generator=gen).to(dev)
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    o = ((soup.bounds[0] + soup.bounds[1]) / 2).expand(SWEEP_RAYS, 3).contiguous()
    t_max = torch.full((SWEEP_RAYS,), float("inf"), device=dev)
    t_decide = torch.zeros((SWEEP_RAYS,), device=dev)
    order, slices, counts = sweep_schedule(o, d, t_max, None, soup)
    parts = {
        "closest_hit": lambda: closest_hit(o, d, soup),
        "sweep_schedule": lambda: sweep_schedule(o, d, t_max, None, soup),
        "closest_hit_cuda": lambda: intersect_cuda.closest_hit_cuda(
            o, d, soup.packed, soup.block_aabb, t_max, t_decide, order, slices,
            counts=counts,
        ),
        "one_torch_op": lambda: t_decide.add_(0.0),
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (0, 1, 3):
        print("usage: profile_render [config [model materials]]", file=sys.stderr)
        return 2
    paths = tuple(argv) if len(argv) == 3 else (*argv, *VAULT[len(argv):])
    print(json.dumps(profile(paths)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
