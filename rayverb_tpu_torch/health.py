"""Health probe of the card: the vault's warm render wall.

    python -m rayverb_tpu_torch.health [--threshold S] [--runs N]
        [--device cuda|cpu]

Renders the vault demo (vault.json: 50,000 rays x 128 reflections) with
render_fused once to warm up (kernel build or load, FFT plans), then
``--runs`` times, and prints the best warm wall. Exit code 0 when it lies
below --threshold (healthy), 1 above it (degraded). Warm walls of healthy
runs spread between machines, so run this before trusting a wall-clock
measurement. The default threshold, THRESHOLD_S, sits above the spread of
the warm walls this probe read on an NVIDIA H100 80GB HBM3 at 700 W
(PERF.md).
"""

from __future__ import annotations

import argparse
import sys
import time

from .profile_render import VAULT

THRESHOLD_S = 1.5


def check(scene, config, *, threshold: float = THRESHOLD_S, runs: int = 1,
          device=None, seed: int = 1234) -> int:
    """Render ``config`` on ``scene`` once to warm up and ``runs`` times
    timed; print the best wall and the verdict; 0 when it lies below
    ``threshold``, else 1."""
    from .ops.render import render_fused
    from .utils.directions import random_directions

    dirs = random_directions(config.rays, seed=seed)
    _, info = render_fused(scene, config, dirs, device=device)
    wall = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        render_fused(scene, config, dirs, device=device)
        wall = min(wall, time.perf_counter() - t0)
    healthy = wall < threshold
    print(f"vault warm {wall:.4f}s on {info['device']} -> "
          f"{'HEALTHY' if healthy else 'DEGRADED'} (threshold {threshold:g}s)")
    return 0 if healthy else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threshold", type=float, default=THRESHOLD_S)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be >= 1")
    from .config.schema import load_config
    from .device import resolve_device
    from .scene import load_scene

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    if dev.type == "cuda":
        from .device import card_name_and_power

        print(card_name_and_power())
    return check(load_scene(*VAULT[1:]), load_config(VAULT[0]),
                 threshold=args.threshold, runs=args.runs, device=dev)


if __name__ == "__main__":
    sys.exit(main())
