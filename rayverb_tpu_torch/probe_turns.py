"""The north-star probe of each trace schedule variant, in turns.

    python -m rayverb_tpu_torch.probe_turns [--rays 1000000] [--turns 2]
        [--runs 2] [--out FILE] [--only NAME ...]

Runs ``python -m rayverb_tpu_torch.probe --profile --variant NAME`` once
per trace variant of trace_variants.VARIANTS (or of those named by --only)
and turn, each in a fresh process without RAYVERB_* variables: the
variants in order on even turns and in reverse
order on odd ones (A B .. B A ..). Prints one JSON line per run
(appended to --out as well) and then one line per variant: the executed
pair tests by kind, a horizon split's live rows of each pass, the sweep
and order kernels' launches and device ms per render of every turn, the
warm walls (stats on), the profiled walls (stats off), the device
busy ms and the peak device memory of every turn, beside the card's name
and power limit. Exits 1 when a run fails. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .trace_variants import VARIANTS

RUN_TIMEOUT_S = 600


def _run(name: str, turn: int, rays: int, runs: int) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAYVERB_")}
    cmd = [sys.executable, "-m", "rayverb_tpu_torch.probe", "--rays", str(rays),
           "--runs", str(runs), "--profile", "--variant", name]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    rec = {"variant": name, "turn": turn, "rc": proc.returncode}
    if proc.returncode != 0:
        rec["stderr"] = proc.stderr[-2000:]
        return rec
    rec.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    return rec


def _summary(name: str, recs) -> dict:
    ok = [r for r in recs if r["rc"] == 0]
    if not ok:
        return {"variant": name, "failed": True}
    kernels = [r["profile"]["closest_hit_kernels"] for r in ok]

    def per_turn(kernel, field):
        return [k.get(kernel, {}).get(field) for k in kernels]

    return {
        "variant": name,
        "card": ok[0].get("card"),
        "horizon_split_rows": ok[0].get("horizon_split_rows"),
        "executed_G": ok[0].get("executed_G"),
        "executed_total_G": ok[0].get("executed_total_G"),
        "sweep_launches": per_turn("closest_hit_sweep", "count"),
        "sweep_ms": per_turn("closest_hit_sweep", "ms"),
        "order_launches": per_turn("closest_hit_order", "count"),
        "order_ms": per_turn("closest_hit_order", "ms"),
        "device_busy_ms": [r["profile"]["device_busy_ms"] for r in ok],
        "warm_wall_s": [r["wall_s"] for r in ok],
        "profiled_wall_ms": [r["profile"]["wall_ms"] for r in ok],
        "peak_memory_bytes": [r.get("peak_memory_bytes") for r in ok],
        "memory_estimate_bytes": ok[0]["memory_estimate_bytes"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1_000_000)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--runs", type=int, default=2, help="warm runs per process")
    ap.add_argument("--out", default=None, help="also append every run's line here")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS), default=list(VARIANTS),
                    help="the variants to run (default: all)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_turns needs a CUDA device", file=sys.stderr)
        return 1
    names = args.only
    recs = []
    for turn in range(args.turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            rec = _run(name, turn, args.rays, args.runs)
            recs.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    for name in names:
        print(json.dumps(_summary(name, [r for r in recs if r["variant"] == name])),
              flush=True)
    return 0 if all(r["rc"] == 0 for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
