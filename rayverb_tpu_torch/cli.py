"""The port's ``parallel_raytrace`` command-line interface.

Same four positionals, error texts and exit codes as rayverb_tpu/cli.py
(the reference's cmd/main.cpp:104-137):

    python -m rayverb_tpu_torch.cli <config.json> <model> <materials.json> \\
        <out.{wav,aif[f]}> [--device cuda|cpu] [--seed N] [--stats]

The render is the fused one (rayverb_tpu_torch.ops.render.render_fused),
for speaker and HRTF configs, on the GPU unless ``--device cpu`` is given.
With ``--stats`` and RAYVERB_SWEEP_STATS set, the executed pair tests by
sweep kind are printed too. Errors: message to stderr, exit code 1.
"""

from __future__ import annotations

import argparse
import os
import sys

# flags of the JAX CLI whose paths are not ported yet
_NOT_PORTED = ("--dump-paths", "--save-raw", "--from-raw")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallel_raytrace",
        description="Physically-modelled impulse-response renderer "
        "(PyTorch/CUDA port of rayverb_tpu).",
    )
    p.add_argument("config", help="render configuration (.json)")
    p.add_argument("model", help="3D model file (.obj)")
    p.add_argument("materials", help="material definitions (.json)")
    p.add_argument("output", help="output audio file (.wav/.aif/.aiff)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed for ray directions (default: from config, else 0)")
    p.add_argument("--stats", action="store_true",
                   help="print phase timings and throughput to stderr")
    p.add_argument("--trace-impl", choices=("auto", "cuda", "plain"),
                   default="auto",
                   help="closest-hit sweep: the CUDA kernel on a GPU (auto), "
                        "or its plain PyTorch version")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--pipeline", choices=("fused", "modular"), default="fused")
    for flag in _NOT_PORTED:
        p.add_argument(flag, metavar="FILE", default=None,
                       help="not ported yet")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.pipeline == "modular":
        print("--pipeline modular is not ported yet", file=sys.stderr)
        return 1
    for flag in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            print(f"{flag} is not ported yet", file=sys.stderr)
            return 1

    from .config.schema import ConfigError, load_config
    from .io.audio import (
        SUPPORTED_BIT_DEPTHS,
        SUPPORTED_EXTENSIONS,
        write_audio,
    )
    from .scene.compile import load_scene
    from .utils.directions import random_directions

    # input existence prechecks (cmd/main.cpp:119-127)
    for path in (args.config, args.model, args.materials):
        if not os.path.isfile(path):
            print(f"input file {path} does not exist", file=sys.stderr)
            return 1
    out_dir = os.path.dirname(os.path.abspath(args.output))
    if not os.path.isdir(out_dir) or not os.access(out_dir, os.W_OK):
        print(f"output file {args.output} cannot be written", file=sys.stderr)
        return 1

    try:
        config = load_config(args.config)
    except ConfigError as e:
        print("encountered error reading config file:", file=sys.stderr)
        print(e, file=sys.stderr)
        return 1

    # format prechecks (cmd/main.cpp:209-239)
    if config.bit_depth not in SUPPORTED_BIT_DEPTHS:
        print(
            "Invalid bitdepth - valid bitdepths are: "
            + " ".join(str(b) for b in SUPPORTED_BIT_DEPTHS),
            file=sys.stderr,
        )
        return 1
    ext = os.path.splitext(args.output)[1].lstrip(".").lower()
    if ext not in SUPPORTED_EXTENSIONS:
        print(
            "Invalid output file extension - valid extensions are: "
            + " ".join(SUPPORTED_EXTENSIONS),
            file=sys.stderr,
        )
        return 1
    try:
        import time as _time

        from .ops.render import render_fused

        t0 = _time.perf_counter()
        scene = load_scene(args.model, args.materials, verbose=config.verbose)
        t1 = _time.perf_counter()
        seed = args.seed if args.seed is not None else config.seed
        directions = random_directions(config.rays, seed=seed)
        channels, info = render_fused(
            scene,
            config,
            directions,
            impl=args.trace_impl,
            device=args.device,
            stats=args.stats,
        )
        t2 = _time.perf_counter()
        write_audio(args.output, channels, config.sample_rate, config.bit_depth)
        t3 = _time.perf_counter()

        if args.stats:
            bounces = config.rays * config.reflections
            print(
                f"scene load: {t1 - t0:.3f}s  render: {t2 - t1:.3f}s  "
                f"write: {t3 - t2:.3f}s  "
                f"({bounces / max(t2 - t1, 1e-9) / 1e6:.2f} M ray-bounces/s)"
                f"  device: {info['device']}",
                file=sys.stderr,
            )
            tm = info["timings"]
            phases = "  ".join(
                f"{k}: {v:.3f}s" for k, v in tm.items() if k != "total"
            )
            print(
                f"phases [{phases}]  "
                f"pair-tests: {info['pair_tests_issued']:.3g} issued, "
                f"{info['pair_tests_per_s'] / 1e9:.2f} G/s",
                file=sys.stderr,
            )
            if "pair_tests_executed" in info:
                kinds = "  ".join(
                    f"{k}: {v}" for k, v in info["pair_tests_executed"].items()
                )
                print(
                    f"pair-tests executed: {info['pair_tests_executed_total']} "
                    f"[{kinds}]  "
                    f"{info['pair_tests_executed_per_s'] / 1e9:.2f} G/s",
                    file=sys.stderr,
                )
    except NotImplementedError as e:
        print(e, file=sys.stderr)
        return 1
    except (ValueError, RuntimeError, OSError) as e:
        print("encountered runtime error:", file=sys.stderr)
        print(e, file=sys.stderr)
        return 1

    return 0


if __name__ == "__main__":
    sys.exit(main())
