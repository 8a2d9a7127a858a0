"""The port's ``parallel_raytrace`` command-line interface.

Same four positionals, error texts and exit codes as rayverb_tpu/cli.py
(the reference's cmd/main.cpp:104-137):

    python -m rayverb_tpu_torch.cli <config.json> <model> <materials.json> \\
        <out.{wav,aif[f]}> [--device cuda|cpu] [--seed N] [--stats] \\
        [--pipeline fused|modular] [--filter-method scan|fft] \\
        [--save-raw FILE.npz] [--from-raw FILE.npz] [--dump-paths FILE]

The default render is the fused one (ops.render.render_fused); ``--pipeline
modular`` (pipeline.render) runs the reference's stages one by one, with
the causal time-domain scan filters by default. ``--save-raw``,
``--from-raw`` and ``--dump-paths`` imply the modular pipeline, as in the
JAX CLI. Speaker and HRTF configs, on the GPU unless ``--device cpu`` is
given. With ``--stats`` the phase walls are printed (the modular
pipeline's: trace, population, post and process), then the render's span
table (calls, total and self seconds by ``rv.*`` span, utils/profiling.py)
and its counters: closest-hit calls and rows, kernel launches, the
executed pair tests and the live rows by sweep kind, and the fused
render's histogram bound and finalize bucket or the modular pipeline's
population, dedup and biquad counters. Errors: message to stderr, exit
code 1.
"""

from __future__ import annotations

import argparse
import os
import sys


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
    p.add_argument("--dump-paths", metavar="FILE", default=None,
                   help="write per-ray reflection paths as JSONL (the reference's "
                        "DIAGNOSTIC impulse.dump)")
    p.add_argument("--filter-method", choices=("scan", "fft"), default="scan",
                   help="IIR filters as causal time-domain scans or the FFT fast "
                        "path (modular pipeline only)")
    p.add_argument("--pipeline", choices=("fused", "modular"), default="fused",
                   help="fused: whole render on the device (fast path); "
                        "modular: the reference's stages (exact scan filters, "
                        "raw impulse access)")
    p.add_argument("--save-raw", metavar="FILE.npz", default=None,
                   help="persist raw impulses so post-processing can be "
                        "re-run without re-tracing (implies modular pipeline)")
    p.add_argument("--from-raw", metavar="FILE.npz", default=None,
                   help="skip the trace and post-process impulses saved "
                        "with --save-raw")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

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

        t0 = _time.perf_counter()
        scene = load_scene(args.model, args.materials, verbose=config.verbose)
        t1 = _time.perf_counter()
        seed = args.seed if args.seed is not None else config.seed
        directions = random_directions(config.rays, seed=seed)

        use_fused = (
            args.pipeline == "fused"
            and not args.dump_paths
            and not args.save_raw
            and not args.from_raw
        )
        if args.from_raw:
            from .engine import load_raw
            from .pipeline import render_from_raw

            result = render_from_raw(
                config, load_raw(args.from_raw), filter_method=args.filter_method,
                device=args.device, stats=args.stats,
            )
            channels, info = result.channels, result.info
        elif use_fused:
            from .ops.render import render_fused

            channels, info = render_fused(
                scene,
                config,
                directions,
                impl=args.trace_impl,
                device=args.device,
                stats=args.stats,
            )
        else:
            from .pipeline import render

            result = render(
                config,
                scene,
                directions=directions,
                filter_method=args.filter_method,
                trace_impl=args.trace_impl,
                device=args.device,
                stats=args.stats,
            )
            channels, info = result.channels, result.info
        t2 = _time.perf_counter()

        if args.dump_paths and not use_fused and result.raytracer is not None:
            from .utils.diagnostics import dump_paths

            dump_paths(
                args.dump_paths,
                config.rays,
                config.reflections,
                result.raytracer.outputs,
            )

        if args.save_raw and not args.from_raw:
            from .engine import save_raw

            save_raw(args.save_raw, result.raw)

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
            from .utils.profiling import report

            timings = info["timings"]
            phases = "  ".join(
                f"{k}: {v:.3f}s" for k, v in timings.items()
                if isinstance(v, float) and k != "total"
            )
            print(f"phases [{phases}]", file=sys.stderr)
            print("\n".join(report(timings)), file=sys.stderr)
    except (ValueError, RuntimeError, OSError) as e:
        print("encountered runtime error:", file=sys.stderr)
        print(e, file=sys.stderr)
        return 1

    return 0


if __name__ == "__main__":
    sys.exit(main())
