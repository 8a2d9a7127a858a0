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
given. One render from its files is ``render_files``, which ``main`` calls
after its checks and ``gen`` calls per combination. With ``--stats`` the
scene load, render and write walls are printed, then the phase walls (the modular
pipeline's: trace, population, post and process), then the render's span
table (calls, total and self seconds by ``rv.*`` span, utils/profiling.py)
and its counters: closest-hit calls and rows, kernel launches, the
executed pair tests and the live rows by sweep kind, the rows of the
trace's sort keys by how they were computed, and the fused
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


# render_files' flat timings (info["timings"] with stats) and the spans
# they read; the render's own flat keys (trace_bin, finalize, ...) join them
FLAT_TIMINGS = {"load": ("rv.config", "rv.load_scene"),
                "render": ("rv.render", "rv.modular"), "write": "rv.write"}


def render_files(config_path, model_path, materials_path, output, *, pipeline="fused",
                 seed=None, directions=None, device=None, trace_impl="auto",
                 filter_method="scan", stats=False, dump_paths=None, save_raw=None,
                 from_raw=None):
    """One render from its files, as the CLI makes it: load the config and
    the scene, draw the directions (``random_directions`` of the config's
    rays, seeded by ``seed`` or else the config's seed) unless the caller
    gives them, render on ``device`` (None: the card) through render_fused
    or, with ``pipeline="modular"``, pipeline.render, and write ``output``
    (its extension picks WAV or AIFF). Returns (channels (C, T) float32,
    info).

    ``dump_paths`` (a JSONL path) and ``save_raw`` (an .npz path) run the
    modular pipeline and write its per-ray paths or raw impulses too;
    ``from_raw`` post-processes raw impulses saved so instead of tracing.

    The call is the root span rv.cli (utils.profiling): rv.config,
    rv.load_scene (rv.obj_parse, rv.scene_compile), rv.directions (when
    drawn here), the render's root (rv.render or rv.modular) and rv.write.
    With stats=True the info's ``timings`` is rv.cli's: the flat walls
    load (config and scene), render and write, the render's own flat keys,
    ``total``, and the spans and counters of the whole call."""
    from .config.schema import load_config
    from .device import resolve_device
    from .io.audio import write_audio
    from .scene.compile import load_scene
    from .utils import profiling
    from .utils.directions import random_directions

    dev = resolve_device(device)
    modular = pipeline == "modular" or bool(dump_paths or save_raw or from_raw)
    timings: dict = {}
    with profiling.call("rv.cli", dev, stats=stats, timings=timings, flat=FLAT_TIMINGS):
        with profiling.span("rv.config"):
            config = load_config(config_path)
        scene = load_scene(model_path, materials_path, verbose=config.verbose)
        if directions is None:
            with profiling.span("rv.directions"):
                directions = random_directions(
                    config.rays, seed=config.seed if seed is None else seed)
        if from_raw:
            from .engine import load_raw
            from .pipeline import render_from_raw

            result = render_from_raw(config, load_raw(from_raw), filter_method=filter_method,
                                     device=dev, stats=stats)
            channels, info = result.channels, result.info
        elif not modular:
            from .ops.render import render_fused

            channels, info = render_fused(scene, config, directions, impl=trace_impl,
                                          device=dev, stats=stats)
        else:
            from .pipeline import render

            result = render(config, scene, directions=directions,
                            filter_method=filter_method, trace_impl=trace_impl,
                            device=dev, stats=stats)
            channels, info = result.channels, result.info
            if dump_paths and result.raytracer is not None:
                from .utils.diagnostics import dump_paths as dump

                dump(dump_paths, config.rays, config.reflections, result.raytracer.outputs)
            if save_raw:
                from .engine import save_raw as save

                save(save_raw, result.raw)
        with profiling.span("rv.write"):
            write_audio(output, channels, config.sample_rate, config.bit_depth)
    if stats:
        info["timings"] = timings
    return channels, info


def precheck(config_path, model_path, materials_path, output):
    """The CLI's checks before a render, with its error texts: the inputs
    exist and the output's directory is writable (cmd/main.cpp:119-127),
    the config parses, and its bit depth and the output's extension are
    supported (cmd/main.cpp:209-239). Returns (the error text or None, the
    config or None)."""
    from .config.schema import ConfigError, load_config
    from .io.audio import SUPPORTED_BIT_DEPTHS, SUPPORTED_EXTENSIONS

    for path in (config_path, model_path, materials_path):
        if not os.path.isfile(path):
            return f"input file {path} does not exist", None
    out_dir = os.path.dirname(os.path.abspath(output))
    if not os.path.isdir(out_dir) or not os.access(out_dir, os.W_OK):
        return f"output file {output} cannot be written", None
    try:
        config = load_config(config_path)
    except ConfigError as e:
        return f"encountered error reading config file:\n{e}", None
    if config.bit_depth not in SUPPORTED_BIT_DEPTHS:
        return ("Invalid bitdepth - valid bitdepths are: "
                + " ".join(str(b) for b in SUPPORTED_BIT_DEPTHS)), config
    ext = os.path.splitext(output)[1].lstrip(".").lower()
    if ext not in SUPPORTED_EXTENSIONS:
        return ("Invalid output file extension - valid extensions are: "
                + " ".join(SUPPORTED_EXTENSIONS)), config
    return None, config


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    error, config = precheck(args.config, args.model, args.materials, args.output)
    if error is not None:
        print(error, file=sys.stderr)
        return 1
    try:
        channels, info = render_files(
            args.config, args.model, args.materials, args.output, pipeline=args.pipeline,
            seed=args.seed, device=args.device, trace_impl=args.trace_impl,
            filter_method=args.filter_method, stats=args.stats,
            dump_paths=args.dump_paths, save_raw=args.save_raw, from_raw=args.from_raw,
        )
    except (ValueError, RuntimeError, OSError) as e:
        print("encountered runtime error:", file=sys.stderr)
        print(e, file=sys.stderr)
        return 1

    if args.stats:
        from .utils.profiling import report

        timings = info["timings"]
        bounces = config.rays * config.reflections
        print(
            f"scene load: {timings['load']:.3f}s  render: {timings['render']:.3f}s  "
            f"write: {timings['write']:.3f}s  "
            f"({bounces / max(timings['render'], 1e-9) / 1e6:.2f} M ray-bounces/s)"
            f"  device: {info['device']}",
            file=sys.stderr,
        )
        phases = "  ".join(
            f"{k}: {v:.3f}s" for k, v in timings.items()
            if isinstance(v, float) and k not in ("total", *FLAT_TIMINGS)
        )
        print(f"phases [{phases}]", file=sys.stderr)
        print("\n".join(report(timings)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
