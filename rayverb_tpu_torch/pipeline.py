"""The modular render pipeline: config + scene -> impulse response channels
(PyTorch counterpart of rayverb_tpu/pipeline.py).

The orchestration of cmd/main.cpp:241-337, stage by stage, on ``device``
(None: the card): dense trace (engine.Raytracer), output population with
the image dedup on the host, attenuation, optional predelay fix, flatten
(ops/histogram.py), filter / mix / trim (ops/postprocess.py). Its filters
default to the causal time-domain scans (the biquad_scan kernel on the card);
the raw impulses can be saved and rendered again without tracing
(render_from_raw), and the trace outputs stay available for the path dump.
"""

from __future__ import annotations

import sys
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np

from .config.schema import OutputMode, RenderConfig
from .device import resolve_device
from .engine import Raytracer, RaytracerResults, assemble_population
from .ops.attenuate import attenuate
from .ops.histogram import flatten_channels
from .ops.postprocess import find_predelay, fix_predelay, process
from .scene.compile import Scene
from .utils.directions import random_directions


@dataclass
class RenderResult:
    channels: np.ndarray       # (C, T) float32, post-processed
    sample_rate: float
    raw: RaytracerResults      # the selected impulse population
    attenuated_times: object   # (C, M) tensor on the render's device
    predelay: float
    raytracer: Raytracer | None  # retains TraceOutputs for diagnostics


def select_results(raytracer: Raytracer, config: RenderConfig) -> RaytracerResults:
    """output_mode dispatch (cmd/main.cpp:255-269), as host arrays."""
    if config.output_mode == OutputMode.ALL:
        return raytracer.get_all_raw(config.remove_direct)
    if config.output_mode == OutputMode.IMAGE_ONLY:
        return raytracer.get_raw_images(config.remove_direct)
    return raytracer.get_raw_diffuse()


def _phase(timer, name):
    return nullcontext() if timer is None else timer.phase(name)


def _post(config: RenderConfig, results: RaytracerResults, *, hrtf_table,
          filter_method: str, device, timer, raytracer) -> RenderResult:
    """Attenuation, predelay, flatten and process of a population."""
    with _phase(timer, "attenuate"):
        volumes, times = attenuate(results, config.attenuation_model, hrtf_table,
                                   device=device)
        predelay = 0.0
        if config.trim_predelay:
            predelay = find_predelay(times)
            times = fix_predelay(times, predelay)
    with _phase(timer, "flatten"):
        bands = flatten_channels(volumes, times, config.sample_rate)
    with _phase(timer, "process"):
        channels = process(
            bands,
            config.sample_rate,
            filter_type=config.filter,
            lo_cutoff=config.hipass,
            do_normalize=config.normalize,
            volume_scale=config.volume_scale,
            do_trim_tail=config.trim_tail,
            filter_method=filter_method,
        )
    return RenderResult(
        channels=channels,
        sample_rate=config.sample_rate,
        raw=results,
        attenuated_times=times,
        predelay=predelay,
        raytracer=raytracer,
    )


def render_from_raw(
    config: RenderConfig,
    results: RaytracerResults,
    *,
    hrtf_table=None,
    filter_method: str = "scan",
    device=None,
    timer=None,
) -> RenderResult:
    """Attenuation and post-processing of raw impulses (engine.load_raw) on
    ``device`` (None: the card), without tracing. ``timer``: a
    profiling.PhaseTimer, or None."""
    if results.num_impulses == 0:
        raise RuntimeError("No raytrace results returned.")
    return _post(config, results, hrtf_table=hrtf_table,
                 filter_method=filter_method, device=resolve_device(device),
                 timer=timer, raytracer=None)


def render(
    config: RenderConfig,
    scene: Scene,
    *,
    directions=None,
    hrtf_table=None,
    filter_method: str = "scan",
    trace_impl: str = "auto",
    ray_chunk: int | None = None,
    device=None,
    timer=None,
) -> RenderResult:
    """Render one impulse response (the body of cmd/main.cpp:241-336) on
    ``device`` (None: the card). trace_impl: the closest-hit sweep, 'auto'
    | 'cuda' | 'plain' (intersect.closest_hit). ray_chunk: rays per trace
    chunk, None to plan it from memory (trace.trace). ``timer``: a
    profiling.PhaseTimer whose phases (trace, population, attenuate,
    flatten, process) then end with a device synchronisation, or None."""
    if trace_impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"trace_impl must be 'auto', 'cuda' or 'plain', not {trace_impl!r}")
    for w in config.warnings:
        print(f"WARNING: {w}", file=sys.stderr)
    dev = resolve_device(device)
    if directions is None:
        directions = random_directions(config.rays, seed=config.seed)

    with _phase(timer, "trace"):
        raytracer = Raytracer(
            config.reflections,
            scene,
            verbose=config.verbose,
            impl=trace_impl,
            ray_chunk=ray_chunk,
            device=dev,
        )
        raytracer.raytrace(config.mic_position, config.source_position, directions)

    # device-resident population: only the small image-index table crosses
    # to the host (for the chain dedup)
    with _phase(timer, "population"):
        vol, pos, tim = assemble_population(
            raytracer.outputs, config.output_mode, config.remove_direct
        )
    if tim.shape[0] == 0:
        raise RuntimeError("No raytrace results returned.")
    results = RaytracerResults(
        volume=vol, position=pos, time=tim, mic=np.asarray(config.mic_position)
    )
    return _post(config, results, hrtf_table=hrtf_table,
                 filter_method=filter_method, device=dev, timer=timer,
                 raytracer=raytracer)
