"""The modular render pipeline: config + scene -> impulse response channels
(PyTorch counterpart of rayverb_tpu/pipeline.py).

The orchestration of cmd/main.cpp:241-337, stage by stage, on ``device``
(None: the card): dense trace (engine.Raytracer), output population with
the image dedup on the host, attenuation, optional predelay fix, flatten
(ops/histogram.py), filter / mix / trim (ops/postprocess.py). Its filters
default to the causal time-domain scans (the biquad_scan kernel on the card);
the raw impulses can be saved and rendered again without tracing
(render_from_raw), and the trace outputs stay available for the path dump.

A call is the root span rv.modular (utils.profiling.call), its stages the
spans rv.dense_trace (the Raytracer: rv.sweep_table, one rv.trace per
chunk), rv.population (rv.dedup), rv.attenuate, rv.predelay, rv.flatten,
rv.filter and rv.mix, each ended by a device synchronisation in a
``stats=True`` call; rv.sync spans mark where the host waits for the
device (sites dedup_index, predelay, hist_len, pull). A stats call's
``info["timings"]`` holds them, their counters, and the flat stage walls
of FLAT_TIMINGS.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from .config.schema import OutputMode, RenderConfig
from .device import resolve_device
from .engine import Raytracer, RaytracerResults, assemble_population
from .ops.attenuate import attenuate
from .ops.histogram import flatten_channels
from .ops.postprocess import find_predelay, fix_predelay, process
from .scene.compile import Scene
from .utils import profiling
from .utils.directions import random_directions

# the flat stage walls of a stats call's info["timings"], each the sum of
# the spans it names: the dense trace, the population (dedup), the
# post-processing up to the histogram, and the filter bank with the mix
FLAT_TIMINGS = {
    "trace": ("rv.dense_trace",),
    "population": ("rv.population",),
    "post": ("rv.attenuate", "rv.predelay", "rv.flatten"),
    "process": ("rv.filter", "rv.mix"),
}


@dataclass
class RenderResult:
    channels: np.ndarray       # (C, T) float32, post-processed
    sample_rate: float
    raw: RaytracerResults      # the selected impulse population
    attenuated_times: object   # (C, M) tensor on the render's device
    predelay: float
    raytracer: Raytracer | None  # retains TraceOutputs for diagnostics
    info: dict = field(default_factory=dict)  # device, ...; timings with stats


def select_results(raytracer: Raytracer, config: RenderConfig) -> RaytracerResults:
    """output_mode dispatch (cmd/main.cpp:255-269), as host arrays."""
    if config.output_mode == OutputMode.ALL:
        return raytracer.get_all_raw(config.remove_direct)
    if config.output_mode == OutputMode.IMAGE_ONLY:
        return raytracer.get_raw_images(config.remove_direct)
    return raytracer.get_raw_diffuse()


def _post(config: RenderConfig, results: RaytracerResults, *, hrtf_table,
          filter_method: str, device, raytracer) -> RenderResult:
    """Attenuation, predelay, flatten and process of a population."""
    with profiling.phase("rv.attenuate"):
        volumes, times = attenuate(results, config.attenuation_model, hrtf_table,
                                   device=device)
    predelay = 0.0
    if config.trim_predelay:
        with profiling.phase("rv.predelay"):
            predelay = find_predelay(times)
            times = fix_predelay(times, predelay)
    with profiling.phase("rv.flatten"):
        bands = flatten_channels(volumes, times, config.sample_rate)
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
        info={"device": str(device), "predelay": predelay,
              "histogram_length": int(bands.shape[-1]), "filter_method": filter_method},
    )


def _timed(result: RenderResult, timings: dict, stats: bool) -> RenderResult:
    if stats:
        result.info["timings"] = timings
    return result


def render_from_raw(
    config: RenderConfig,
    results: RaytracerResults,
    *,
    hrtf_table=None,
    filter_method: str = "scan",
    device=None,
    stats: bool = False,
) -> RenderResult:
    """Attenuation and post-processing of raw impulses (engine.load_raw) on
    ``device`` (None: the card), without tracing, under the root span
    rv.modular. With stats=True the result's info gains ``timings`` (as
    render's)."""
    if results.num_impulses == 0:
        raise RuntimeError("No raytrace results returned.")
    dev = resolve_device(device)
    timings: dict = {}
    with profiling.call("rv.modular", dev, stats=stats, timings=timings, flat=FLAT_TIMINGS):
        result = _post(config, results, hrtf_table=hrtf_table,
                       filter_method=filter_method, device=dev, raytracer=None)
    return _timed(result, timings, stats)


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
    stats: bool = False,
) -> RenderResult:
    """Render one impulse response (the body of cmd/main.cpp:241-336) on
    ``device`` (None: the card). trace_impl: the closest-hit sweep, 'auto'
    | 'cuda' | 'plain' (intersect.closest_hit). ray_chunk: rays per trace
    chunk, None to plan it from memory (trace.trace). With stats=True the
    result's info gains ``timings``: the flat stage walls of FLAT_TIMINGS,
    ``total``, the call's ``spans`` and ``counters`` (the executed pair
    tests and live rows by sweep kind, sweep_table.builds, population.rows,
    dedup.images_in and .images_kept, biquad.series_samples, the kernels'
    launches), ``call`` and ``once``, as render_fused's."""
    if trace_impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"trace_impl must be 'auto', 'cuda' or 'plain', not {trace_impl!r}")
    for w in config.warnings:
        print(f"WARNING: {w}", file=sys.stderr)
    dev = resolve_device(device)
    if directions is None:
        directions = random_directions(config.rays, seed=config.seed)

    timings: dict = {}
    with profiling.call("rv.modular", dev, stats=stats, timings=timings, flat=FLAT_TIMINGS):
        with profiling.phase("rv.dense_trace"):
            raytracer = Raytracer(
                config.reflections,
                scene,
                verbose=config.verbose,
                impl=trace_impl,
                ray_chunk=ray_chunk,
                device=dev,
            )
            raytracer.raytrace(config.mic_position, config.source_position, directions)
            # the sweeps' counters to the host; the phase's sync completes it
            profiling.stage()

        # device-resident population: only the small image-index table
        # crosses to the host (for the chain dedup)
        with profiling.phase("rv.population"):
            vol, pos, tim = assemble_population(
                raytracer.outputs, config.output_mode, config.remove_direct
            )
        if tim.shape[0] == 0:
            raise RuntimeError("No raytrace results returned.")
        results = RaytracerResults(
            volume=vol, position=pos, time=tim, mic=np.asarray(config.mic_position)
        )
        result = _post(config, results, hrtf_table=hrtf_table,
                       filter_method=filter_method, device=dev, raytracer=raytracer)
    return _timed(result, timings, stats)
