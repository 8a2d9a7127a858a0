"""Batched IR data generation: many source/receiver pairs through one trace
(PyTorch counterpart of rayverb_tpu/parallel/datagen.py, BASELINE.json
config 5).

The reference builds IR corpora by running its CLI once per pair
(demo/gen.sh). Here a batch of B pairs runs as ONE trace whose sweeps
carry every pair's rays at once (ops/trace.py ``_trace_impl`` with
``pair_id``), so each closest-hit launch covers B x N rows:

  trace + bin  the multi-pair trace; its diffuse rows binned into a
               (B, C, 8, L) histogram bank keyed by the row's pair, by the
               sorted binning on the flattened (pair * L + bin) key, or
               with bin_mode 'scatter' added bounce by bounce
  dedup        image chains deduplicated per pair in one sort of
               pair-seeded (h1, h2) hashes, then binned into the bank;
               per-pair time stats, predelay shift and content lengths
  finalize     the crossover bank, mixdown and normalise of every pair at
               once (render._finalize_filter's leading pair axis; with the
               scan method one biquad_scan launch per pass covers every
               pair's series, each with its own content length)

Pairs are independent, so a batch may run in several passes of whole pairs
(``microbatch``, or a plan from the shapes, ``datagen_bytes``) with results
equal to one pass. The port traces exactly B x N rows: the JAX package's
512-row padding and its ``nvalid`` exist for static shapes only. Each
pair's rays are Morton-ordered as render_fused orders one render's.
config.output_mode is honoured as render_fused honours it.

config.trim_predelay applies per pair on the device, as in the
single-pair render. config.trim_tail needs per-pair output lengths, which
do not batch: ``trim_batch`` cuts the fixed-shape outputs on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config.schema import RenderConfig
from ..constants import NUM_BANDS, NUM_IMAGE_SOURCE
from ..device import resolve_device
from ..ops.filters import KERNEL_LENGTH
from ..ops.render import (
    _U32,
    AttenSpec,
    _channel,
    _dedup_rows,
    _dense_from_runs,
    _finalize_filter,
    _finalize_method,
    _head,
    _Images,
    _mix32,
    _prepare,
    _segmented_run_totals,
    _sorted_hist,
    _time_bins,
    chain_hashes,
    device_filter_params,
    executed_pairs,
    memory_budget,
    render_bytes,
    sweep_pair_tests,
)
from ..ops.trace import _trace_impl, sweep_count
from ..utils import profiling

# render_irs_batched's flat timings (info["timings"], summed over the
# passes) and the spans they read; total is the root's wall
FLAT_TIMINGS = {"trace": "rv.trace", "bin": "rv.bin", "dedup": "rv.dedup",
                "finalize": "rv.finalize"}


def _no_pair_stats(nbatch: int, dev):
    return (torch.full((nbatch,), float("inf"), device=dev),
            torch.zeros((nbatch,), device=dev))


def _pair_time_stats(pair_rows, t_c, ok, tmin, tmax):
    """Fold one channel's attenuated times into the per-pair (B,) min/max
    (datagen.py:64-77): min over ok rows with t > 0, max over ok rows."""
    tmin = tmin.scatter_reduce(0, pair_rows, torch.where(ok & (t_c > 0), t_c, float("inf")),
                               "amin", include_self=True)
    tmax = tmax.scatter_reduce(0, pair_rows, torch.where(ok, t_c, 0.0),
                               "amax", include_self=True)
    return tmin, tmax


def _attenuate_and_bin_multi(mic_rows, pair_rows, volumes, positions, times,
                             spec: AttenSpec, length: int, sample_rate, nbatch: int,
                             init_hist=None, tstats=None):
    """Rows (M, 8) with per-row mic and pair, attenuated and added into a
    (B, C, 8, length) bank by index_put_ (datagen.py:80-131, the 'scatter'
    bin mode; render._attenuate_and_bin's admission rules: zero-volume
    rows and bins outside [0, length) are dropped). Returns (bank, tmin,
    tmax), the per-pair time stats folded into ``tstats``."""
    dev = volumes.device
    nonzero = torch.any(volumes != 0, dim=-1)
    basis = _head(spec)
    hist = (torch.zeros((nbatch, spec.nchannels, NUM_BANDS, length), device=dev)
            if init_hist is None else init_hist)
    tmin, tmax = tstats if tstats is not None else _no_pair_stats(nbatch, dev)
    bands = torch.arange(NUM_BANDS, device=dev)[None, :]
    for c in range(spec.nchannels):
        gain, t_c = _channel(spec, basis, mic_rows, positions, times, c)
        tmin, tmax = _pair_time_stats(pair_rows, t_c, nonzero, tmin, tmax)
        idx = _time_bins(t_c, sample_rate)
        keep = nonzero & (idx >= 0) & (idx < length)
        hist[:, c].index_put_((pair_rows[keep, None], bands, idx[keep, None]),
                              (volumes * gain)[keep], accumulate=True)
    return hist, tmin, tmax


def _bin_rows_sorted_multi(mic_rows, pair_rows, volumes, positions, times,
                           spec: AttenSpec, length: int, sample_rate, nbatch: int,
                           init_hist=None, tstats=None):
    """Scatter-free per-pair binning (datagen.py:134-190): rows sort
    stably by the flattened (pair * length + bin) key, and the segmented
    run totals give the (B, C, 8, length) bank densely, with
    _attenuate_and_bin_multi's admission rules. Speaker channels share one
    sort; HRTF's ITD shift makes bins channel-specific, so each ear sorts
    its own. Returns (bank (+ init_hist), tmin, tmax)."""
    nonzero = torch.any(volumes != 0, dim=-1)
    basis = _head(spec)
    flat = nbatch * length

    def key_for(t_c):
        idx = _time_bins(t_c, sample_rate)
        ok = nonzero & (idx >= 0) & (idx < length)
        return torch.where(ok, pair_rows * length + idx, flat)

    tmin, tmax = tstats if tstats is not None else _no_pair_stats(nbatch, volumes.device)
    hists = []
    if spec.is_hrtf:
        for c in range(spec.nchannels):
            gain, t_c = _channel(spec, basis, mic_rows, positions, times, c)
            tmin, tmax = _pair_time_stats(pair_rows, t_c, nonzero, tmin, tmax)
            hists.append(_sorted_hist(key_for(t_c), volumes * gain, flat))
    else:
        tmin, tmax = _pair_time_stats(pair_rows, times, nonzero, tmin, tmax)
        key = key_for(times)
        perm = torch.argsort(key, stable=True)
        sk = key[perm]
        svol, spos, smic = volumes[perm], positions[perm], mic_rows[perm]
        for c in range(spec.nchannels):
            gain, _ = _channel(spec, basis, smic, spos, times, c)
            hists.append(_dense_from_runs(sk, _segmented_run_totals(sk, svol * gain), flat))
    hist = torch.stack(hists).reshape(spec.nchannels, NUM_BANDS, nbatch, length)
    hist = hist.permute(2, 0, 1, 3).contiguous()
    if init_hist is not None:
        hist = init_hist + hist
    return hist, tmin, tmax


def pair_hashes(image_index, pair_rows):
    """Chain hashes seeded by the pair (datagen.py:294-299): chains never
    dedup across pairs. (N, S) chains and (N,) pairs -> two (N, S) int64
    tensors holding uint32 values; h1 = mix32(h1 ^ pair), h2 =
    mix32(h2 + pair * 0x9E3779B9), all mod 2**32."""
    h1, h2 = chain_hashes(image_index)
    pair = pair_rows.to(torch.int64)[:, None]
    h1 = _mix32(h1 ^ pair)
    h2 = _mix32((h2 + ((pair * 0x9E3779B9) & _U32)) & _U32)
    return h1, h2


def _batched_trace_bin(soup, mics, sources, dirs_flat, pair_id, spec: AttenSpec, *,
                       nbatch: int, nreflections: int, length: int, sample_rate,
                       impl: str, bin_mode: str, resort: bool, include_diffuse: bool,
                       stats=None):
    """The multi-pair trace and the binning of its diffuse rows
    (datagen.py:193-305): returns (bank (B, C, 8, L), _Images with
    pair-seeded hashes, per-pair (B,) tmin and tmax of the diffuse
    arrivals). They are the phases (profiling.phase) rv.trace and
    rv.bin."""
    dev = soup.device
    m = dirs_flat.shape[0]
    tmin, tmax = _no_pair_stats(nbatch, dev)
    # int32 flattened keys gate the JAX sorted path; int64 keys here need
    # no gate, which is kept so that the port bins as JAX would
    sorted_bin = bin_mode != "scatter" and nbatch * length < (1 << 31)
    hist = torch.zeros((nbatch, spec.nchannels, NUM_BANDS, length), device=dev)
    if not include_diffuse:
        def consume(row):
            return None
    elif sorted_bin:
        # (R, B*N, .) bounce-major, as the JAX row buffers
        bufs = (torch.empty((nreflections, m, NUM_BANDS), device=dev),
                torch.empty((nreflections, m, 3), device=dev),
                torch.empty((nreflections, m), device=dev))
        bounce = iter(range(nreflections))

        def consume(row):
            b = next(bounce)
            for buf, x in zip(bufs, row[:3]):
                buf[b] = x
    else:
        carry = [hist, tmin, tmax]

        def consume(row):
            vol, pos, tim, mic_rows, pair_rows = row
            carry[:] = _attenuate_and_bin_multi(
                mic_rows, pair_rows, vol, pos, tim, spec, length, sample_rate,
                nbatch, init_hist=carry[0], tstats=tuple(carry[1:]))

    with profiling.phase("rv.trace"):
        img_vol, img_pos, img_time, img_idx = _trace_impl(
            soup, mics, sources, dirs_flat, nreflections=nreflections, impl=impl,
            consume_row=consume, resort=resort, stats=stats, pair_id=pair_id)
    with profiling.phase("rv.bin"):
        if include_diffuse and not sorted_bin:
            hist, tmin, tmax = carry
        elif include_diffuse and nreflections > 0:
            pair_flat = pair_id.repeat(nreflections)  # (R * B*N,), bounce-major
            hist, tmin, tmax = _bin_rows_sorted_multi(
                mics[pair_flat], pair_flat, bufs[0].view(-1, NUM_BANDS),
                bufs[1].view(-1, 3), bufs[2].view(-1), spec, length, sample_rate,
                nbatch, tstats=(tmin, tmax))
            del bufs
        h1, h2 = pair_hashes(img_idx, pair_id)
        slots = torch.arange(NUM_IMAGE_SOURCE, device=dev)
        valid = (slots == 0) | (img_idx != 0)
    return hist, _Images(img_vol, img_pos, img_time, valid, h1, h2), tmin, tmax


def _finalize_hist_batched(hist, imgs: _Images, pair_id, mics, spec: AttenSpec,
                           sample_rate, tmin, tmax, *, nbatch: int, length: int,
                           include_images: bool, remove_direct: bool,
                           trim_predelay: bool):
    """Image dedup over all pairs in one sort, image binning into the bank,
    the per-pair predelay shift and content lengths (datagen.py:308-411).
    The kept image rows fold into the per-pair time stats (duplicates
    share their times, so the deduplicated set gives the JAX min and max).
    With trim_predelay each pair's bank shifts by round(predelay * sr)
    bins, the bins at and before the shift summing into bin 0 (the
    single-pair fixPredelay, rayverb.h:77-97). Returns (bank, content
    lengths (B,) int64)."""
    dev = hist.device
    if include_images:
        chosen = _dedup_rows(imgs, remove_direct)
        pair_rows = pair_id[chosen // NUM_IMAGE_SOURCE]
        hist, tmin, tmax = _bin_rows_sorted_multi(
            mics[pair_rows], pair_rows,
            imgs.volume.reshape(-1, NUM_BANDS)[chosen],
            imgs.position.reshape(-1, 3)[chosen],
            imgs.time.reshape(-1)[chosen],
            spec, length, sample_rate, nbatch, init_hist=hist, tstats=(tmin, tmax))
    predelay = torch.where(torch.isfinite(tmin), tmin, 0.0)
    pos = torch.arange(length, device=dev)
    if trim_predelay:
        shift = torch.floor(predelay * np.float32(sample_rate) + 0.5).to(torch.int64)
        h = hist.reshape(nbatch, -1, length)
        src = pos[None, :] + shift[:, None]                       # (B, L)
        idx = torch.clamp(src, 0, length - 1)[:, None, :].expand(h.shape)
        shifted = torch.where(src[:, None, :] < length, torch.gather(h, 2, idx), 0.0)
        shifted[..., 0] = torch.sum(
            torch.where(pos[None, None, :] <= shift[:, None, None], h, 0.0), dim=-1)
        hist = shifted.reshape(hist.shape)
    occupied = torch.any(torch.any(hist != 0, dim=2), dim=1)      # (B, L)
    content = torch.amax(torch.where(occupied, pos, -1), dim=-1) + 1
    return hist, content


def datagen_bytes(npairs: int, nrays: int, nreflections: int, nblocks: int,
                  length: int, nchannels: int) -> int:
    """Planned peak device bytes of one pass of ``npairs`` pairs of
    ``nrays`` rays, from the shapes: render.render_bytes of the npairs x
    nrays rows, and 8 histogram banks of (npairs, nchannels, 8, length)
    float32 (the bank, its binned copy, and the finalize's FFT buffers: the
    spectrum, its product with the response and the inverse transform, each
    two banks wide at nfft ~ 2 x length)."""
    bank = npairs * nchannels * NUM_BANDS * length * 4
    return render_bytes(npairs * nrays, nreflections, nblocks) + 8 * bank


def choose_pairs_per_pass(npairs: int, nrays: int, nreflections: int, nblocks: int,
                          length: int, nchannels: int, microbatch=None,
                          budget=None) -> int:
    """Whole pairs per pass: ``microbatch`` when given (at most npairs);
    else all pairs when ``budget`` is None or datagen_bytes fits in it;
    else the most pairs that fit (halving, at least 1)."""
    if microbatch is not None:
        if int(microbatch) < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        return min(int(microbatch), npairs)
    per = npairs
    while per > 1 and budget is not None and datagen_bytes(
            per, nrays, nreflections, nblocks, length, nchannels) > budget:
        per = (per + 1) // 2
    return per


def render_irs_batched(
    scene,
    config: RenderConfig,
    sources,
    mics,
    directions,
    *,
    hrtf_table=None,
    impl: str = "auto",
    device=None,
    microbatch: int | None = None,
    bin_mode: str | None = None,
    stats: bool = False,
    mesh=None,
    batch_axis: str = "batch",
):
    """Render B impulse responses through shared sweeps on ``device``
    (None: the card); the counterpart of datagen.py:414-537.

    sources, mics: (B, 3); directions: (B, N, 3), one ray set per pair
    (broadcast one set with np.broadcast_to), numpy or a tensor: they go
    to the device once, where ray_schedule puts each pair's rays in its
    Morton order in one sort (span rv.ray_order, counter ray_order.rows),
    and each pass takes its pairs' rows from there. The config's source
    and mic are ignored. Returns (irs (B, C, L) float32, contents (B,)
    int64), both on the device: L is the histogram_length bound
    (+ KERNEL_LENGTH - 1 for the windowed-sinc bank), each pair's samples
    at and after its content (+ KERNEL_LENGTH - 1 for the sinc bank) are
    zero. The call is
    the root span rv.datagen (utils.profiling): rv.prepare (rv.atten_spec,
    rv.sweep_table, rv.ray_order, rv.filter_params), then per pass
    rv.inputs, rv.trace (rv.phase_a, rv.phase_b: rv.bounce, rv.closest_hit),
    rv.bin, rv.dedup and rv.finalize. With stats=True a third value, an
    info dict: the passes, sweeps, the memory plan, ``timings`` (the
    device-synchronised phase walls trace, bin, dedup, finalize and total,
    and the call's ``spans``, ``counters``, ``call`` and ``once``), issued
    pair tests, and the executed pair tests by sweep kind, counted in the
    sweeps' own launches and copied to the host in the last pass's
    finalize.

    impl: the closest-hit implementation ('auto' | 'cuda' | 'plain').
    microbatch: whole pairs per pass, None to plan from the shapes
    (datagen_bytes against render.memory_budget). bin_mode: 'sorted' or
    'scatter', None to read RAYVERB_BIN.

    mesh: a ``torch.distributed`` DeviceMesh with a ``batch_axis`` axis
    (parallel.make_mesh(axis="batch")); every rank of the world calls this
    function with the same arguments. B must divide by the axis size
    (ValueError otherwise, datagen.py:523-527). Each rank renders its B / d
    whole pairs with this function's single-device body, then the ranks
    all-gather the IRs and contents (the only collective: pairs are
    independent), so every rank returns the full (B, C, L) and (B,), as
    the JAX out_specs=P(batch) present one global array. With stats, the
    info is the rank's own (its passes, phases, issued and executed pairs)
    but for ``pairs``, ``pairs_per_s`` and ``ray_bounces_per_s``, which
    count the whole batch over the rank's wall, the gather included, and
    the added ``mesh`` and ``pairs_per_rank``. A rank outside the mesh
    returns None values."""
    if mesh is not None:
        return _render_irs_on_mesh(
            scene, config, sources, mics, directions, mesh=mesh, batch_axis=batch_axis,
            hrtf_table=hrtf_table, impl=impl, device=device, microbatch=microbatch,
            bin_mode=bin_mode, stats=stats)
    dev = resolve_device(device)
    timings: dict = {}
    with profiling.call("rv.datagen", dev, stats=stats, timings=timings, flat=FLAT_TIMINGS):
        out = _render_irs(scene, config, sources, mics, directions, hrtf_table=hrtf_table,
                          impl=impl, dev=dev, microbatch=microbatch, bin_mode=bin_mode)
    irs, contents, info = out
    if not stats:
        return irs, contents
    b, n, nrefl = info["pairs"], info["rays_per_pair"], config.reflections
    info.update({
        "timings": timings,
        "pairs_per_s": b / max(timings["total"], 1e-9),
        "ray_bounces_per_s": b * n * nrefl / max(timings["total"], 1e-9),
    })
    info.update(executed_pairs(timings))
    return irs, contents, info


def _render_irs(scene, config, sources, mics, directions, *, hrtf_table, impl, dev,
                microbatch, bin_mode):
    """render_irs_batched's single-device body: (irs, contents, info
    without the timings)."""
    sources = np.asarray(sources, np.float32)
    mics = np.asarray(mics, np.float32)
    if not isinstance(directions, torch.Tensor):
        directions = np.asarray(directions, np.float32)
    if directions.ndim != 3 or directions.shape[-1] != 3 or directions.shape[1] == 0:
        raise ValueError(f"directions must be (B, N, 3) with N > 0, got "
                         f"{tuple(directions.shape)}")
    b, n = directions.shape[:2]
    if sources.shape != (b, 3) or mics.shape != (b, 3):
        raise ValueError(f"sources and mics must be ({b}, 3), got {sources.shape} "
                         f"and {mics.shape}")
    nrefl = config.reflections
    with profiling.span("rv.prepare"):
        # the (B * N, 3) rows pair-major, each pair's rays in render_fused's
        # order; whether to re-sort each bounce sweep is decided on the
        # whole population (JAX datagen.py:258-260)
        prep = _prepare(scene, config, directions, dev, hrtf_table=hrtf_table,
                        bin_mode=bin_mode)
        spec, length = prep.spec, prep.length
        per = choose_pairs_per_pass(b, n, nrefl, prep.nblocks, length, spec.nchannels,
                                    microbatch, memory_budget(dev))
        params, flips, nfft, filter_method = device_filter_params(
            config.filter, float(config.sample_rate), float(config.hipass), length,
            str(dev), _finalize_method(config.filter))
    t_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731

    irs, contents = [], []
    for first in range(0, b, per):
        bl = min(per, b - first)
        with profiling.span("rv.inputs"):
            mics_l = t_dev(mics[first:first + bl])
            sources_l = t_dev(sources[first:first + bl])
            dirs_l = prep.directions[first * n:(first + bl) * n]
            pair_id = torch.arange(bl, device=dev).repeat_interleave(n)
        hist, imgs, tmin, tmax = _batched_trace_bin(
            prep.soup, mics_l, sources_l, dirs_l, pair_id, spec,
            nbatch=bl, nreflections=nrefl, length=length,
            sample_rate=config.sample_rate, impl=impl, bin_mode=prep.bin_mode,
            resort=prep.resort, include_diffuse=prep.include_diffuse, stats=prep.pair_stats)
        with profiling.phase("rv.dedup"):
            hist, content = _finalize_hist_batched(
                hist, imgs, pair_id, mics_l, spec, config.sample_rate, tmin, tmax,
                nbatch=bl, length=length, include_images=prep.include_images,
                remove_direct=config.remove_direct, trim_predelay=config.trim_predelay)
            del imgs
        with profiling.phase("rv.finalize"):
            mixed, _ = _finalize_filter(
                hist, content, params, config.volume_scale, flips=flips, nfft=nfft,
                do_normalize=config.normalize, filter_method=filter_method)
            del hist
            if first + per >= b:
                profiling.stage()
        irs.append(mixed)
        contents.append(content)
    irs = irs[0] if len(irs) == 1 else torch.cat(irs)
    contents = contents[0] if len(contents) == 1 else torch.cat(contents)
    passes = -(-b // per)
    info = {
        "pairs": b,
        "rays_per_pair": n,
        "pairs_per_pass": per,
        "passes": passes,
        "sweeps": sweep_count(nrefl) * passes,
        "histogram_length": length,
        "bin_mode": prep.bin_mode,
        "filter_method": filter_method,
        "device": str(dev),
        "memory_plan_bytes": datagen_bytes(per, n, nrefl, prep.nblocks, length,
                                           spec.nchannels),
        "pair_tests_issued": b * sweep_pair_tests(n, prep.soup.num_padded, nrefl),
    }
    return irs, contents, info


def _render_irs_on_mesh(scene, config, sources, mics, directions, *, mesh, batch_axis,
                        stats, **kw):
    """render_irs_batched over the ranks of ``mesh`` (its docstring)."""
    from .sharded import _all_gather, _axis_size

    t_start = time.perf_counter()
    d = _axis_size(mesh, batch_axis)
    if mesh.ndim != 1:
        raise ValueError("render_irs_batched needs a 1-D mesh")
    b = len(directions)
    if b % d:
        raise ValueError(f"batch {b} must divide across the '{batch_axis}' axis "
                         f"({d} devices)")
    if mesh.get_coordinate() is None:
        return (None, None, None) if stats else (None, None)
    rank = mesh.get_local_rank(batch_axis)
    group = mesh.get_group(batch_axis)
    mine = slice(rank * (b // d), (rank + 1) * (b // d))
    out = render_irs_batched(scene, config, np.asarray(sources)[mine], np.asarray(mics)[mine],
                             np.asarray(directions)[mine], stats=stats, **kw)
    irs = _all_gather(out[0], group, d)
    contents = _all_gather(out[1], group, d)
    if not stats:
        return irs, contents
    info = out[2]
    total = time.perf_counter() - t_start
    n = info["rays_per_pair"]
    info.update({
        "mesh": {batch_axis: d},
        "pairs": b,
        "pairs_per_rank": b // d,
        "pairs_per_s": b / max(total, 1e-9),
        "ray_bounces_per_s": b * n * config.reflections / max(total, 1e-9),
    })
    info["timings"]["total"] = total
    return irs, contents, info


def trim_batch(irs, contents, config: RenderConfig):
    """Cut the fixed-shape (B, C, L) outputs of render_irs_batched to each
    pair's render_fused length, on the host (datagen.py:540-565): the
    content length bounds the IR (flatten length, rayverb.cpp:53-57), and
    with config.trim_tail the tail below TRIM_TAIL_FLOOR is cut (trimTail,
    rayverb.cpp:96-122; the fused finalize's trim arithmetic). Returns a
    list of (C, L_i) float32 arrays.

    With the windowed-sinc bank the content length grows by
    KERNEL_LENGTH - 1 first, as render_fused grows it (FastConvolution,
    filters.h:55-80). The JAX trim_batch does not, and so cuts the
    convolution tail off (its fault: datagen.py:561 against render.py:810-815,
    ADVICE.md); this function does not copy it."""
    from ..config.schema import FilterType
    from ..constants import TRIM_TAIL_FLOOR

    if isinstance(irs, torch.Tensor):
        irs = irs.cpu().numpy()
    if isinstance(contents, torch.Tensor):
        contents = contents.cpu().numpy()
    irs = np.asarray(irs, np.float32)
    grow = KERNEL_LENGTH - 1 if config.filter == FilterType.WINDOWED_SINC else 0
    positions = np.arange(irs.shape[-1])[None, :]
    out = []
    for ir, content in zip(irs, np.asarray(contents)):
        content = int(content) + grow
        if config.trim_tail:
            loud = (np.abs(ir) >= TRIM_TAIL_FLOOR) & (positions < content)
            last = int(np.max(np.where(loud, positions, -1)))
            out_len = min(max(last, 0), content)
        else:
            out_len = content
        out.append(ir[:, :out_len])
    return out
