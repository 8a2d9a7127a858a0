#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rayverb_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time:

  1. device   nvidia-smi's name and power limit, the CUDA device name, and
              the nvcc builds of the closest-hit, biquad and sort-key
              kernels, one nvcc per source, started together (with their
              seconds and ptxas' registers)
  2. kernel   the CUDA kernel against its plain PyTorch version on the
              vault scene, on the card: 50,000 Morton-sorted primary rays,
              the first bounce's reversed shadow rows, a ragged batch of 777
              rays with bounds and any-hit thresholds, and a 5-triangle
              scene, each at one slice in table order, at the schedule the
              port chooses (sweep_schedule) and at the slice counts of
              SLICE_SCAN (the ragged batch's chosen schedule is 16
              slices, which the sweep's epilogue merges by the last
              arriver). The kernel's Hit (t, index, hit) must equal
              hit_from_raw of the plain version's results, and the
              executed-pair counters the plain version's, bit for bit;
              the order table of the order
              kernel must equal its plain version's, on the card and on the
              CPU, also on tables of 16,384 and 32,768 random blocks;
              closest-hit rows and decided rows' verdicts must not depend
              on the schedule. On the primary batch, the epilogue's record:
              one closest_hit call's device operations (torch.profiler:
              the order kernel and the sweep, plus a fill with stats, and
              nothing else), the sweep's device ms beside the launch
              floor, and the Hit without bounds against the Hit with them
  3. main     the port's CLI renders the full vault demo (50,000 rays x 128
              reflections, two speakers, 44.1 kHz, 24-bit) on cuda, cold and
              warm; the WAV must read back as 2 finite, non-silent channels
              and every sweep of the render must go through the order and
              sweep kernels
  4. render   render_fused on the vault with the kernel and with the plain
              sweep: the IRs agree to max|d| <= 1e-6 * peak
  5. small    a small box render on the card against the same render on
              the CPU (the path the CPU tests hold against the JAX package):
              within -60 dB of peak
  6. hrtf     the CLI renders the binaural vault demo (hrtf_vault.json:
              50,000 rays x 128 reflections, HRTF) on cuda, cold and warm:
              a stereo WAV, finite and non-silent, every sweep through the
              kernels; render_fused on it with the kernel and with the plain
              sweep, executed-pair counters on: bit-identical IRs and equal
              counts per sweep kind (phase A eager for the counts); a
              small HRTF render on the card against the CPU fed the card's
              trace records (records within the CPU tests' tolerances, IRs
              within -60 dB)
  7. hall     the north-star hall (scripts/gen_hall.py, 101,568 triangles,
              1,024 table blocks) generated into the temporary directory
              and loaded through the native OBJ parser (which must build
              and load) and through the pure-Python reader, each parse and
              scene load with its wall, the two parses bit-equal: 8,192
              Morton-sorted primary rays and a decided batch of 300 shadow
              rows (53 slices), kernel against plain, bit for bit (Hits,
              counters, order tables)
  8. north    the north star: 1,000,000 rays x 16 reflections through the
              hall (and the hall's load times, beside the card's name),
              stereo HRTF, cold and warm,
              with walls, phases, the
              chunk chosen, peak device memory, executed pairs by kind and
              the order kernel's time at this table (1M primary rays, equal
              to its plain version; torch.argsort of its keys beside it);
              then 65,536 rays in one pass against chunks of 16,384 (within
              -60 dB)
  9. order    the order kernel against its plain version, on the card and
              on the CPU, on the edge cases of ops/order_check.py (k = 0,
              k = nblocks, ties at rank 0, k = 31, 32 and 33, axis-parallel
              and tiny directions, ranks that overflow to +inf, random) at
              32, 1,024 and 32,768 blocks (the last sorts its keys in device
              memory); k per group of the north star's primary, bounce and
              shadow batches
 10. biquad   the biquad scan kernel (a chunked parallel recurrence)
              against its plain version, bit for bit, on the card and on
              the CPU (2 channels x 8 bands x 16,384 samples of the vault's
              lowpass, forward and reverse, with and without a content
              length, and with ragged per-series content lengths: 0, 1,
              around 4,096-sample boundaries, around the 256-sample
              chunks and 8,192-sample tiles, and full, in one launch); the
              vault's four-pass bank at 524,288 samples against scipy's
              float64 lfilter (1e-4 of peak); device ms per pass, bytes
              and chain bounds
 11. modular  the CLI with --pipeline modular on the full vault, cold and
              warm, --stats: walls, phases, the trace's ray chunk, every
              sweep through the sweep and order kernels and every filter
              pass through the biquad kernel; the kernel against its plain
              version at the main path's first pass shape (device ms,
              call ms, plain ms)
 12. mod/fus  pipeline.render (scan) against render_fused on the vault's
              directions, trim_predelay off (-60 dB; the trimmed renders
              are compared too, not gated: the fused whole-bin predelay
              shift is a documented deviation); the fused render with
              RAYVERB_FINALIZE_FILTER=scan against the fft one (-60 dB)
 13. raw      --save-raw then --from-raw through the CLI (equal WAVs) and
              pipeline.render against render_from_raw of its saved
              population (bit-identical IRs), --dump-paths (one line per
              ray in the JAX schema, equal to the trace's records), at
              2,000 rays: host zlib and JSON set this phase's walls
 14. datagen  batched IR datagen (parallel.render_irs_batched): BASELINE
              config 5 at full size (the vault, 64 pairs x 4,096 rays x 16
              reflections, stereo HRTF, 16 kHz), cold and warm, with walls,
              pairs/s, ray-bounces/s, peak memory beside the plan, pairs per
              pass, 33 sweeps per pass each through the order and sweep
              kernels, executed pairs by kind, and one warm batch under
              torch.profiler; pairs 0, 21, 42, 63 (normalize off) against
              render_fused of the same pair (1e-5 of peak, equal contents);
              3 pairs on large_square with the kernels and the plain
              versions (bit-identical, equal counters) and on the CPU (-60
              dB); 8 pairs through the scan finalize with the
              Linkwitz-Riley bank (one biquad launch per pass for all pairs)
              against the fft one (-60 dB); 8 pairs on room1.dxf
 15. sharded  parallel.render_fused_sharded at world size one over NCCL
              (make_mesh() on a file:// store in the temporary directory):
              the north star cold and warm against render_fused's warm IR
              of phase 8 (max|d| <= 1e-6 x peak; bit equality printed),
              every sweep through the order and sweep kernels, with the
              info (gathered and distinct image rows, chunks per rank),
              walls, timings and peak memory, and both paths' warm walls
              in turns; then the vault with
              RAYVERB_FINALIZE_FILTER=scan (one biquad launch per pass)
              against render_fused's scan render
 16. datagen_mesh  config 5 through render_irs_batched(mesh=make_mesh(
              axis="batch")), cold and warm, bit for bit against the no-mesh
              batch, with walls and pairs/s
 17. corpus   the demo corpus's covering subset (rayverb_tpu_torch.gen's
              covering(): each combination, in COMBOS order, that brings a
              config, model or material not yet covered; 29 renders cover
              the 14 configs, 16 models and 5 materials) at full size
              through gen.render on cuda, every sweep through the order and
              sweep kernels, each render held against its file in impulses/
              (the JAX package's corpus) by corpus_check (format,
              emptiness, length, decay, balance, spectrum): walls, channels,
              samples, every reading and each bound's worst
 18. parity   kernel_parity: the sweep kernel against the float64
              Moller-Trumbore oracle on the card, 2,048 rows of mixed kinds
              on the vault and on the hall, scripts/kernel_parity.py's gates
 19. keys     the sort-key kernels (ray_bounce_key, ray_shadow_key)
              against their plain versions, bit for bit, on the inputs that
              every bounce of phase A (run eagerly) of a vault render and
              of a config-5 batch keys (50,000 rows; the 64-pair key at 64 x 4,096) and on
              1,048,576 rows over twice the vault's grid; device ms per
              launch beside the plain keys' call ms and the byte bounds.
              Every path (main, hrtf, north star, modular, datagen,
              sharded, mesh, corpus) counts its sort-key launches from 0
              before each run; the CLI's vault runs must key every row by
              the kernels (--stats: no sort_keys.plain), and they and the
              datagen batches launch them at least once a reflection
 20. image graph  phase A of a trace (the direct path and the 9 image
              bounces) by replay of its CUDA graph, the capture included,
              and eagerly, in turns, on the vault at 50,000 to 1,000,000
              rows and on the hall at 1,000,000: walls, the capture, peak
              memory, and the rows up to which the replay is cheaper
              (ops/trace.py IMAGE_GRAPH_ROWS is set from them); then the
              datagen cell's whole batch both ways; the two ways' image
              slots and rows, and the batch's IRs, bit for bit
 21. kernels  one JSON line per the port's kernel table (the sweep, the
              block order, the sweep's epilogue with no launch of its own
              beside the card's launch floor, the biquad scan and the
              sort keys); the
              device line also carries the
              instruction counts of the sweep kernel's loops, read from
              `cuobjdump -sass` where the toolkit has it

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi prints them. Any failure prints
its error and exits non-zero; a watchdog ends the script after 300 s. The
script needs no network and writes only to a temporary directory. It exits
non-zero at once where torch.cuda.is_available() is false or where the
package is not beside it.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from unittest import mock

DEADLINE_S = 300
REPO = os.path.dirname(os.path.abspath(__file__))
VAULT = (
    os.path.join(REPO, "assets", "configs", "vault.json"),
    os.path.join(REPO, "assets", "test_models", "vault.obj"),
    os.path.join(REPO, "assets", "materials", "vault.json"),
)
HRTF_VAULT = (os.path.join(REPO, "assets", "configs", "hrtf_vault.json"), *VAULT[1:])
# the north star's one-pass against chunked check: rays and rays per chunk
CHUNK_CHECK = (65_536, 16_384)
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, HBM3 bandwidth
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
# bytes of one ray's Hit (t float32, index int64, hit bool)
HIT_BYTES = 13
# FP32 operations per pair test, as the JAX kernel's cost estimate counts
# them (rayverb_tpu/ops/intersect_pallas.py:414)
FLOPS_PER_PAIR = 40
# table sizes of the order kernel's edge cases (order_cases): the vault's,
# the hall's, and one whose keys leave shared memory for a scratch
ORDER_CASE_BLOCKS = (32, 1024, 32768)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _watchdog():
    time.sleep(DEADLINE_S)
    _emit({"phase": "watchdog", "error": f"deadline of {DEADLINE_S} s passed"})
    sys.stdout.flush()
    os._exit(3)


class Phase:
    """Times a phase and prints it as one JSON line; fields added to
    .out go into that line."""

    def __init__(self, name):
        self.name = name
        self.out = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        line = {"phase": self.name, "wall_s": round(time.perf_counter() - self.t0, 3)}
        line.update(self.out)
        if exc is not None:
            line["error"] = f"{exc_type.__name__}: {exc}"
        _emit(line)
        return False


def _sass_loops(lib_path):
    """Backward-branch loops of the sweep kernel's SASS (cuobjdump -sass):
    per loop, its instruction count, the instructions before its first
    conditional forward branch (run on every pass), and the counts of a
    few opcodes. None where cuobjdump is missing."""
    import re
    import shutil

    from rayverb_tpu_torch.cuda_build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=60).stdout
    instrs, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "closest_hit_sweep" in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inside and m:
            instrs.append((int(m.group(1), 16), m.group(2).strip()))
    loops = []
    for addr, text in instrs:
        m = re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            body = [t for a, t in instrs if int(m.group(1), 16) <= a <= addr]
            head = next((i for i, t in enumerate(body)
                         if t.startswith("@") and " BRA " in f" {t} "), len(body))
            ops = [t.split()[1] if t.startswith("@") else t.split()[0] for t in body]
            count = lambda p: sum(o.split(".")[0] == p for o in ops)  # noqa: E731
            loops.append({"instructions": len(body), "head": head, **{
                k: count(k) for k in ("FADD", "FMUL", "FFMA", "FSETP", "MUFU",
                                      "LDS", "BRA", "CALL")}})
    return {"kernel_instructions": len(instrs), "loops": loops}


def _profiled_many(calls, reps):
    """Device ms per launch of each kernel of ``calls``, a list of (fn,
    name) pairs, in ONE torch.profiler session: each fn is called ``reps``
    times (one launch of the kernel whose name holds ``name`` each), the
    device synchronised after each call, and each kernel's time is the mean
    of the launches the session reports. On the card it has reported 19 of
    20, 19 of 22, 0 of 5 and 1 of 5 such launches, so a session that
    reports fewer than half of any kernel's launches is run again, up to
    three times, and then raises. Returns {name: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn, _ in calls:
                for _ in range(reps):
                    fn()
                    torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {}
        for _, name in calls:
            times = [e.time_range.end - e.time_range.start for e in events
                     if name in e.name]
            if max(1, reps // 2) <= len(times) <= reps:
                out[name] = sum(times) / len(times) / 1e3
        if len(out) == len(calls):
            return out
        seen.append({name: sum(name in e.name for e in events) for _, name in calls})
        _emit({"profiler_session_reported": seen[-1], "of": reps})
    raise AssertionError(f"the profiler saw {seen} launches of {reps} per session")


def _profiled_ms(fn, kernel, reps):
    """Device ms per launch of the kernel whose name holds ``kernel``, over
    ``reps`` calls of ``fn`` (one launch each): _profiled_many of one."""
    return _profiled_many([(fn, kernel)], reps)[kernel]


def _cuda_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# table slices timed (and compared) beside the two schedules of record
SLICE_SCAN = (1, 2, 4, 8, 16)


def _pair_bound_ms(pairs):
    return pairs * FLOPS_PER_PAIR / FP32_PEAK * 1e3


def _hit_mismatch(a, b):
    """Rows where two Hits differ in any bit of t, index or hit."""
    import torch

    return int(((a.t.view(torch.int32) != b.t.view(torch.int32))
                | (a.index != b.index) | (a.hit != b.hit)).sum())


def _run_schedule(soup, args, order, slices, counts):
    """Kernel vs plain on one batch and schedule: the kernel's Hit against
    hit_from_raw of closest_hit_plain, and the executed-pair counters;
    raises unless they are equal bit for bit. Returns (the record, the
    kernel's Hit)."""
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import closest_hit_plain, hit_from_raw

    pt, pi, p_ex = closest_hit_plain(*args, order, slices, counts=counts, with_stats=True)
    plain = hit_from_raw(pt, pi)
    hit, k_ex = intersect_cuda.closest_hit_cuda(*args, order, slices, counts=counts,
                                                with_stats=True)
    torch.cuda.synchronize()
    both = plain.hit & hit.hit
    rec = {
        "slices": slices,
        "hits": int(hit.hit.sum()),
        "mismatch_hit": _hit_mismatch(hit, plain),
        "mismatch_executed": int((p_ex != k_ex).sum()),
        "executed_pairs": int(k_ex.sum()),
        "max_abs_err": float((plain.t - hit.t).abs()[both].max()) if bool(both.any()) else 0.0,
    }
    rec["ms"] = _cuda_ms(
        lambda: intersect_cuda.closest_hit_cuda(*args, order, slices, counts=counts), 20)
    rec["bound_own_ms"] = _pair_bound_ms(rec["executed_pairs"])
    if rec["mismatch_hit"] or rec["mismatch_executed"]:
        raise AssertionError(f"kernel != plain at {slices} slices: {rec}")
    return rec, hit


def _order_mismatch(got, o, d, tmax, decide, aabb, slices, cpu=True):
    """Entries in which the order kernel's (order, counts) ``got`` differ
    from cull_order of block_order and block_keep, computed on the card
    and (``cpu``) on the CPU."""
    from rayverb_tpu_torch.ops.intersect import block_keep, block_order, cull_order

    mismatch = 0
    for on in ((o.device, "cpu") if cpu else (o.device,)):
        x = [None if v is None else v.to(on) for v in (o, d, tmax, decide, aabb)]
        want = cull_order(block_order(*x[:3], x[4]), block_keep(*x), slices)
        mismatch += sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(got, want))
    return mismatch


def _order_bound(o, d, tmax, decide, boxes, order, counts):
    """The order kernel's least time on the card, as (ms, bound_by, box
    tests): the larger of its box tests' FP32 operations (~40 a slab
    test) over the FP32 peak and its bytes over HBM bandwidth. Its box
    tests: the representative's rank of each (group, block), each ray's
    test of each superblock, and for each ray that met a superblock one
    fine test of each of its blocks (the warp's lanes test them against
    that ray). Its bytes: the rays, their bounds and the boxes read once,
    the order and the counts written."""
    from rayverb_tpu_torch.ops.intersect import _bounds, _slab_pass

    m = o.shape[0]
    groups, nb = order.shape
    per = nb // boxes.shape[0]
    t_max, t_dec = _bounds(m, tmax, decide, o.device)
    cand = (t_max > 0) & (t_max >= t_dec)
    met = 0
    for r0 in range(0, m, 1 << 18):
        r = slice(r0, r0 + (1 << 18))
        met += int((cand[r, None] & _slab_pass(
            o[r, None], d[r, None], 1.0 / d[r, None], boxes, t_max[r, None])).sum())
    tests = groups * nb + m * boxes.shape[0] + met * per
    ops_ms = tests * 40 / FP32_PEAK * 1e3
    bytes_ms = 4 * (8 * m + 8 * (nb + boxes.shape[0]) + order.numel()
                    + counts.numel()) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), tests


def _compare_batch(name, soup, o, d, tmax, decide):
    """Kernel vs plain on one batch, bit for bit, at one slice in table
    order, at the chosen schedule (sweep_schedule: the culled order and
    its counts) and over SLICE_SCAN, each on its own culled order; the
    culled walk against closest_hit_plain's walk of the whole of each
    slice's run of block_order. Returns the batch's record: rows,
    mismatches, executed pairs, times, bounds, the culled walk's share of
    the order."""
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import (
        SWEEP_RAYS, block_keep, block_order, closest_hit_plain, cull_order,
        hit_from_raw, sweep_schedule, table_order,
    )
    from rayverb_tpu_torch.ops.order_check import order_k, order_keys

    args = (o, d, soup.packed, soup.block_aabb, tmax, decide)
    m = o.shape[0]
    nb = soup.block_aabb.shape[0]
    tp = soup.packed.shape[0]
    groups = -(-m // SWEEP_RAYS)
    given = decide if bool((decide > 0).any()) else None
    order, slices, counts = sweep_schedule(o, d, tmax, given, soup)
    # the order kernel against its plain version, on the card and on the CPU
    boxes = soup.super_aabb
    order_mismatch = _order_mismatch((order, counts), o, d, tmax, given, soup.block_aabb,
                                     slices)
    if order_mismatch:
        raise AssertionError(f"batch {name}: the order table differs between its kernel, "
                             f"its plain version and the CPU ({order_mismatch} entries)")

    def launch(s=slices):
        return intersect_cuda.block_order_cuda(o, d, tmax, soup.block_aabb, boxes, s,
                                               t_decide=given)

    order_ms = _cuda_ms(launch, 20)
    order_device_ms = _profiled_ms(launch, "closest_hit_order", 20)
    order_args = (o, d, tmax, soup.block_aabb)
    order_k_per_group = order_k(order_keys(*order_args)).float()
    order_plain_ms = _cuda_ms(lambda: cull_order(
        block_order(*order_args), block_keep(o, d, tmax, given, soup.block_aabb), slices), 5)
    whole = torch.full((groups, 1), nb, dtype=torch.int32, device=o.device)
    table, table_out = _run_schedule(soup, args, table_order(m, nb, o.device), 1, whole)
    chosen, chosen_out = _run_schedule(soup, args, order, slices, counts)
    # the cull is exact: the walk of every slice's whole run of block_order
    ut, ui, uncut_ex = closest_hit_plain(*args, block_order(*order_args), slices,
                                         with_stats=True)
    if (_hit_mismatch(hit_from_raw(ut, ui), chosen_out)
            or int(uncut_ex.sum()) != chosen["executed_pairs"]):
        raise AssertionError(f"batch {name}: the cull changed a Hit or the executed pairs")
    closest = decide == 0
    rows = lambda hit, mask: type(hit)(*(x[mask] for x in hit))  # noqa: E731
    if _hit_mismatch(rows(table_out, closest), rows(chosen_out, closest)):
        raise AssertionError(f"batch {name}: closest-hit rows depend on the schedule")
    # decided rows may return another witness, never another verdict
    verdict = lambda hit: ~hit.hit | (hit.t > decide)  # noqa: E731
    if not torch.equal(verdict(table_out)[~closest], verdict(chosen_out)[~closest]):
        raise AssertionError(f"batch {name}: decided rows' verdicts depend on the schedule")
    scan = []
    for s in (s for s in SLICE_SCAN if s <= nb // 2):
        s_order, s_counts = launch(s)
        scan.append(_run_schedule(soup, args, s_order, s, s_counts)[0])
    plain_ms = _cuda_ms(lambda: closest_hit_plain(*args, order, slices, counts=counts), 2)
    # least time for this work on the card: the larger of the executed pair
    # tests' FP32 operations over the FP32 peak and the bytes the function
    # must move (inputs read once, outputs written once) over HBM bandwidth
    in_bytes = 4 * (8 * m + tp * 16 + soup.block_aabb.numel() + order.numel())
    out_bytes = HIT_BYTES * m
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    # bound_ms counts the executed pairs of one slice in table order, which
    # do not depend on the schedule chosen; bound_own_ms counts the chosen
    # schedule's own pairs
    ops_ms = _pair_bound_ms(table["executed_pairs"])
    own_ms = _pair_bound_ms(chosen["executed_pairs"])
    # the same bound over ISSUED pairs (every ray against every row) and
    # the table re-read once per thread block
    issued_ops_ms = _pair_bound_ms(m * tp)
    reread_ms = groups * tp * 64 / HBM_BYTES_PER_S * 1e3
    order_bound_ms, order_bound_by, order_box_tests = _order_bound(
        o, d, tmax, given, boxes, order, counts)
    rec = {
        "batch": name,
        "rows": m,
        "hits": chosen["hits"],
        "mismatch_hit": sum(r["mismatch_hit"] for r in [table, chosen, *scan]),
        "mismatch_executed": sum(r["mismatch_executed"] for r in [table, chosen, *scan]),
        "max_abs_err": max(table["max_abs_err"], chosen["max_abs_err"]),
        "schedule": {"order": "near_to_far", "slices": slices, "ctas": groups * slices},
        "ms": chosen["ms"],
        "walk_share": int(counts.sum()) / max(1, order.numel()),
        "table_s1_ms": table["ms"],
        "plain_ms": plain_ms,
        "executed_pairs": chosen["executed_pairs"],
        "table_s1_executed_pairs": table["executed_pairs"],
        "issued_pairs": m * tp,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_own_ms": max(own_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_issued_ms": max(issued_ops_ms, reread_ms),
        "slice_scan": [{k: r[k] for k in ("slices", "ms", "executed_pairs")}
                       for r in scan],
        "order_mismatch": order_mismatch,
        "order_ms": order_ms,
        "order_device_ms": order_device_ms,
        "order_k": _k_stats(order_k_per_group),
        "order_plain_ms": order_plain_ms,
        "order_bound_ms": order_bound_ms,
        "order_bound_by": order_bound_by,
        "order_box_tests": order_box_tests,
    }
    return rec


def _order_large_tables(dev, rng):
    """The order kernel against cull_order of block_order and block_keep
    on tables of random AABBs past the vault's size, at 8 slices: 16,384
    blocks (keys sorted in shared memory) and 32,768 (past shared memory:
    keys sorted in device memory). 100 rays in 4 groups, the last group
    dead. Raises on any difference."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import super_aabb

    out = []
    for nb in (16384, 32768):
        lo = rng.uniform(-50, 50, (nb, 3))
        box = np.zeros((nb, 8), np.float32)
        box[:, 0:3] = lo
        box[:, 3:6] = lo + rng.uniform(0.1, 5, (nb, 3))
        o = rng.uniform(-20, 20, (100, 3)).astype(np.float32)
        d = rng.standard_normal((100, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tm = np.where(np.arange(100) < 96, np.inf, 0.0).astype(np.float32)
        o, d, tm, aabb, boxes = (torch.from_numpy(x).to(dev)
                                 for x in (o, d, tm, box, super_aabb(box)))

        def launch():
            return intersect_cuda.block_order_cuda(o, d, tm, aabb, boxes, 8)

        got = launch()
        rec = {"nblocks": nb, "groups": int(got[0].shape[0]),
               "mismatch": _order_mismatch(got, o, d, tm, None, aabb, 8, cpu=False),
               "ms": _cuda_ms(launch, 3)}
        out.append(rec)
        if rec["mismatch"]:
            raise AssertionError(f"order kernel != its plain version on a large table: {rec}")
    return out


def _phase_kernel(ph, dev):
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops.intersect import (
        closest_hit, scene_fields, soup_from_scene, sweep_schedule,
    )
    from rayverb_tpu_torch.ops.trace import _shadow_rows
    from rayverb_tpu_torch.params import soup_from_numpy
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import morton_sort, random_directions

    cfg = load_config(VAULT[0])
    scene = load_scene(VAULT[1], VAULT[2])
    soup = soup_from_scene(scene, device=dev)
    n = cfg.rays
    src = torch.tensor(cfg.source_position, device=dev)
    mic = torch.tensor(cfg.mic_position, device=dev)
    inf = torch.full((n,), float("inf"), device=dev)
    zero = torch.zeros((n,), device=dev)
    d = torch.from_numpy(morton_sort(random_directions(n, seed=0))).to(dev)
    o = src.expand(n, 3).contiguous()
    batches = [_compare_batch("primary", soup, o, d, inf, zero)]
    order, slices, counts = sweep_schedule(o, d, inf, None, soup)
    batches[0]["epilogue"] = _epilogue_record(
        soup, (o, d, soup.packed, soup.block_aabb, inf, zero), order, slices, n, counts)

    first = closest_hit(o, d, soup, impl="plain")
    t_safe = torch.where(first.hit, first.t, 0.0)
    inter = o + d * t_safe[:, None]
    mag = torch.linalg.norm(mic - inter, dim=-1)
    so, sd, sb, sdec, _, _ = _shadow_rows(mic, inter, first.hit, mag)
    batches.append(
        _compare_batch("shadow", soup, so.contiguous(), sd.contiguous(),
                       sb.contiguous(), sdec.contiguous())
    )

    rng = np.random.default_rng(7)
    lo, hi = scene.bounds
    m = 777
    ro = (lo + (hi - lo) * rng.random((m, 3))).astype(np.float32)
    rd = rng.standard_normal((m, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rmag = (0.5 + 8.0 * rng.random(m)).astype(np.float32)
    tm = (rmag * np.float32(1.001) + np.float32(0.01)).astype(np.float32)
    dec = np.where(rng.random(m) < 0.5, rmag, 0.0).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    batches.append(_compare_batch("ragged", soup, t(ro), t(rd), t(tm), t(dec)))

    v0 = rng.uniform(-5, 5, (5, 3)).astype(np.float32)
    e0 = rng.uniform(-4, 4, (5, 3)).astype(np.float32)
    e1 = rng.uniform(-4, 4, (5, 3)).astype(np.float32)
    small = soup_from_numpy(
        device=dev,
        **scene_fields(v0, e0, e1, np.zeros(5, np.int32),
                       np.full((1, 8), 0.9, np.float32),
                       np.full((1, 8), 0.5, np.float32)),
    )
    so = rng.uniform(-8, 8, (1000, 3)).astype(np.float32)
    sd = (rng.uniform(-5, 5, (1000, 3)) - so).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    batches.append(
        _compare_batch("five_triangles", small, t(so), t(sd),
                       torch.full((1000,), float("inf"), device=dev),
                       torch.zeros((1000,), device=dev))
    )
    ph.out["order_large_tables"] = _order_large_tables(dev, rng)
    for b in batches:
        if b["hits"] == 0:
            raise AssertionError(f"batch {b['batch']} has no hits: {b}")
    ph.out["batches"] = batches
    ph.out["rows_compared"] = sum(b["rows"] for b in batches)
    ph.out["mismatches"] = sum(b["mismatch_hit"] + b["mismatch_executed"] for b in batches)
    return batches


def _phase_main(ph, tmp, paths=VAULT, extra=()):
    """The port's CLI on ``paths`` (config, model, materials) with the
    flags ``extra``, cold and warm: a 2-channel WAV, finite and non-silent,
    every sweep through the order and sweep kernels, and every filter pass
    of the modular pipeline (``--pipeline modular``) through the biquad
    kernel, none of the fused render's (its fft finalize); counts reset just
    before each run and read just after. --stats' lines and the shapes of
    the biquad launches go into each run's record."""
    import contextlib
    import io

    import numpy as np

    from rayverb_tpu_torch import cli
    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.io.audio import read_audio
    from rayverb_tpu_torch.ops import biquad_cuda, intersect_cuda, ray_keys_cuda
    from rayverb_tpu_torch.ops.filters import _band_coeffs
    from rayverb_tpu_torch.ops.trace import sweep_count

    cfg = load_config(paths[0])
    expected = sweep_count(cfg.reflections)
    modular = "modular" in extra
    expected_biquad = (
        len(_band_coeffs(cfg.filter, cfg.sample_rate, cfg.hipass)) if modular else 0
    )
    name = os.path.splitext(os.path.basename(paths[0]))[0] + ("_modular" if modular else "")
    real_scan = biquad_cuda.biquad_scan_cuda
    runs = []
    for label in ("cold", "warm"):
        out = os.path.join(tmp, f"{name}_{label}.wav")
        shapes = []

        def record(data, coeffs, **kw):
            shapes.append([list(data.shape), kw.get("content_len"), bool(kw.get("reverse"))])
            return real_scan(data, coeffs, **kw)

        stderr = io.StringIO()
        with mock.patch.object(biquad_cuda, "biquad_scan_cuda", record), \
                contextlib.redirect_stderr(stderr):
            intersect_cuda.launches = 0
            intersect_cuda.order_launches = 0
            biquad_cuda.launches = 0
            ray_keys_cuda.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([*paths, out, "--stats", "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
            launches = intersect_cuda.launches
            order_launches = intersect_cuda.order_launches
            biquad_launches = biquad_cuda.launches
            ray_keys_launches = ray_keys_cuda.launches
        sys.stderr.write(stderr.getvalue())
        if rc != 0:
            raise AssertionError(f"{label} CLI run exited {rc}")
        data, sr, bits = read_audio(out)
        peak = float(np.abs(data).max()) if data.size else 0.0
        sort_keys = _sort_key_rows(stderr.getvalue())
        run = {"run": label, "wall_s": wall, "launches": launches,
               "order_launches": order_launches, "biquad_launches": biquad_launches,
               "ray_keys_launches": ray_keys_launches, "sort_keys": sort_keys,
               "biquad_shapes": shapes,
               "stats": stderr.getvalue().strip().splitlines(),
               "channels": int(data.shape[0]), "samples": int(data.shape[1]),
               "finite": bool(np.all(np.isfinite(data))),
               "sample_rate": sr, "bit_depth": bits, "peak": peak}
        runs.append(run)
        if data.shape[0] != 2 or data.shape[1] == 0:
            raise AssertionError(f"unexpected WAV shape {data.shape}")
        if not np.all(np.isfinite(data)) or peak == 0.0:
            raise AssertionError(f"WAV is not finite or is silent: {run}")
        if launches != expected or order_launches != expected:
            raise AssertionError(
                f"{label} run launched the sweep kernel {launches} times and "
                f"the order kernel {order_launches} times, expected "
                f"{expected} sweeps"
            )
        if biquad_launches != expected_biquad:
            raise AssertionError(
                f"{label} run launched the biquad kernel {biquad_launches} times, "
                f"expected {expected_biquad}"
            )
        # every bounce keys its shadow rows, so a trace launches the sort-key
        # kernels at least once a reflection, and keys no row the plain way
        if (ray_keys_launches < cfg.reflections or sort_keys["plain"] != 0
                or sort_keys["fused"] == 0):
            raise AssertionError(
                f"{label} run keyed its rows outside the sort-key kernels: "
                f"{ray_keys_launches} launches, rows {sort_keys}"
            )
    ph.out["runs"] = runs
    ph.out["expected_sweeps"] = expected
    ph.out["expected_biquad_launches"] = expected_biquad
    return runs


def _phase_render(ph, dev):
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    cfg = load_config(VAULT[0])
    scene = load_scene(VAULT[1], VAULT[2])
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    out = {}
    for impl in ("cuda", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ir, info = render_fused(scene, cfg, dirs, impl=impl, device=dev, stats=True)
        out[impl] = (ir, time.perf_counter() - t0, info)
    a, b = out["cuda"][0], out["plain"][0]
    if a.shape != b.shape:
        raise AssertionError(f"IR shapes differ: {a.shape} vs {b.shape}")
    peak = float(np.abs(b).max())
    diff = float(np.abs(a.astype(np.float64) - b).max())
    ph.out.update({
        "shape": list(a.shape),
        "peak": peak,
        "max_abs_diff": diff,
        "bit_identical": bool(np.array_equal(a, b)),
        "kernel_wall_s": out["cuda"][1],
        "plain_wall_s": out["plain"][1],
        "kernel_timings": out["cuda"][2]["timings"],
        "plain_timings": out["plain"][2]["timings"],
    })
    if not (np.all(np.isfinite(a)) and peak > 0):
        raise AssertionError("render is not finite or is silent")
    if diff > 1e-6 * peak:
        raise AssertionError(f"kernel render differs from plain: {diff} > 1e-6 * {peak}")


def _phase_small_vs_cpu(ph, dev):
    """The card's render (kernel) against the CPU's (plain sweep, the path
    the CPU tests hold against the JAX package) on a small box scene:
    within -60 dB of peak, forgiving single-bin impulse displacement."""
    import numpy as np

    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    cfg = parse_config(json.dumps({
        "rays": 128, "reflections": 6, "sample_rate": 16000, "bit_depth": 16,
        "source_position": [0.031, 1.989, 2.007],
        "mic_position": [0.013, 2.017, 0.021],
        "attenuation_model": {"speakers": [
            {"direction": [0, 0, 1], "shape": 0.5},
            {"direction": [1, 0, 0], "shape": 0.0}]},
        "filter": "linkwitz_riley", "trim_predelay": True, "seed": 3,
    }))
    scene = load_scene(
        os.path.join(REPO, "assets", "test_models", "large_square.obj"),
        os.path.join(REPO, "assets", "materials", "mat.json"),
    )
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    gpu, _ = render_fused(scene, cfg, dirs, device=dev)
    cpu, _ = render_fused(scene, cfg, dirs, device="cpu")
    err = _ir_error(gpu, cpu)
    ph.out.update({"shape_gpu": list(gpu.shape), "shape_cpu": list(cpu.shape),
                   "max_err_over_peak": err})
    if not np.all(np.isfinite(gpu)) or err >= 1e-3 or abs(gpu.shape[-1] - cpu.shape[-1]) > 1:
        raise AssertionError(f"card render differs from the CPU's: {ph.out}")


def _ir_error(got, want):
    """max |got - want| / peak(want), forgiving single-sample displacement
    (the CPU tests' -60 dB criterion)."""
    import numpy as np

    n = min(got.shape[-1], want.shape[-1])
    peak = float(np.abs(want).max())
    g = got[:, :n].astype(np.float64)
    errs = [np.abs(g - np.roll(want, s, axis=-1)[:, :n]) for s in (0, 1, -1)]
    return float(np.minimum(np.minimum(errs[0], errs[1]), errs[2]).max()) / peak


def _phase_hrtf_render(ph, dev):
    """render_fused on the binaural vault with the kernel and with the plain
    sweep, executed-pair counters on: bit-identical IRs, equal counts per
    sweep kind (the kernel's counted with phase A eager, as the plain
    render runs it: phase A's graph pads its sweeps)."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops import trace
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    cfg = load_config(HRTF_VAULT[0])
    scene = load_scene(HRTF_VAULT[1], HRTF_VAULT[2])
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    out = {}
    for impl in ("cuda", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ir, info = render_fused(scene, cfg, dirs, impl=impl, device=dev, stats=True)
        out[impl] = (ir, time.perf_counter() - t0, info)
    with mock.patch.object(trace, "_image_graph_engages", lambda *a: False):
        eager_a, info = render_fused(scene, cfg, dirs, impl="cuda", device=dev, stats=True)
    a, b = out["cuda"][0], out["plain"][0]
    ea = info["pair_tests_executed"]
    eb = out["plain"][2]["pair_tests_executed"]
    ph.out.update({
        "rays": cfg.rays,
        "shape": list(a.shape),
        "bit_identical": bool(a.shape == b.shape and np.array_equal(a, b)
                              and np.array_equal(eager_a, b)),
        "max_abs_diff": float(np.abs(a.astype(np.float64) - b).max()) if a.shape == b.shape else None,
        "kernel_wall_s": out["cuda"][1],
        "plain_wall_s": out["plain"][1],
        "kernel_timings": out["cuda"][2]["timings"],
        "pair_tests_executed": ea,
        "pair_tests_executed_plain": eb,
        "pair_tests_executed_graphed": out["cuda"][2]["pair_tests_executed"],
        "pair_tests_issued": out["cuda"][2]["pair_tests_issued"],
    })
    if a.shape[0] != 2 or not (np.all(np.isfinite(a)) and np.abs(a).max() > 0):
        raise AssertionError("HRTF render is not stereo, finite and non-silent")
    if not ph.out["bit_identical"] or ea != eb:
        raise AssertionError("the kernel's HRTF render or its executed pairs differ from "
                             f"the plain sweep's: {ph.out}")


def _phase_hrtf_small_vs_cpu(ph, dev):
    """A small HRTF render on the card against the CPU's render of the
    card's own trace records: the records of the card's trace against the
    CPU's trace (the CPU tests' tolerances: volumes 1e-6, positions 1e-4 m,
    times 1e-6 s, image indices equal), and the IRs within -60 dB. The CPU
    renders the card's records because an ear's ITD shift moves an arrival
    across a bin edge when two traces' times differ by an ulp near it."""
    import numpy as np

    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops import render
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    cfg = parse_config(json.dumps({
        "rays": 256, "reflections": 8, "sample_rate": 16000, "bit_depth": 16,
        "source_position": [0.031, 1.989, 2.007],
        "mic_position": [0.013, 2.017, 0.021],
        "attenuation_model": {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
        "filter": "twopass", "trim_predelay": True, "seed": 3,
    }))
    scene = load_scene(
        os.path.join(REPO, "assets", "test_models", "large_square.obj"),
        os.path.join(REPO, "assets", "materials", "mat.json"),
    )
    dirs = random_directions(cfg.rays, seed=cfg.seed)
    real = render._trace_impl
    recorded = {}

    def recorder(label):
        def record(*args, consume_row, **kw):
            rows = recorded[label] = []

            def keep(row):
                rows.append(tuple(x.cpu() for x in row))
                consume_row(row)

            images = real(*args, consume_row=keep, **kw)
            recorded[label + ":images"] = tuple(x.cpu() for x in images)
            return images

        return record

    def replay(*args, consume_row, **kw):
        for row in recorded["card"]:
            consume_row(row)
        return recorded["card:images"]

    try:
        render._trace_impl = recorder("card")
        gpu, _ = render.render_fused(scene, cfg, dirs, device=dev)
        render._trace_impl = recorder("cpu")
        render.render_fused(scene, cfg, dirs, device="cpu")
        render._trace_impl = replay
        cpu, _ = render.render_fused(scene, cfg, dirs, device="cpu")
    finally:
        render._trace_impl = real
    diffs = {}
    card, host = recorded["card"], recorded["cpu"]
    for i, name in enumerate(("volume", "position", "time")):
        diffs["diffuse_" + name] = max(float((a[i] - b[i]).abs().max())
                                       for a, b in zip(card, host))
    ci, hi_ = recorded["card:images"], recorded["cpu:images"]
    for i, name in enumerate(("volume", "position", "time")):
        diffs["image_" + name] = float((ci[i] - hi_[i]).abs().max())
    diffs["image_index_mismatch"] = int((ci[3] != hi_[3]).sum())
    err = _ir_error(gpu, cpu)
    ph.out.update({"shape_gpu": list(gpu.shape), "shape_cpu": list(cpu.shape),
                   "record_max_abs_diff": diffs, "max_err_over_peak": err})
    tol = {"diffuse_volume": 1e-6, "diffuse_position": 1e-4, "diffuse_time": 1e-6,
           "image_volume": 1e-6, "image_position": 1e-3, "image_time": 1e-6,
           "image_index_mismatch": 0}
    if any(diffs[k] > v for k, v in tol.items()):
        raise AssertionError(f"the card's HRTF trace differs from the CPU's: {diffs}")
    if gpu.shape[0] != 2 or not np.all(np.isfinite(gpu)) or err >= 1e-3 or gpu.shape != cpu.shape:
        raise AssertionError(f"card HRTF render differs from the CPU's: {ph.out}")


def _hall(ph, tmp):
    """The north-star hall, generated into ``tmp`` by scripts/gen_hall.py
    (probe.write_hall) and loaded with mat.json; its sizes and walls go
    into the phase's line."""
    from rayverb_tpu_torch.probe import HALL_MATERIALS, write_hall
    from rayverb_tpu_torch.scene import load_scene

    path = os.path.join(tmp, "hall.obj")
    t0 = time.perf_counter()
    ph.out["triangles"] = write_hall(path)
    ph.out["generate_s"] = time.perf_counter() - t0
    ph.out.update(_hall_loads(path))
    return load_scene(path, HALL_MATERIALS)


def _hall_loads(path):
    """The hall's scene load (OBJ parse + compile) and its parse alone
    through the native parser and through the pure-Python reader
    (RAYVERB_NO_NATIVE=1), each with its wall; the native library must have
    built and loaded, and both parses must agree bit for bit."""
    from rayverb_tpu_torch import cuda_build
    from rayverb_tpu_torch.native import get_lib
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.scene.objloader import load_obj

    mat = os.path.join(REPO, "assets", "materials", "mat.json")
    t0 = time.perf_counter()
    if get_lib() is None:
        raise AssertionError("the native OBJ parser did not build or load")
    out = {"native_build_s": time.perf_counter() - t0,
           "native_library": os.path.relpath(cuda_build.build_info["objparse"]["path"], REPO)}
    meshes = {}
    for label, env in (("native", {}), ("python", {"RAYVERB_NO_NATIVE": "1"})):
        with mock.patch.dict(os.environ, env):
            t0 = time.perf_counter()
            meshes[label] = load_obj(path)
            out[f"parse_s_{label}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            load_scene(path, mat)
            out[f"load_scene_s_{label}"] = time.perf_counter() - t0
    a, b = meshes["native"], meshes["python"]
    if (a.vertices.tobytes() != b.vertices.tobytes() or a.faces.tobytes() != b.faces.tobytes()
            or a.face_materials != b.face_materials):
        raise AssertionError("the native and Python OBJ parsers differ on the hall")
    return out


# rows of the hall's decided batch (shadow rows: half to the mic, half to
# points beyond the walls): few enough groups that sweep_slices gives it
# more slices (53) than any closest-hit batch takes (CLOSEST_SLICES, 8)
HALL_DECIDED_ROWS = 300


def _phase_hall(ph, dev, scene):
    """8,192 Morton-sorted primary rays against the hall's 1,024-block table,
    and a decided batch of HALL_DECIDED_ROWS shadow rows from points in the
    hall, kernel against plain, bit for bit (as in kernel_vs_plain)."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.ops.intersect import CLOSEST_SLICES, soup_from_scene
    from rayverb_tpu_torch.probe import NORTH_STAR
    from rayverb_tpu_torch.utils.directions import morton_sort, random_directions

    soup = soup_from_scene(scene, device=dev)
    m = 8192
    d = torch.from_numpy(morton_sort(random_directions(m, seed=0))).to(dev)
    o = torch.tensor(NORTH_STAR["source_position"], device=dev).expand(m, 3).contiguous()
    rec = _compare_batch("hall_primary", soup, o, d,
                         torch.full((m,), float("inf"), device=dev),
                         torch.zeros((m,), device=dev))
    rng = np.random.default_rng(11)
    lo, hi = scene.bounds
    n = HALL_DECIDED_ROWS
    points = (lo + (hi - lo) * rng.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
    # odd rows to the mic; even rows to points beyond the walls, which every
    # one of them hits
    away = rng.standard_normal((n, 3))
    away *= 2.0 * np.linalg.norm(hi - lo) / np.linalg.norm(away, axis=1, keepdims=True)
    target = np.where((np.arange(n) % 2 == 1)[:, None],
                      np.asarray(NORTH_STAR["mic_position"], np.float32), points + away)
    along = (target - points).astype(np.float32)
    mag = np.linalg.norm(along, axis=1).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)  # noqa: E731
    decided = _compare_batch("hall_decided", soup, t(points), t(along / mag[:, None]),
                             t(mag * np.float32(1.001) + np.float32(0.01)), t(mag))
    ph.out.update({"table_blocks": int(soup.block_aabb.shape[0]), "batch": rec,
                   "decided_batch": decided})
    if rec["hits"] != m:
        raise AssertionError(f"primary rays inside the closed hall must all hit: {rec['hits']}")
    if decided["hits"] < n // 2:
        raise AssertionError(f"the hall's decided batch has {decided['hits']} hits of {n}")
    if decided["schedule"]["slices"] <= CLOSEST_SLICES:
        raise AssertionError(f"the hall's decided batch ran {decided['schedule']}, not "
                             f"more slices than a closest-hit batch")
    return rec


def _sort_key_rows(stats):
    """{'fused': n, 'plain': n}: the sort_keys.* counters of --stats' text
    (0 where a counter is absent)."""
    rows = {"fused": 0, "plain": 0}
    for ln in stats.splitlines():
        if ln.startswith("counters: "):
            for kv in ln[len("counters: "):].split():
                k, v = kv.split("=")
                if k.startswith("sort_keys."):
                    rows[k[len("sort_keys."):]] += int(v)
    return rows


def _phase_north_star(ph, dev, scene, hall_loads):
    """The north star, cold and warm, then a one-pass against a chunked
    render of a smaller population; the hall's load times (``hall_loads``:
    the native OBJ parser and the pure-Python reader) beside the card's
    name. Returns (runs, the warm IR)."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.device import card_name_and_power
    from rayverb_tpu_torch.ops import biquad_cuda, intersect_cuda, ray_keys_cuda
    from rayverb_tpu_torch.ops.intersect import CLOSEST_SLICES, soup_from_scene
    from rayverb_tpu_torch.ops.order_check import order_keys
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.probe import NORTH_STAR
    from rayverb_tpu_torch.utils.directions import morton_sort, random_directions

    cfg = parse_config(json.dumps(NORTH_STAR))
    dirs = random_directions(cfg.rays, seed=0)
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        intersect_cuda.launches = 0
        intersect_cuda.order_launches = 0
        biquad_cuda.launches = 0
        ray_keys_cuda.launches = 0
        t0 = time.perf_counter()
        ir, info = render_fused(scene, cfg, dirs, device=dev, stats=True)
        wall = time.perf_counter() - t0
        biquad_launches = biquad_cuda.launches
        warm_ir = ir
        run = {
            "run": label, "wall_s": wall,
            "trace_bin_s": info["timings"]["trace_bin"],
            "finalize_s": info["timings"]["finalize"],
            "timings": info["timings"],
            "ray_chunk": info["ray_chunk"], "chunks": info["chunks"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "memory_estimate_bytes": info["memory_estimate_bytes"],
            "pair_tests_executed": info["pair_tests_executed"],
            "pair_tests_executed_total": info["pair_tests_executed_total"],
            "pair_tests_issued": info["pair_tests_issued"],
            "ray_bounces_per_s": info["ray_bounces_per_s"],
            "launches": intersect_cuda.launches,
            "order_launches": intersect_cuda.order_launches,
            "biquad_launches": biquad_launches,
            "ray_keys_launches": ray_keys_cuda.launches,
            "filter_method": info["filter_method"],
            "shape": list(ir.shape),
        }
        runs.append(run)
        _emit({"north_star_run": run})
        if ir.shape[0] != 2 or not np.all(np.isfinite(ir)) or np.abs(ir).max() == 0:
            raise AssertionError(f"north-star IR is not stereo, finite and non-silent: {run}")
        if run["launches"] == 0 or run["order_launches"] == 0 or run["ray_keys_launches"] == 0:
            raise AssertionError(f"north star ran no kernel: {run}")
        # its finalize is the fft bank: the biquad kernel has no launch
        if run["filter_method"] != "fft" or run["biquad_launches"] != 0:
            raise AssertionError(f"north star's finalize is not the fft bank: {run}")
    # the order kernel's time per launch at this table: the 1M primary rays
    soup = soup_from_scene(scene, device=dev)
    m = cfg.rays
    d = torch.from_numpy(morton_sort(dirs)).to(dev)
    o = torch.tensor(cfg.source_position, device=dev).expand(m, 3).contiguous()
    tm = torch.full((m,), float("inf"), device=dev)
    order_args = (o, d, tm, soup.block_aabb)

    def launch():
        return intersect_cuda.block_order_cuda(*order_args, soup.super_aabb, CLOSEST_SLICES)

    order_ms = _cuda_ms(launch, 5)
    order_device_ms = _profiled_ms(launch, "closest_hit_order", 20)
    order, counts = launch()
    if _order_mismatch((order, counts), o, d, tm, None, soup.block_aabb, CLOSEST_SLICES,
                       cpu=False):
        raise AssertionError("the order kernel differs from its plain version at 1M rays")
    primary_walk_share = int(counts.sum()) / order.numel()
    order_bound_ms, _, _ = _order_bound(o, d, tm, None, soup.super_aabb, order, counts)
    # the sort half alone, as a yardstick: torch.argsort of the same keys
    keys = order_keys(*order_args)
    sort_ms = _cuda_ms(lambda: torch.argsort(keys, dim=1), 5)
    del keys
    nb = soup.block_aabb.shape[0]
    # one pass against chunks, on a smaller population
    small = parse_config(json.dumps(dict(NORTH_STAR, rays=CHUNK_CHECK[0])))
    sdirs = random_directions(small.rays, seed=1)
    one, one_info = render_fused(scene, small, sdirs, device=dev)
    chunked, chunk_info = render_fused(scene, small, sdirs, device=dev,
                                       ray_chunk=CHUNK_CHECK[1])
    err = _ir_error(chunked, one)
    ph.out.update({
        "card": card_name_and_power(), "hall_loads": hall_loads,
        "hall_triangles": scene.num_triangles,
        "table_blocks": nb, "rays": cfg.rays,
        "reflections": cfg.reflections, "runs": runs,
        "order_ms_per_launch_1M_rays": order_ms,
        "order_device_ms_1M_rays": order_device_ms,
        "primary_walk_share": primary_walk_share,
        "order_sort_call_ms_1M_rays": sort_ms,
        "order_table_bytes": order.numel() * 4,
        "order_bound_ms_1M_rays": order_bound_ms,
        "chunk_check": {"rays": small.rays, "one_pass_chunks": one_info["chunks"],
                        "chunks": chunk_info["chunks"], "shape": list(chunked.shape),
                        "max_err_over_peak": err},
    })
    if one_info["chunks"] != 1 or chunk_info["chunks"] != -(-CHUNK_CHECK[0] // CHUNK_CHECK[1]):
        raise AssertionError(f"chunking not as asked: {ph.out['chunk_check']}")
    if err >= 1e-3 or chunked.shape != one.shape:
        raise AssertionError(f"chunked render differs from one pass: {ph.out['chunk_check']}")
    return runs, warm_ir


def _k_stats(k):
    """[min, mean, max] of blocks of finite rank per group."""
    k = k.float()
    return [int(k.min()), float(k.mean()), int(k.max())]


def _north_star_k(dev, scene):
    """k (blocks of finite rank per group, which the order kernel sorts)
    of three batches of one north-star render: its primary batch (the
    first bounce sweep, from the source), its second bounce sweep and its
    first shadow sweep of the diffuse phase (the first decided sweep of
    exactly one row per ray)."""
    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops import intersect, trace
    from rayverb_tpu_torch.ops.order_check import order_k, order_keys
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.probe import NORTH_STAR
    from rayverb_tpu_torch.utils.directions import random_directions

    cfg = parse_config(json.dumps(NORTH_STAR))
    real = intersect.sweep_schedule
    seen = {}

    def record(origins, dirs, t_max, t_decide, soup, pair_sums=None):
        if origins.shape[0] == cfg.rays:
            kind = ("shadow" if t_decide is not None
                    else ("bounce" if "primary" in seen else "primary"))
            if kind not in seen:
                seen[kind] = _k_stats(
                    order_k(order_keys(origins, dirs, t_max, soup.block_aabb)))
        return real(origins, dirs, t_max, t_decide, soup, pair_sums)

    # the recorder reads each sweep's order on the host: the eager loops,
    # since a captured bounce cannot wait for the device
    with mock.patch.object(intersect, "sweep_schedule", record), \
            mock.patch.object(trace, "_graph_engages", lambda *a: False), \
            mock.patch.object(trace, "_image_graph_engages", lambda *a: False):
        render_fused(scene, cfg, random_directions(cfg.rays, seed=0), device=dev)
    if set(seen) != {"primary", "bounce", "shadow"}:
        raise AssertionError(f"the north star's batches were not all seen: {sorted(seen)}")
    return {f"north_star_{kind}": v for kind, v in seen.items()}


def _phase_order(ph, dev, scene):
    """The order kernel against cull_order of block_order and block_keep,
    on the card and on the CPU, on order_cases at ORDER_CASE_BLOCKS (at
    32,768 blocks its keys are sorted in device memory, k = nblocks among
    them), at 1 and 8 slices, without and with any-hit thresholds; then k
    per group of the north star's primary, bounce and shadow batches."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import super_aabb
    from rayverb_tpu_torch.ops.order_check import order_cases, order_k, order_keys

    cases = []
    for nb in ORDER_CASE_BLOCKS:
        for name, *arrays in order_cases(nb):
            o, d, t_max, aabb = (torch.from_numpy(x).to(dev) for x in arrays)
            boxes = torch.from_numpy(super_aabb(arrays[3])).to(dev)
            third = np.arange(arrays[2].shape[0]) % 3
            decided = np.where(third == 1, arrays[2], np.where(third == 2, np.inf, 0))
            mismatch = 0
            for decide in (None, torch.from_numpy(decided.astype(np.float32)).to(dev)):
                for slices in (1, 8):
                    got = intersect_cuda.block_order_cuda(o, d, t_max, aabb, boxes, slices,
                                                          t_decide=decide)
                    mismatch += _order_mismatch(got, o, d, t_max, decide, aabb, slices)
            cases.append({
                "nblocks": nb, "case": name,
                "spill": intersect_cuda.order_launch(nb, got[0].shape[0]).spill,
                "k": order_k(order_keys(o, d, t_max, aabb)).tolist(),
                "mismatch": mismatch,
            })
    mismatches = sum(c["mismatch"] for c in cases)
    ph.out.update(cases=cases, mismatches=mismatches)
    if mismatches or not any(c["spill"] and c["case"] == "k_all_inside" for c in cases):
        raise AssertionError(f"order kernel != its plain version on its edge cases: {cases}")
    ph.out["north_star_k"] = _north_star_k(dev, scene)
    return ph.out


def _device_ops(calls, reps):
    """Device operations per call of each fn of ``calls`` ((label, fn)
    pairs) under torch.profiler, ``reps`` calls each, the device
    synchronised after every call: {label: {kernel kind: events per
    call}}, kinds "order", "sweep", "fill" (PyTorch's fill kernel) and
    "other" (any other device event, memsets and copies included). The
    profiler has lost events on the card (_profiled_many; here once 16 of
    20 launches of each kernel), so a session in which some kind reads
    below half a call is run again, up to three times, as _profiled_many
    does; a kind still reads below 1.0 when it dropped some, and a kind it
    never saw is absent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                    torch.cuda.synchronize()
            kinds = {}
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                kind = next((k for k, n in (("order", "closest_hit_order"),
                                            ("sweep", "closest_hit_sweep"),
                                            ("fill", "FillFunctor")) if n in e.name),
                            "other")
                kinds[kind] = kinds.get(kind, 0) + 1
            if min(kinds.values(), default=0) >= reps / 2:
                break
        out[label] = {k: v / reps for k, v in sorted(kinds.items())}
    return out


def _epilogue_record(soup, args, order, slices, m, counts):
    """The sweep's epilogue (the slices' merge and the Hit, written by
    closest_hit_sweep itself) at one batch: the device operations of one
    intersect.closest_hit call counted by torch.profiler (no bounds, with
    bounds, with stats), which must be the order kernel and the sweep
    (and one fill with stats) and nothing else; the sweep's device ms
    beside the card's floor for one launch (a 1-element zero_() in the same
    session); the epilogue's plain version's ms (hit_from_raw of the raw
    results) and its bound by bytes (the Hit written); and the kernel's
    Hit without bounds (null t_max and t_decide) against its Hit with
    +inf and 0 tensors."""
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import closest_hit, hit_from_raw, raw_from_hit

    o, d, t_max = args[0], args[1], args[4]
    ops = _device_ops([
        ("no_bounds", lambda: closest_hit(o, d, soup)),
        ("bounds", lambda: closest_hit(o, d, soup, t_max=t_max)),
        ("stats", lambda: closest_hit(o, d, soup, t_max=t_max, with_stats=True)),
    ], 20)
    for label, kinds in ops.items():
        want = {"order", "sweep"} | ({"fill"} if label == "stats" else set())
        if set(kinds) != want or min(kinds.values()) < 0.5 or max(kinds.values()) > 1.0:
            raise AssertionError(f"one closest_hit call ({label}) is not {sorted(want)} "
                                 f"on the device: {kinds}")
    one = torch.zeros((1,), device=o.device)
    prof = _profiled_many([
        (lambda: intersect_cuda.closest_hit_cuda(*args, order, slices, counts=counts),
         "closest_hit_sweep"),
        (one.zero_, "FillFunctor")], 20)
    hit = intersect_cuda.closest_hit_cuda(*args, order, slices, counts=counts)
    null = closest_hit(o, d, soup)
    raw_t, raw_i = raw_from_hit(hit, t_max)
    mismatch = _hit_mismatch(hit_from_raw(raw_t, raw_i), hit) + _hit_mismatch(null, hit)
    if mismatch:
        raise AssertionError(f"epilogue: {mismatch} rows differ without bounds or back "
                             f"through raw_from_hit")
    return {
        "device_ops_per_call": ops,
        "slices": slices,
        "sweep_ms": prof["closest_hit_sweep"],
        "launch_floor_ms": prof["FillFunctor"],
        "plain_ms": _cuda_ms(lambda: hit_from_raw(raw_t, raw_i), 20),
        "bound_ms": HIT_BYTES * m / HBM_BYTES_PER_S * 1e3,
        "mismatch": mismatch,
    }


# the biquad kernel's checks (biquad_vs_plain): series of the vault's bank
# (2 channels x 8 bands) at BIQUAD_CHECK_SAMPLES samples, kernel against
# plain bit for bit, with a content length of BIQUAD_CHECK_CONTENT; and at
# BIQUAD_FULL_SAMPLES (the vault's histogram_length, the longest series its
# renders give the scan) against scipy's float64 lfilter
BIQUAD_CHECK_SAMPLES = 16_384
BIQUAD_CHECK_CONTENT = 12_345
# per-series content lengths of the ragged checks, one per series of the
# vault's bank: around 4,096-sample boundaries, and around the kernel's
# chunks (256 samples) and tiles (8,192)
BIQUAD_RAGGED = (0, 1, 4095, 4096, 4097, 8191, 8192, 8193, 100, 12_345, 16_383, 16_384,
                 16_384, 2048, 6000, 9999)
BIQUAD_RAGGED_CHUNKED = (0, 1, 255, 256, 257, 511, 512, 513, 8191, 8192, 8193, 8447, 8448,
                         12_345, 16_383, 16_384)
BIQUAD_FULL_SAMPLES = 524_288
# the full-length check's tolerance, relative to the float64 reference's
# peak: the float32 state drifts from float64 over the series, and the JAX
# scan is validated against scipy to ~1e-4 (rayverb_tpu/ops/filters.py:161)
BIQUAD_FULL_TOL = 1e-4
# cycles per sample of the recurrence's dependent chain (a multiply, a
# subtract and an add from one output to the next, ~4 cycles each), and per
# float64 carry step of the chunked schedule (a multiply and two adds, ~8
# cycles each)
BIQUAD_CHAIN_CYCLES = 12
BIQUAD_CARRY_CYCLES = 24
# FP32 operations per sample of one pass (5 multiplies, 4 adds/subtracts)
BIQUAD_FLOPS_PER_SAMPLE = 9
# the raw_and_dump phase's population: the vault at this many rays
RAW_DUMP_RAYS = 2_000


def _sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return float(proc.stdout.strip().splitlines()[0]) * 1e6


def _biquad_bounds(series, samples, content=None):
    """Least times of one biquad pass over (series, samples) whose series
    hold ``content`` samples in all (None: every sample): bytes (the
    content read once, every sample written once) over HBM bandwidth, FP32
    operations over the FP32 peak; and the chunked schedule's own chain at
    the card's maximum clock: one lane's two walks of a chunk and its
    float64 carry steps (twice through the warp, once per tile before its
    own)."""
    from rayverb_tpu_torch.ops.filters import CHUNK, TILE

    content = series * samples if content is None else content
    bytes_ms = 4 * (content + series * samples) / HBM_BYTES_PER_S * 1e3
    ops_ms = BIQUAD_FLOPS_PER_SAMPLE * content / FP32_PEAK * 1e3
    tiles = -(-samples // (CHUNK * TILE))
    chain = 2 * CHUNK * BIQUAD_CHAIN_CYCLES + (2 * TILE + tiles - 1) * BIQUAD_CARRY_CYCLES
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_bound_ms": bytes_ms,
        "ops_bound_ms": ops_ms,
        "chain_bound_ms": chain / _sm_clock_hz() * 1e3,
    }


def _vault_scan_passes(dev, channels=2):
    """The vault's Linkwitz-Riley passes as the scan finalize runs them:
    [(coeffs (channels * 8, 5) float32 on dev, reverse)], the direction
    the cumulative parity of the bank's reversals."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops.filters import _band_coeffs

    cfg = load_config(VAULT[0])
    out, orientation = [], False
    for coeffs, flip in _band_coeffs(cfg.filter, cfg.sample_rate, cfg.hipass):
        orientation ^= flip
        c = np.tile(coeffs.astype(np.float32), (channels, 1))
        out.append((torch.from_numpy(c).to(dev), orientation))
    return out


def _band_signals(rng, series, samples):
    """Histogram-like band signals: ~5 % of the samples carry an arrival,
    decaying over the length."""
    import numpy as np

    x = rng.standard_normal((series, samples)) * np.exp(-np.arange(samples) / (samples / 5))
    return np.where(rng.random((series, samples)) < 0.05, x, 0.0).astype(np.float32)


def _bit_mismatch(a, b):
    import torch

    return int((a.view(torch.int32) != b.cpu().to(a.device).view(torch.int32)).sum())


def _phase_biquad(ph, dev):
    """The biquad_scan kernel against its plain version, bit for bit, on
    the card and on the CPU: the vault's lowpass forward and reverse, with
    and without a content length (the samples after it +0), and with
    ragged per-series lengths around 4,096-sample boundaries and around
    the kernel's chunks and tiles; then the whole four-pass bank at the
    vault's length against scipy's float64 lfilter, and its first forward
    and reverse passes at that length bit for bit; device ms per pass
    (torch.profiler) and ms per call (CUDA events), bounds and
    registers."""
    import numpy as np
    import scipy.signal as sps
    import torch

    from rayverb_tpu_torch import cuda_build
    from rayverb_tpu_torch.ops import biquad_cuda
    from rayverb_tpu_torch.ops.filters import biquad_onepass_plain

    rng = np.random.default_rng(11)
    passes = _vault_scan_passes(dev)
    series = passes[0][0].shape[0]
    x = torch.from_numpy(_band_signals(rng, series, BIQUAD_CHECK_SAMPLES)).to(dev)
    cases = []
    for coeffs, reverse in passes[:2]:
        for content in (None, BIQUAD_CHECK_CONTENT):
            kern = biquad_cuda.biquad_scan_cuda(x, coeffs, reverse=reverse, content_len=content)
            plain = biquad_onepass_plain(x, coeffs, reverse=reverse, content_len=content)
            cpu = biquad_onepass_plain(x.cpu(), coeffs.cpu(), reverse=reverse,
                                       content_len=content)
            torch.cuda.synchronize()
            tail = kern[:, BIQUAD_CHECK_SAMPLES if content is None else content:]
            cases.append({
                "reverse": reverse, "content_len": content,
                "mismatch": _bit_mismatch(kern, plain),
                "mismatch_cpu": _bit_mismatch(kern, cpu),
                "tail_not_plus_zero": int((tail.view(torch.int32) != 0).sum()),
                "max_abs_err": float((kern - plain).abs().max()),
                "peak": float(plain.abs().max()),
            })
    # ragged per-series content lengths (the batched finalize's): 0, 1,
    # around the kernels' chunk and tile edges, and full, one launch for
    # all series
    for coeffs, reverse, ragged in [(c, r, g) for g in (BIQUAD_RAGGED, BIQUAD_RAGGED_CHUNKED)
                                    for c, r in passes[:2]]:
        lens = torch.tensor(ragged[:series], dtype=torch.int32, device=dev)
        kern = biquad_cuda.biquad_scan_cuda(x, coeffs, reverse=reverse, content_len=lens)
        plain = biquad_onepass_plain(x, coeffs, reverse=reverse, content_len=lens)
        cpu = biquad_onepass_plain(x.cpu(), coeffs.cpu(), reverse=reverse, content_len=lens.cpu())
        torch.cuda.synchronize()
        tails = sum(int((kern[i, int(n):].view(torch.int32) != 0).sum())
                    for i, n in enumerate(lens.tolist()))
        cases.append({
            "reverse": reverse, "content_len": lens.tolist(),
            "mismatch": _bit_mismatch(kern, plain),
            "mismatch_cpu": _bit_mismatch(kern, cpu),
            "tail_not_plus_zero": tails,
            "max_abs_err": float((kern - plain).abs().max()),
            "peak": float(plain.abs().max()),
        })
    ph.out["cases"] = cases
    if any(c["mismatch"] or c["mismatch_cpu"] or c["tail_not_plus_zero"] for c in cases):
        raise AssertionError(f"biquad kernel != plain: {cases}")
    # the whole bank at the vault's length against float64 lfilter
    full = _band_signals(rng, series, BIQUAD_FULL_SAMPLES)
    out = torch.from_numpy(full).to(dev)
    ref = full.astype(np.float64)
    for coeffs, reverse in passes:
        out = biquad_cuda.biquad_scan_cuda(out, coeffs, reverse=reverse)
        for s, (b0, b1, b2, a1, a2) in enumerate(coeffs.cpu().numpy().astype(np.float64)):
            sig = ref[s, ::-1] if reverse else ref[s]
            y = sps.lfilter([b0, b1, b2], [1.0, a1, a2], sig)
            ref[s] = y[::-1] if reverse else y
    got = out.cpu().numpy().astype(np.float64)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    ph.out["full_length"] = {"samples": BIQUAD_FULL_SAMPLES, "series": series,
                             "passes": len(passes), "max_err_over_peak": err,
                             "tolerance": BIQUAD_FULL_TOL}
    if not np.isfinite(err) or err >= BIQUAD_FULL_TOL:
        raise AssertionError(f"biquad kernel differs from float64 lfilter: {err}")
    xf = torch.from_numpy(full).to(dev)
    # the first forward and reverse passes at the full length, bit for bit:
    # 64 tiles a series, so the chained scan's fold of its predecessors'
    # aggregates runs its second round of 32 (tiles 33 on)
    long_cases = []
    for coeffs, reverse in passes[:2]:
        kern = biquad_cuda.biquad_scan_cuda(xf, coeffs, reverse=reverse)
        plain = biquad_onepass_plain(xf, coeffs, reverse=reverse)
        torch.cuda.synchronize()
        long_cases.append({"reverse": reverse, "mismatch": _bit_mismatch(kern, plain),
                           "max_abs_err": float((kern - plain).abs().max())})
    ph.out["full_length"]["kernel_vs_plain"] = long_cases
    if any(c["mismatch"] for c in long_cases):
        raise AssertionError(f"biquad kernel != plain at {BIQUAD_FULL_SAMPLES}: {long_cases}")
    coeffs = passes[0][0]
    calls = {"forward": lambda: biquad_cuda.biquad_scan_cuda(xf, coeffs),
             "reverse": lambda: biquad_cuda.biquad_scan_cuda(xf, coeffs, reverse=True)}
    ph.out["ms_per_pass"] = {k: _profiled_ms(fn, "biquad_scan", 20) for k, fn in calls.items()}
    ph.out["call_ms_per_pass"] = {k: _cuda_ms(fn, 20) for k, fn in calls.items()}
    ph.out["bounds"] = _biquad_bounds(series, BIQUAD_FULL_SAMPLES)
    log = cuda_build.build_info["biquad_scan"]["log"]
    ph.out["ptxas"] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    return ph.out


def _biquad_at_shape(dev, shape, reverse):
    """The kernel and its plain version at a pass shape of the main path:
    (S, T) random band signals, the vault's first coefficients; bit for
    bit, with the kernel's device ms per launch (torch.profiler), its ms
    per call (CUDA events, the wrapper's host work included) and the plain
    version's (one call)."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.ops import biquad_cuda
    from rayverb_tpu_torch.ops.filters import biquad_onepass_plain

    s, t = shape
    coeffs = _vault_scan_passes(dev, channels=s // 8)[0][0]
    x = torch.from_numpy(_band_signals(np.random.default_rng(5), s, t)).to(dev)
    kern = biquad_cuda.biquad_scan_cuda(x, coeffs, reverse=reverse)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = biquad_onepass_plain(x, coeffs, reverse=reverse)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rec = {"shape": [s, t], "reverse": reverse, "mismatch": _bit_mismatch(kern, plain),
           "max_abs_err": float((kern - plain).abs().max()),
           "ms": _profiled_ms(lambda: biquad_cuda.biquad_scan_cuda(x, coeffs, reverse=reverse),
                              "biquad_scan", 20),
           "call_ms": _cuda_ms(lambda: biquad_cuda.biquad_scan_cuda(x, coeffs, reverse=reverse),
                               20),
           "plain_ms": plain_ms, **_biquad_bounds(s, t)}
    if rec["mismatch"]:
        raise AssertionError(f"biquad kernel != plain at the main path's shape: {rec}")
    return rec


def _phase_modular_main(ph, dev, tmp):
    """The CLI with --pipeline modular on the full vault, cold and warm
    (_phase_main), the chunk its dense trace chose (trace.trace's plan),
    and the biquad kernel against its plain version at the shape of the
    main path's first filter pass."""
    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops.intersect import soup_from_scene
    from rayverb_tpu_torch.ops.render import choose_ray_chunk, memory_budget
    from rayverb_tpu_torch.ops.trace import trace_bytes
    from rayverb_tpu_torch.scene import load_scene

    runs = _phase_main(ph, tmp, VAULT, extra=("--pipeline", "modular"))
    cfg = load_config(VAULT[0])
    nblocks = soup_from_scene(load_scene(VAULT[1], VAULT[2]), device=dev).block_aabb.shape[0]
    chunk = choose_ray_chunk(cfg.rays, cfg.reflections, nblocks, None,
                             memory_budget(dev), plan=trace_bytes)
    ph.out["ray_chunk"] = chunk
    ph.out["trace_bytes_planned"] = trace_bytes(chunk, cfg.reflections, nblocks)
    shape, _, reverse = runs[-1]["biquad_shapes"][0]
    ph.out["biquad_at_main_shape"] = _biquad_at_shape(dev, shape, reverse)
    return runs


def _phase_modular_vs_fused(ph, dev):
    """pipeline.render (scan filters) against render_fused on the vault's
    directions, each gated at -60 dB (_ir_error), as the JAX package's
    tests/test_render_fused.py holds its two paths:

    - the vault config with trim_predelay off: sample for sample;
    - the vault config with both trims on and the causal one-pass biquad:
      the fused render shifts the predelay by whole bins (a documented
      deviation), so it is held to the untrimmed modular render advanced
      by round(predelay * sr) samples (test_render_fused._compare_predelay).

    That shift contract is exact only for a causal filter: with the vault's
    zero-phase Linkwitz-Riley bank the fused render cuts the reverse passes'
    ringing before the first arrival at bin 0, so the Linkwitz-Riley pair
    with trim_predelay on is printed as a reading, not gated. Then the fused
    render with RAYVERB_FINALIZE_FILTER=scan against the fused fft render,
    vault config as it is."""
    import numpy as np

    from rayverb_tpu_torch import pipeline
    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops import biquad_cuda
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    with open(VAULT[0]) as f:
        doc = json.load(f)
    cfg = parse_config(json.dumps(doc))
    scene = load_scene(VAULT[1], VAULT[2])
    dirs = random_directions(cfg.rays, seed=cfg.seed)

    def pair(overrides):
        """(fused with trim_predelay as the vault, untrimmed modular advanced
        by the fused render's predelay shift when it is on)"""
        trimmed = parse_config(json.dumps(dict(doc, **overrides)))
        nopd = parse_config(json.dumps(dict(doc, **dict(overrides, trim_predelay=False))))
        fused, info = render_fused(scene, trimmed, dirs, device=dev)
        modular = pipeline.render(nopd, scene, directions=dirs, device=dev).channels
        shift = int(np.floor(info["predelay"] * trimmed.sample_rate + 0.5))
        return fused, modular[:, shift:], shift

    def beyond(a, b):
        n = min(a.shape[-1], b.shape[-1])
        return max(float(np.abs(a[:, n:]).max(initial=0.0)),
                   float(np.abs(b[:, n:]).max(initial=0.0))) / float(np.abs(b).max())

    fused_nopd, modular_nopd, _ = pair({"trim_predelay": False})
    err = _ir_error(modular_nopd, fused_nopd)
    fused_1p, modular_1p, shift_1p = pair({"filter": "onepass"})
    err_1p = _ir_error(modular_1p, fused_1p)
    fused, _ = render_fused(scene, cfg, dirs, device=dev)
    modular = pipeline.render(cfg, scene, directions=dirs, device=dev).channels
    with mock.patch.dict(os.environ, RAYVERB_FINALIZE_FILTER="scan"):
        biquad_cuda.launches = 0
        fused_scan, scan_info = render_fused(scene, cfg, dirs, device=dev)
        scan_launches = biquad_cuda.launches
    scan_err = _ir_error(fused_scan, fused)
    ph.out.update({
        "shape_fused_no_predelay": list(fused_nopd.shape),
        "shape_modular_no_predelay": list(modular_nopd.shape),
        "max_err_over_peak": err,
        "beyond_common_over_peak": beyond(modular_nopd, fused_nopd),
        "onepass_trimmed_shift_samples": shift_1p,
        "shape_fused_onepass_trimmed": list(fused_1p.shape),
        "shape_modular_onepass_untrimmed_shifted": list(modular_1p.shape),
        "onepass_trimmed_max_err_over_peak": err_1p,
        "onepass_trimmed_beyond_common_over_peak": beyond(modular_1p, fused_1p),
        "shape_fused": list(fused.shape), "shape_modular": list(modular.shape),
        "lr_trimmed_max_err_over_peak_not_gated": _ir_error(modular, fused),
        "lr_trimmed_vs_untrimmed_shifted_max_err_over_peak_not_gated":
            _ir_error(modular_nopd[:, shift_1p:], fused),
        "fused_scan_filter_method": scan_info["filter_method"],
        "fused_scan_biquad_launches": scan_launches,
        "fused_scan_max_err_over_peak": scan_err,
        "shape_fused_scan": list(fused_scan.shape),
    })
    finite = all(np.all(np.isfinite(a)) for a in
                 (fused_nopd, modular_nopd, fused_1p, modular_1p, modular, fused_scan))
    if not finite or max(err, ph.out["beyond_common_over_peak"]) >= 1e-3:
        raise AssertionError(f"the modular render differs from the fused one: {ph.out}")
    if max(err_1p, ph.out["onepass_trimmed_beyond_common_over_peak"]) >= 1e-3:
        raise AssertionError(f"the trimmed fused render breaks the shift contract: {ph.out}")
    if scan_err >= 1e-3 or scan_launches == 0 or scan_info["filter_method"] != "scan":
        raise AssertionError(f"the fused scan finalize differs from the fft one: {ph.out}")


def _phase_raw_and_dump(ph, dev, tmp):
    """--save-raw, then --from-raw, then --dump-paths through the CLI on
    the vault at RAW_DUMP_RAYS rays: the WAVs of the direct modular render
    and of the raw file are equal, and so are the IRs of pipeline.render
    and render_from_raw of its saved population (bit for bit); the dump has
    one JSON line per ray of R {"position": [x, y, z], "volume": v} in the
    JAX schema, equal to the trace's diffuse records. The phase's cost is
    host zlib and JSON, not the card."""
    import numpy as np

    from rayverb_tpu_torch import cli, engine, pipeline
    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.io.audio import read_audio
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    with open(VAULT[0]) as f:
        doc = dict(json.load(f), rays=RAW_DUMP_RAYS)
    cfg_path = os.path.join(tmp, "vault_raw.json")
    with open(cfg_path, "w") as f:
        json.dump(doc, f)
    paths = [cfg_path, *VAULT[1:]]
    raw = os.path.join(tmp, "vault_raw.npz")
    dump = os.path.join(tmp, "vault_paths.jsonl")
    walls = {}
    for label, extra in (("save_raw", ["--pipeline", "modular", "--save-raw", raw]),
                         ("from_raw", ["--from-raw", raw]),
                         ("dump_paths", ["--dump-paths", dump])):
        t0 = time.perf_counter()
        rc = cli.main([*paths, os.path.join(tmp, f"{label}.wav"), "--device", "cuda", *extra])
        walls[label] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"the CLI with {extra} exited {rc}")
    wav = {k: read_audio(os.path.join(tmp, f"{k}.wav"))[0] for k in walls}
    wav_equal = bool(wav["save_raw"].shape == wav["from_raw"].shape
                     and np.array_equal(wav["save_raw"], wav["from_raw"]))
    cfg = parse_config(json.dumps(doc))
    scene = load_scene(VAULT[1], VAULT[2])
    direct = pipeline.render(cfg, scene, directions=random_directions(cfg.rays, seed=cfg.seed),
                             device=dev)
    lib_raw = os.path.join(tmp, "lib_raw.npz")
    engine.save_raw(lib_raw, direct.raw)
    again = pipeline.render_from_raw(cfg, engine.load_raw(lib_raw), device=dev)
    ir_equal = bool(direct.channels.shape == again.channels.shape
                    and np.array_equal(direct.channels, again.channels))
    with open(dump) as f:
        lines = [json.loads(ln) for ln in f]
    schema_ok = all(
        isinstance(line, list) and len(line) == cfg.reflections
        and all(set(e) == {"position", "volume"} and len(e["position"]) == 3 for e in line)
        for line in lines
    )
    outputs = direct.raytracer.outputs
    pos = np.array([[e["position"] for e in line] for line in lines])
    vol = np.array([[e["volume"] for e in line] for line in lines])
    want_pos = outputs.diffuse_position.cpu().numpy().astype(np.float64)
    want_vol = outputs.diffuse_volume.cpu().numpy().astype(np.float64).mean(axis=-1)
    dump_diff = (float(np.abs(pos - want_pos).max()), float(np.abs(vol - want_vol).max()))
    ph.out.update({
        "rays": cfg.rays, "reflections": cfg.reflections, "walls_s": walls,
        "raw_bytes": os.path.getsize(raw), "dump_bytes": os.path.getsize(dump),
        "wav_equal": wav_equal, "ir_bit_identical": ir_equal,
        "shape": list(direct.channels.shape), "dump_lines": len(lines),
        "dump_schema_ok": schema_ok, "dump_max_abs_diff_position_volume": dump_diff,
        "note": "host zlib (np.savez_compressed) and JSON set this phase's walls, not the card",
    })
    if not (wav_equal and ir_equal and schema_ok and len(lines) == cfg.rays
            and dump_diff == (0.0, 0.0)):
        raise AssertionError(f"raw round trip or path dump failed: {ph.out}")


# BASELINE.json config 5 (scripts/bench_datagen.py:46-74, bench.py:180-215):
# 64 source/receiver pairs x 4,096 rays x 16 reflections through the vault,
# stereo HRTF facing +z, 16 kHz, trim_tail off; the config's source and mic
# are replaced per pair
DATAGEN = {
    "rays": 4096,
    "reflections": 16,
    "sample_rate": 16000,
    "bit_depth": 16,
    "source_position": [0, 0, 0],
    "mic_position": [0, 0, 0],
    "attenuation_model": {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}},
    "trim_tail": False,
}
DATAGEN_PAIRS = 64
# the pairs held to render_fused of the same pair, and the scan batch's size
DATAGEN_SINGLE = (0, 21, 42, 63)
DATAGEN_SCAN_PAIRS = 8
# the DXF batch: room1.dxf with mat.json, config 5 at this many pairs
DATAGEN_DXF_PAIRS = 8
# config 5's named buffers reckoned from the shapes (bytes): the bank, the
# diffuse row buffers, the image records, the mirrored chains at bounce 8 and
# the largest image sweep's order table; one pass
DATAGEN_PLAN_BYTES = {"bank": 134e6, "row_buffers": 201e6, "image_records": 150e6,
                      "mirrored_chains": 85e6, "order_table": 12e6}


def _datagen_inputs(scene, pairs, rays):
    """Config 5's pairs (scripts/bench_datagen.py:66-74): sources and mics
    from default_rng(17) at 20-80 % of the scene's bounds, ray set i from
    random_directions(rays, seed=100 + i)."""
    import numpy as np

    from rayverb_tpu_torch.utils.directions import random_directions

    rng = np.random.default_rng(17)
    lo, hi = np.asarray(scene.bounds)
    span = hi - lo
    sources = (lo + span * (0.2 + 0.6 * rng.random((pairs, 3)))).astype(np.float32)
    mics = (lo + span * (0.2 + 0.6 * rng.random((pairs, 3)))).astype(np.float32)
    dirs = np.stack([random_directions(rays, seed=100 + i) for i in range(pairs)])
    return sources, mics, dirs


def _per_pair_peak_ok(irs):
    import torch

    peaks = irs.abs().amax(dim=(1, 2))
    return bool(torch.isfinite(irs).all()) and bool((peaks > 0).all())


def _datagen_run(label, scene, cfg, sources, mics, dirs, dev, **kw):
    """One batch with stats and executed-pair counters, the kernels'
    counts reset just before it and read just after, and the peak device
    memory of the call."""
    import torch

    from rayverb_tpu_torch.ops import biquad_cuda, intersect_cuda, ray_keys_cuda
    from rayverb_tpu_torch.parallel.datagen import render_irs_batched

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    intersect_cuda.launches = 0
    intersect_cuda.order_launches = 0
    biquad_cuda.launches = 0
    ray_keys_cuda.launches = 0
    t0 = time.perf_counter()
    irs, contents, info = render_irs_batched(scene, cfg, sources, mics, dirs, device=dev,
                                             stats=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (intersect_cuda.launches, intersect_cuda.order_launches,
                biquad_cuda.launches, ray_keys_cuda.launches)
    run = {"run": label, "wall_s": wall, "pairs_per_s": len(sources) / wall,
           "ray_bounces_per_s": dirs.shape[0] * dirs.shape[1] * cfg.reflections / wall,
           "launches": launches[0], "order_launches": launches[1],
           "biquad_launches": launches[2], "ray_keys_launches": launches[3],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "shape": list(irs.shape), **info}
    return irs, contents, run


class _ScanCapture:
    """Wraps biquad_cuda.biquad_scan_cuda while a batch runs and keeps the
    inputs and output of its first forward and first reverse launch."""

    def __enter__(self):
        import torch

        from rayverb_tpu_torch.ops import biquad_cuda

        real = biquad_cuda.biquad_scan_cuda
        self.kept = {}

        def spy(data, coeffs, *, reverse=False, content_len=None):
            out = real(data, coeffs, reverse=reverse, content_len=content_len)
            key = "reverse" if reverse else "forward"
            if key not in self.kept:
                lens = content_len.clone() if isinstance(content_len, torch.Tensor) else content_len
                self.kept[key] = (data.clone(), coeffs.clone(), lens, out.clone())
            return out

        self._patch = mock.patch.object(biquad_cuda, "biquad_scan_cuda", spy)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def _scan_passes_vs_plain(kept, contents):
    """The captured scan passes against biquad_onepass_plain on the card:
    the kernel's own output of that launch, bit for bit, and the per-series
    lengths equal to the batch's per-pair contents; the kernel's device ms
    per launch on those inputs (torch.profiler)."""
    import torch

    from rayverb_tpu_torch.ops import biquad_cuda
    from rayverb_tpu_torch.ops.filters import biquad_onepass_plain

    out = {}
    for key in ("forward", "reverse"):
        data, coeffs, lens, got = kept[key]
        s = data.shape[0]
        want_lens = contents.to(lens.device, torch.int32).repeat_interleave(s // contents.numel())
        t0 = time.perf_counter()
        plain = biquad_onepass_plain(data, coeffs, reverse=key == "reverse", content_len=lens)
        torch.cuda.synchronize()
        out[key] = {"shape": list(data.shape), "lens_min": int(lens.min()),
                    "lens_max": int(lens.max()), "lens_are_contents": bool(torch.equal(lens, want_lens)),
                    "mismatch": int((plain.view(torch.int32) != got.view(torch.int32)).sum()),
                    "finite": bool(torch.isfinite(got).all()),
                    "plain_s": time.perf_counter() - t0,
                    "ms": _profiled_ms(lambda: biquad_cuda.biquad_scan_cuda(
                        data, coeffs, reverse=key == "reverse", content_len=lens),
                        "biquad_scan", 20)}
        if out[key]["mismatch"] or not out[key]["lens_are_contents"] or not out[key]["finite"]:
            raise AssertionError(f"the datagen scan's {key} pass differs from the plain "
                                 f"version: {out[key]}")
    return out


class _SweepCapture:
    """Wraps intersect_cuda.closest_hit_cuda while a batch runs and keeps
    copies of the inputs (with the order kernel's table and the slices)
    of the sweeps it is asked for: by call index (0 is the direct path's
    B-row sweep, 1 the primary sweep) and, under "largest_image", the
    image-phase sweep (odd calls after the primary, while image bounces
    run) with the most rows. Launches pass through unchanged, and the
    trace runs its eager loops: a replayed bounce makes no call to wrap."""

    def __init__(self, calls, image_calls):
        self.calls, self.image_calls = calls, image_calls
        self.kept, self.count = {}, 0

    def __enter__(self):
        from rayverb_tpu_torch.ops import intersect_cuda, trace
        from rayverb_tpu_torch.ops.intersect import _bounds

        real = intersect_cuda.closest_hit_cuda

        def spy(o, d, packed, aabb, t_max, t_decide, order, slices, **kw):
            i = self.count
            self.count += 1
            name = self.calls.get(i)
            if name is None and i in self.image_calls and (
                    "largest_image" not in self.kept
                    or o.shape[0] > self.kept["largest_image"][0].shape[0]):
                name = "largest_image"
                self.kept["largest_image_call"] = i
            if name is not None:
                # an absent bound (the kernel reads +inf or 0) kept as a tensor
                bounds = _bounds(o.shape[0], t_max, t_decide, o.device)
                self.kept[name] = tuple(x.clone() for x in (o, d, *bounds, order)) + (
                    slices, kw["counts"].clone())
            return real(o, d, packed, aabb, t_max, t_decide, order, slices, **kw)

        self._patches = [mock.patch.object(intersect_cuda, "closest_hit_cuda", spy),
                         mock.patch.object(trace, "_graph_engages", lambda *a: False),
                         mock.patch.object(trace, "_image_graph_engages", lambda *a: False)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def _datagen_sweeps_vs_plain(soup, kept, npairs):
    """Each captured config 5 sweep against its plain version on the card:
    the order kernel's order and counts against cull_order of block_order
    and block_keep, and the sweep kernel's
    Hit and executed-pair counters against closest_hit_plain's, bit for
    bit (_run_schedule). The shadow sweep's live rows must come first and
    run pair-major: at most one run of equal origins (a mic) per pair.
    Returns a record per sweep."""
    import torch

    out = {}
    for name in ("primary", "shadow", "largest_image"):
        o, d, t_max, t_decide, order, slices, counts = kept[name]
        live = t_max > 0
        nlive = int(live.sum())
        lo = o[:nlive]
        origin_runs = 1 + int((lo[1:] != lo[:-1]).any(dim=1).sum()) if nlive else 0
        if name == "shadow" and not (bool(live[:nlive].all()) and origin_runs <= npairs):
            raise AssertionError(f"config 5's shadow rows are not pair-major with the dead "
                                 f"rows last: {origin_runs} origin runs, {nlive} live rows")
        order_mismatch = _order_mismatch((order, counts), o, d, t_max, t_decide,
                                         soup.block_aabb, slices, cpu=False)
        t0 = time.perf_counter()
        rec, _ = _run_schedule(soup, (o, d, soup.packed, soup.block_aabb, t_max, t_decide),
                               order, slices, counts)
        torch.cuda.synchronize()
        out[name] = {"rows": o.shape[0], "live_rows": nlive, "origin_runs": origin_runs,
                     "slices": slices, "order_mismatch": order_mismatch,
                     "decided_rows": int((t_decide > 0).sum()),
                     "mismatch_hit": rec["mismatch_hit"],
                     "mismatch_executed": rec["mismatch_executed"], "hits": rec["hits"],
                     "executed_pairs": rec["executed_pairs"], "ms": rec["ms"],
                     "compare_s": time.perf_counter() - t0}
        if order_mismatch:
            raise AssertionError(f"config 5 {name} sweep: the order kernel differs from "
                                 f"its plain version: {out[name]}")
    out["largest_image"]["call"] = kept["largest_image_call"]
    return out


def _phase_datagen(ph, dev):
    """Batched IR datagen (rayverb_tpu_torch.parallel.render_irs_batched):
    config 5 at full size cold and warm (walls, pairs/s, ray-bounces/s, peak
    memory against the plan, pairs per pass, IR shape, sweeps each through
    the order and sweep kernels, executed pairs by kind) and one warm batch
    under torch.profiler; 4 pairs of the batch (normalize off) against
    render_fused of the same pair on the card (1e-5 of peak, equal
    contents); 3 pairs x 256 rays x 6 reflections on large_square with the
    kernels and with the plain versions (bit-identical, equal counters) and
    on the CPU (-60 dB); 8 pairs of config 5 with the Linkwitz-Riley bank
    through the scan finalize (one biquad launch per pass for all pairs)
    against the fft one (-60 dB); 8 pairs on room1.dxf (finite, non-silent)."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.constants import NUM_IMAGE_SOURCE
    from rayverb_tpu_torch.ops.filters import _band_coeffs
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.ops.trace import sweep_count
    from rayverb_tpu_torch.parallel.datagen import render_irs_batched
    from rayverb_tpu_torch.profile_render import device_breakdown
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    scene = load_scene(VAULT[1], VAULT[2])
    cfg = parse_config(json.dumps(DATAGEN))
    sources, mics, dirs = _datagen_inputs(scene, DATAGEN_PAIRS, cfg.rays)
    expected = sweep_count(cfg.reflections)
    runs = []
    for label in ("cold", "warm"):
        irs, contents, run = _datagen_run(label, scene, cfg, sources, mics, dirs, dev)
        runs.append(run)
        _emit({"datagen_run": run})
        if run["shape"] != [DATAGEN_PAIRS, 2, run["histogram_length"]] or not _per_pair_peak_ok(irs):
            raise AssertionError(f"config 5 IRs are not (64, 2, L), finite and non-silent: {run}")
        if (run["launches"] != expected * run["passes"] or run["order_launches"] != run["launches"]
                or run["sweeps"] != run["launches"] or run["biquad_launches"] != 0):
            raise AssertionError(f"config 5 did not run {expected} sweeps per pass through "
                                 f"the order and sweep kernels: {run}")
        if run["ray_keys_launches"] < cfg.reflections * run["passes"]:
            raise AssertionError(f"config 5 did not key its shadow rows by the sort-key "
                                 f"kernels: {run}")
    prof = device_breakdown(
        lambda: render_irs_batched(scene, cfg, sources, mics, dirs, device=dev))
    ph.out.update(pairs=DATAGEN_PAIRS, rays=cfg.rays, reflections=cfg.reflections,
                  runs=runs, expected_sweeps_per_pass=expected,
                  plan_bytes=DATAGEN_PLAN_BYTES, profiled_warm_batch=prof)

    # 4 pairs of the batch, normalize off, against render_fused of each;
    # the batch's own primary sweep (262,144 Morton-ordered rows), its
    # first pure shadow sweep (pair-major rows, the first bounce past the
    # image phase) and its largest image-phase sweep are kept, and held
    # against their plain versions below
    flat = parse_config(json.dumps(dict(DATAGEN, normalize=False)))
    n_img = min(cfg.reflections, NUM_IMAGE_SOURCE - 1)
    with _SweepCapture({1: "primary", 2 * n_img + 2: "shadow"},
                       range(2, 2 * n_img + 1, 2)) as cap:
        irs, contents = render_irs_batched(scene, flat, sources, mics, dirs, device=dev)
    if cap.count != expected:
        raise AssertionError(f"config 5 made {cap.count} sweeps, not {expected}")
    if not bool(torch.isfinite(irs).all()):
        raise AssertionError("config 5 with normalize off is not finite")
    singles = []
    for i in DATAGEN_SINGLE:
        one = parse_config(json.dumps(dict(DATAGEN, normalize=False,
                                           source_position=sources[i].tolist(),
                                           mic_position=mics[i].tolist())))
        want, info = render_fused(scene, one, dirs[i], device=dev)
        got = irs[i].cpu().numpy()
        n = want.shape[-1]
        peak = float(np.abs(want).max())
        rec = {"pair": i, "content": int(contents[i]), "single_content": info["content_length"],
               "peak": peak,
               "max_abs_diff_over_peak": float(np.abs(got[:, :n] - want).max()) / peak,
               "beyond_content_over_peak": float(np.abs(got[:, n:]).max(initial=0.0)) / peak}
        singles.append(rec)
        if (rec["content"] != rec["single_content"] or not peak > 0
                or not (rec["max_abs_diff_over_peak"] <= 1e-5)
                or not (rec["beyond_content_over_peak"] <= 1e-5)):
            raise AssertionError(f"batched pair differs from render_fused: {rec}")
    ph.out["batched_vs_single"] = singles

    # config 5's own sweeps against the plain versions, bit for bit
    from rayverb_tpu_torch.ops.intersect import soup_from_scene

    ph.out["config5_sweeps_vs_plain"] = _datagen_sweeps_vs_plain(
        soup_from_scene(scene, device=dev), cap.kept, DATAGEN_PAIRS)
    del cap

    # the kernels against their plain versions, and the card against the CPU
    box = load_scene(os.path.join(REPO, "assets", "test_models", "large_square.obj"),
                     os.path.join(REPO, "assets", "materials", "mat.json"))
    small = parse_config(json.dumps({
        "rays": 256, "reflections": 6, "sample_rate": 16000, "bit_depth": 16,
        "source_position": [0, 0, 0], "mic_position": [0, 0, 0],
        "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5},
                                           {"direction": [1, 0, 0], "shape": 0.0}]},
        "filter": "linkwitz_riley", "trim_predelay": True, "trim_tail": False,
    }))
    s_src = np.float32([[0.031, 1.989, 2.007], [1.031, 2.989, 0.007], [-1.969, 4.989, 1.007]])
    s_mic = np.float32([[0.013, 2.017, 0.021], [0.013, 4.017, 2.021], [2.013, 6.017, -0.979]])
    s_dirs = np.stack([random_directions(small.rays, seed=i) for i in range(3)])
    by_impl = {}
    for impl in ("cuda", "plain"):
        by_impl[impl] = _datagen_run(impl, box, small, s_src, s_mic, s_dirs, dev, impl=impl)
    cpu, cpu_contents = render_irs_batched(box, small, s_src, s_mic, s_dirs, device="cpu")
    ka, kc, kr = by_impl["cuda"]
    pa, pc, pr = by_impl["plain"]
    card = ka.cpu().numpy()
    cpu = cpu.numpy()
    cpu_errs = [_ir_error(card[i], cpu[i]) for i in range(3)]
    cpu_err = float(np.max(cpu_errs))
    ph.out["kernel_vs_plain"] = {
        "bit_identical": bool(torch.equal(ka, pa) and torch.equal(kc, pc)),
        "pair_tests_executed": kr["pair_tests_executed"],
        "pair_tests_executed_plain": pr["pair_tests_executed"],
        "launches": kr["launches"], "plain_launches": pr["launches"],
        "card_vs_cpu_max_err_over_peak": cpu_err,
        "contents": kc.tolist(), "cpu_contents": cpu_contents.tolist(),
    }
    if (not ph.out["kernel_vs_plain"]["bit_identical"]
            or kr["pair_tests_executed"] != pr["pair_tests_executed"]
            or kr["launches"] != sweep_count(small.reflections) or pr["launches"] != 0):
        raise AssertionError(f"the kernels' batch differs from the plain versions': "
                             f"{ph.out['kernel_vs_plain']}")
    if not (all(e < 1e-3 for e in cpu_errs) and np.all(np.isfinite(card))
            and np.all(np.isfinite(cpu))):
        raise AssertionError(f"the card's batch differs from the CPU's: {ph.out['kernel_vs_plain']}")

    # the scan finalize: one biquad launch per pass for every pair's series
    lr = parse_config(json.dumps(dict(DATAGEN, filter="linkwitz_riley")))
    k = DATAGEN_SCAN_PAIRS
    with mock.patch.dict(os.environ, RAYVERB_FINALIZE_FILTER="scan"), _ScanCapture() as scans:
        scan_irs, scan_contents, scan_run = _datagen_run(
            "scan", scene, lr, sources[:k], mics[:k], dirs[:k], dev)
    fft_irs, fft_contents = render_irs_batched(scene, lr, sources[:k], mics[:k], dirs[:k],
                                               device=dev)
    scan_np, fft_np = scan_irs.cpu().numpy(), fft_irs.cpu().numpy()
    if not (np.all(np.isfinite(scan_np)) and np.all(np.isfinite(fft_np))):
        raise AssertionError("the scan or fft finalize's batch is not finite")
    scan_errs = [_ir_error(scan_np[i], fft_np[i]) for i in range(k)]
    scan_err = float(np.max(scan_errs))
    passes = len(_band_coeffs(lr.filter, lr.sample_rate, lr.hipass))
    ph.out["scan_finalize"] = {"pairs": k, "series_per_launch": k * 2 * 8,
                               "biquad_launches": scan_run["biquad_launches"],
                               "filter_passes": passes,
                               "filter_method": scan_run["filter_method"],
                               "finalize_s": scan_run["timings"]["finalize"],
                               "max_err_over_peak_vs_fft": scan_err}
    if (scan_run["biquad_launches"] != passes or scan_run["filter_method"] != "scan"
            or not all(e < 1e-3 for e in scan_errs)
            or not torch.equal(scan_contents, fft_contents)):
        raise AssertionError(f"the batched scan finalize is wrong: {ph.out['scan_finalize']}")
    # the scan bank's first forward and first reverse pass, each as the
    # kernel ran it in that batch (8 x 2 x 8 series, the pairs' own content
    # lengths), against biquad_onepass_plain on the same inputs, bit for bit
    ph.out["scan_passes_vs_plain"] = _scan_passes_vs_plain(scans.kept, scan_contents)

    # a DXF scene on the card path
    room = load_scene(os.path.join(REPO, "assets", "test_models", "room1.dxf"),
                      os.path.join(REPO, "assets", "materials", "mat.json"))
    r_src, r_mic, r_dirs = _datagen_inputs(room, DATAGEN_DXF_PAIRS, cfg.rays)
    r_irs, r_contents, r_run = _datagen_run("room1_dxf", room, cfg, r_src, r_mic, r_dirs, dev)
    ph.out["room1_dxf"] = {"triangles": room.num_triangles, "shape": r_run["shape"],
                           "wall_s": r_run["wall_s"], "launches": r_run["launches"],
                           "contents": r_contents.tolist(),
                           "peaks": r_irs.abs().amax(dim=(1, 2)).tolist()}
    if not _per_pair_peak_ok(r_irs) or r_run["launches"] != expected:
        raise AssertionError(f"the room1.dxf batch is not finite and non-silent: {ph.out['room1_dxf']}")
    return runs

def _world_of_one(tmp, axis):
    """make_mesh() on this card: a world of one over NCCL, its file:// store
    in the script's temporary directory (make_mesh's own, made there)."""
    from rayverb_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    with mock.patch.object(tempfile, "tempdir", tmp):
        mesh = make_mesh(axis=axis)
    return mesh, time.perf_counter() - t0


def _counted(fn):
    """fn() with the kernels' counts set to 0 just before it and read just
    after, device-synchronised; returns (result, record)."""
    import torch

    from rayverb_tpu_torch.ops import biquad_cuda, intersect_cuda, ray_keys_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect_cuda.launches = 0
    intersect_cuda.order_launches = 0
    biquad_cuda.launches = 0
    ray_keys_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0, "launches": intersect_cuda.launches,
                 "order_launches": intersect_cuda.order_launches,
                 "biquad_launches": biquad_cuda.launches,
                 "ray_keys_launches": ray_keys_cuda.launches,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _phase_sharded(ph, dev, scene, single_ir, tmp):
    """render_fused_sharded at world size one over NCCL (make_mesh() on a
    file:// store in the temporary directory): the north star cold and warm,
    each against render_fused's warm IR of the same inputs from the
    north_star phase (``single_ir``; max|d| <= 1e-6 x peak, bit equality
    printed), every sweep through the order and sweep kernels; the two
    paths' warm walls in turns (render_fused, sharded, sharded,
    render_fused); then the
    vault with RAYVERB_FINALIZE_FILTER=scan, whose finalize launches the
    biquad kernel once per pass, against render_fused's scan render of the
    same rays. Tears the process group down."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rayverb_tpu_torch.config.schema import load_config, parse_config
    from rayverb_tpu_torch.device import card_name_and_power
    from rayverb_tpu_torch.ops.filters import _band_coeffs
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.ops.trace import sweep_count
    from rayverb_tpu_torch.parallel import render_fused_sharded
    from rayverb_tpu_torch.probe import NORTH_STAR
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    mesh, mesh_s = _world_of_one(tmp, "rays")
    try:
        ph.out.update(mesh=str(mesh), make_mesh_s=mesh_s, backend=dist.get_backend(),
                      world_size=dist.get_world_size(),
                      store_in_tmp=any(n.startswith("rayverb_pg_") for n in os.listdir(tmp)))
        cfg = parse_config(json.dumps(NORTH_STAR))
        dirs = random_directions(cfg.rays, seed=0)
        expected = sweep_count(cfg.reflections)
        peak = float(np.abs(single_ir).max())
        runs = []
        for label in ("cold", "warm"):
            (ir, info), run = _counted(lambda: render_fused_sharded(
                scene, cfg, dirs, mesh=mesh, device=dev, stats=True))
            diff = float(np.abs(ir - single_ir).max()) if ir.shape == single_ir.shape \
                else float("inf")
            run.update(run=label, shape=list(ir.shape),
                       bit_identical_to_render_fused=bool(np.array_equal(ir, single_ir)),
                       max_abs_diff_over_peak=diff / peak, info=info)
            runs.append(run)
            _emit({"sharded_run": run})
            if not diff <= 1e-6 * peak:
                raise AssertionError(f"the sharded north star differs from render_fused: {run}")
            if (run["launches"] != expected * sum(info["segments"])
                    or run["order_launches"] != run["launches"]
                    or info["sweeps"] != run["launches"] or run["biquad_launches"] != 0):
                raise AssertionError(f"the sharded north star did not run every sweep "
                                     f"through the order and sweep kernels: {run}")
        # warm walls in turns, one pass each: render_fused, sharded, sharded,
        # render_fused
        turns = []
        for path in ("render_fused", "sharded", "sharded", "render_fused"):
            _, rec = _counted(
                (lambda: render_fused(scene, cfg, dirs, device=dev)) if path == "render_fused"
                else (lambda: render_fused_sharded(scene, cfg, dirs, mesh=mesh, device=dev)))
            turns.append({"path": path, "wall_s": rec["wall_s"]})
        ph.out["turns"] = turns
        # the vault through the scan finalize: the biquad kernel on this path
        vault = load_scene(VAULT[1], VAULT[2])
        vcfg = load_config(VAULT[0])
        vdirs = random_directions(vcfg.rays, seed=vcfg.seed)
        passes = len(_band_coeffs(vcfg.filter, vcfg.sample_rate, vcfg.hipass))
        with mock.patch.dict(os.environ, RAYVERB_FINALIZE_FILTER="scan"):
            (vir, vinfo), vrun = _counted(lambda: render_fused_sharded(
                vault, vcfg, vdirs, mesh=mesh, device=dev, stats=True))
            want, _ = render_fused(vault, vcfg, vdirs, device=dev)
        vpeak = float(np.abs(want).max())
        vdiff = float(np.abs(vir - want).max()) if vir.shape == want.shape else float("inf")
        vrun.update(run="vault_scan", shape=list(vir.shape), filter_passes=passes,
                    bit_identical_to_render_fused=bool(np.array_equal(vir, want)),
                    max_abs_diff_over_peak=vdiff / vpeak, info=vinfo)
        runs.append(vrun)
        if (vinfo["filter_method"] != "scan" or vrun["biquad_launches"] != passes
                or vrun["launches"] != sweep_count(vcfg.reflections) * sum(vinfo["segments"])
                or not vdiff <= 1e-6 * vpeak):
            raise AssertionError(f"the sharded vault's scan finalize is wrong: {vrun}")
        ph.out.update(card=card_name_and_power(), rays=cfg.rays, reflections=cfg.reflections,
                      expected_sweeps=expected, runs=runs)
        return runs
    finally:
        dist.destroy_process_group()
        torch.cuda.synchronize()


def _phase_datagen_mesh(ph, dev, tmp):
    """Config 5 through render_irs_batched(mesh=make_mesh(axis="batch")) at
    world size one over NCCL, against the no-mesh batch of the same inputs:
    bit for bit (the same computation at one rank); its wall and pairs/s,
    every sweep through the kernels. Tears the process group down."""
    import torch
    import torch.distributed as dist

    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops.trace import sweep_count
    from rayverb_tpu_torch.parallel import render_irs_batched
    from rayverb_tpu_torch.scene import load_scene

    mesh, mesh_s = _world_of_one(tmp, "batch")
    try:
        scene = load_scene(VAULT[1], VAULT[2])
        cfg = parse_config(json.dumps(DATAGEN))
        sources, mics, dirs = _datagen_inputs(scene, DATAGEN_PAIRS, cfg.rays)
        want, want_contents = render_irs_batched(scene, cfg, sources, mics, dirs, device=dev)
        runs = []
        for label in ("cold", "warm"):
            (irs, contents, info), run = _counted(lambda: render_irs_batched(
                scene, cfg, sources, mics, dirs, device=dev, mesh=mesh, stats=True))
            run.update(run=label, pairs_per_s=DATAGEN_PAIRS / run["wall_s"],
                       shape=list(irs.shape),
                       bit_identical_to_no_mesh=bool(torch.equal(irs, want)
                                                     and torch.equal(contents, want_contents)),
                       info=info)
            runs.append(run)
            if (not run["bit_identical_to_no_mesh"]
                    or run["launches"] != sweep_count(cfg.reflections) * info["passes"]
                    or run["order_launches"] != run["launches"]):
                raise AssertionError(f"the mesh datagen differs from the no-mesh batch: {run}")
        ph.out.update(mesh=str(mesh), make_mesh_s=mesh_s, pairs=DATAGEN_PAIRS, runs=runs)
        return runs[-1]
    finally:
        dist.destroy_process_group()
        torch.cuda.synchronize()


def _phase_corpus(ph, tmp):
    """The demo corpus's covering subset (gen.covering(): in COMBOS order,
    each combination that brings a config, model or material not yet
    covered; every one of the 14, 16 and 5 at least once) at full size
    through gen.render on cuda, the kernels' counts set to 0 just before
    and read just after; each render held against its file in impulses/
    (the JAX package's corpus) by corpus_check. Every render's wall,
    channels, samples and readings, and each bound's worst reading."""
    from rayverb_tpu_torch import gen
    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops.trace import sweep_count

    todo = gen.covering()
    expected = sum(sweep_count(load_config(gen.combo_paths(c)[0]).reflections)
                   for _, c in todo)
    report, run = _counted(lambda: gen.render(
        todo, os.path.join(tmp, "corpus"), device="cuda",
        check_against=os.path.join(REPO, "impulses"), log=lambda _: None))
    ph.out.update(counted=run, renders=[
        {k: r.get(k) for k in ("combo", "index", "seed", "run", "wall_s", "rc",
                               "channels", "samples")}
        | {"check": {n: c and c["value"] for n, c in r["check"]["checks"].items()}
           if "check" in r else None}
        for r in report["renders"]],
        expected_sweeps=expected, worst=report.get("check_worst"),
        walls_by_model=report["walls_by_model"],
        failed=report["failed_combos"], check_failed=report.get("check_failed_combos"))
    if report["failures"] or report.get("check_failed_combos") or len(todo) != report["total"]:
        raise AssertionError(f"corpus renders failed or missed a bound: {ph.out['failed']} "
                             f"{ph.out['check_failed']}")
    if run["launches"] < expected or run["order_launches"] != run["launches"]:
        raise AssertionError(f"the corpus's sweeps did not all go through the kernels: {run}")
    return run


def _phase_kernel_parity(ph, dev, hall_scene):
    """kernel_parity: the sweep kernel against the float64 oracle on the
    card, 2,048 rows of mixed kinds on the vault (seed 3) and on the hall
    (seed 4), with scripts/kernel_parity.py's gates."""
    from rayverb_tpu_torch import kernel_parity

    recs = [kernel_parity.check_scene("vault", kernel_parity.vault_scene(), 2048, 3, dev),
            kernel_parity.check_scene("hall100k", hall_scene, 2048, 4, dev)]
    ph.out["scenes"] = recs
    if not all(r["ok"] and r["kernel_launches"] > 0 for r in recs):
        raise AssertionError(f"the sweep kernel failed a float64 gate: {recs}")


# bytes a row of the sort-key kernels read and write: the bounce key reads
# pos and dir (24 B) and writes an int32; the shadow key reads d (12 B) and
# alive (1 B) and writes an int32
BOUNCE_KEY_BYTES = 28
SHADOW_KEY_BYTES = 17


def _key_mismatch(got, want):
    """Rows where two keys differ (all of them where dtype or shape does)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return int(got.numel())
    return int((got != want).sum())


def _phase_ray_keys(ph, dev):
    """The sort-key kernels (csrc/ray_keys.cu) against their plain versions
    (trace._signed32 of _ray_sort_key; _shadow_key's plain path), bit for
    bit: on the inputs of every bounce of phase A, run eagerly, of a vault
    render (50,000 rows) and of a config-5 batch (the 64-pair key, 64 x 4,096 rows), recorded as
    the trace keys them, and on 1,048,576 rows over twice the vault's grid
    (the north star's batch). Each kernel's device ms per launch
    (torch.profiler) beside its plain version's call ms and its byte bound.
    Returns the record."""
    import torch

    from rayverb_tpu_torch.config.schema import load_config, parse_config
    from rayverb_tpu_torch.ops import ray_keys_cuda, trace
    from rayverb_tpu_torch.ops.render import render_fused
    from rayverb_tpu_torch.parallel.datagen import render_irs_batched
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils.directions import random_directions

    seen = {"bounce": [], "shadow": []}
    real = {"bounce": trace._bounce_key, "shadow": trace._shadow_key}

    def recorder(kind):
        def key(*args):
            # a captured bounce's tensors hold its values only at a replay
            if not torch.cuda.is_current_stream_capturing():
                seen[kind].append([None if x is None else x.clone() for x in args[:-1]])
            return real[kind](*args)
        return key

    scene = load_scene(VAULT[1], VAULT[2])
    cfg = load_config(VAULT[0])
    dcfg = parse_config(json.dumps(DATAGEN))
    sources, mics, ddirs = _datagen_inputs(scene, DATAGEN_PAIRS, dcfg.rays)
    # phase A eager, as it runs above IMAGE_GRAPH_ROWS rows
    with mock.patch.object(trace, "_bounce_key", recorder("bounce")), \
            mock.patch.object(trace, "_shadow_key", recorder("shadow")), \
            mock.patch.object(trace, "_image_graph_engages", lambda *a: False):
        render_fused(scene, cfg, random_directions(cfg.rays, seed=cfg.seed), device=dev)
        render_irs_batched(scene, dcfg, sources, mics, ddirs, device=dev)

    def plain_bounce(*args):
        return trace._signed32(trace._ray_sort_key(*args))

    def plain_shadow(*args):
        return real["shadow"](*args, "plain")

    cases = {"vault_bounce": [], "vault_shadow": [], "datagen_bounce": [],
             "datagen_shadow": []}
    for args in seen["bounce"]:
        kind = "vault_bounce" if args[0].shape[0] == cfg.rays else "datagen_bounce"
        cases[kind].append((ray_keys_cuda.bounce_key_cuda, plain_bounce, args))
    for args in seen["shadow"]:
        kind = "vault_shadow" if args[2] is None else "datagen_shadow"
        cases[kind].append((ray_keys_cuda.shadow_key_cuda, plain_shadow, args))
    if not all(cases.values()):
        raise AssertionError(f"a case recorded no sort-key call: "
                             f"{ {k: len(v) for k, v in cases.items()} }")
    # the north star's batch: positions over twice the vault's grid (some
    # on its corners), directions uniform (the axes among them), 1/8 dead
    n = 1 << 20
    gen = torch.Generator(device=dev).manual_seed(26)
    lo, inv_span = cases["vault_bounce"][0][2][2:]
    span = 1.0 / inv_span
    pos = (torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 0.5) * span + lo
    pos[0], pos[1] = lo, lo + span
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=-1)
    d[:6] = torch.cat([torch.eye(3, device=dev), -torch.eye(3, device=dev)])
    alive = torch.rand(n, generator=gen, device=dev) < 0.875
    cases["1M_bounce"] = [(ray_keys_cuda.bounce_key_cuda, plain_bounce, (pos, d, lo, inv_span))]
    cases["1M_shadow"] = [(ray_keys_cuda.shadow_key_cuda, plain_shadow, (d, alive, None))]

    rec = {"calls": {k: len(v) for k, v in cases.items()},
           "rows": {k: v[0][2][0].shape[0] if v else 0 for k, v in cases.items()},
           "mismatched_rows": {}}
    for k, calls in cases.items():
        rec["mismatched_rows"][k] = sum(_key_mismatch(fn(*args), want(*args))
                                        for fn, want, args in calls)
    ph.out.update(rec)
    if any(rec["mismatched_rows"].values()):
        raise AssertionError(f"the sort-key kernels differ from their plain versions: "
                             f"{rec['mismatched_rows']}")

    def timed(bounce, shadow):
        n = bounce[0].shape[0]
        ms = _profiled_many([(lambda: ray_keys_cuda.bounce_key_cuda(*bounce), "ray_bounce_key"),
                             (lambda: ray_keys_cuda.shadow_key_cuda(*shadow), "ray_shadow_key")],
                            20)
        return {"rows": n,
                "bounce_ms": ms["ray_bounce_key"],
                "bounce_plain_ms": _cuda_ms(lambda: plain_bounce(*bounce), 5),
                "bounce_bound_ms": BOUNCE_KEY_BYTES * n / HBM_BYTES_PER_S * 1e3,
                "shadow_ms": ms["ray_shadow_key"],
                "shadow_plain_ms": _cuda_ms(lambda: plain_shadow(*shadow), 5),
                "shadow_bound_ms": SHADOW_KEY_BYTES * n / HBM_BYTES_PER_S * 1e3}

    rec["vault"] = timed(cases["vault_bounce"][0][2], cases["vault_shadow"][0][2])
    rec["1M"] = timed(cases["1M_bounce"][0][2], cases["1M_shadow"][0][2])
    ph.out.update(vault=rec["vault"], north_star_rows=rec["1M"])
    return rec


# rows of phase A's graph against its eager loop (trace.IMAGE_GRAPH_ROWS)
IMAGE_GRAPH_SIZES = (50_000, 100_000, 196_608, 262_144, 393_216, 524_288, 786_432,
                     1_000_000)
IMAGE_GRAPH_REPS = 3
# whole config-5 batches (render_irs_batched) a way, in turns
IMAGE_GRAPH_BATCH_REPS = 6


def _phase_image_graph_rows(ph, dev, hall_scene):
    """Phase A of a trace (the direct path and the 9 image bounces, each
    bounce's diffuse row copied into bounce-major buffers, as the sorted
    binning does) on the vault at each of IMAGE_GRAPH_SIZES Morton-ordered
    rows and on the hall at 1,000,000: by replay of its CUDA graph, the
    capture included, and eagerly (the gate that compacts the rays, which
    the host waits for), in turns, each wall synced, IMAGE_GRAPH_REPS a
    way. The capture's ms from a stats call; peak memory each way. Where
    the replay stops being cheaper sets trace.IMAGE_GRAPH_ROWS. Then the
    datagen cell's own batch, whole, both ways (_image_graph_batch). The
    two ways' image slots and rows, and the batch's IRs, must be equal bit
    for bit. Returns the rows."""
    import statistics

    import torch

    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.constants import NUM_IMAGE_SOURCE
    from rayverb_tpu_torch.ops import trace
    from rayverb_tpu_torch.ops.intersect import cached_soup
    from rayverb_tpu_torch.ops.render import ray_schedule
    from rayverb_tpu_torch.probe import NORTH_STAR
    from rayverb_tpu_torch.scene import load_scene
    from rayverb_tpu_torch.utils import profiling
    from rayverb_tpu_torch.utils.directions import random_directions

    cfg = load_config(VAULT[0])
    vault = load_scene(VAULT[1], VAULT[2])
    cases = [("vault", vault, cfg.mic_position, cfg.source_position, n)
             for n in IMAGE_GRAPH_SIZES]
    cases.append(("hall", hall_scene, NORTH_STAR["mic_position"],
                  NORTH_STAR["source_position"], 1_000_000))
    nimg = NUM_IMAGE_SOURCE - 1
    rows = []
    for name, scene, mic, src, n in cases:
        soup, _ = cached_soup(scene, dev)
        dirs = torch.from_numpy(random_directions(n, seed=28)).to(dev)
        order, resort = ray_schedule(dirs, soup.block_aabb.shape[0])
        if order is not None:
            dirs = dirs[order]
        bufs = (torch.empty((nimg, n, 8), device=dev), torch.empty((nimg, n, 3), device=dev),
                torch.empty((nimg, n), device=dev))

        def phase_a(graph, stats=False):
            bounce = iter(range(nimg))

            def consume(row):
                b = next(bounce)
                for buf, x in zip(bufs, row):
                    buf[b] = x

            # the graph wherever asked, whatever the bound
            with mock.patch.object(trace, "IMAGE_GRAPH_ROWS", n):
                return trace._trace_impl(
                    soup, mic, src, dirs, nreflections=nimg, consume_row=consume,
                    resort=resort, bounce_graph=graph,
                    stats=profiling.pair_sums() if stats else None)

        def wall(graph):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phase_a(graph)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        rec = {"scene": name, "rows": n, "resort": resort}
        got = {}
        for graph in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            images = phase_a(graph)
            torch.cuda.synchronize()
            rec[f"{'graph' if graph else 'eager'}_peak_gib"] = (
                torch.cuda.max_memory_allocated(dev) / 2**30)
            got[graph] = [x.clone() for x in (*images, *bufs)]
        rec["equal"] = all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
        del got
        timings = {}
        with profiling.call("rv.image_graph_rows", dev, stats=True, timings=timings):
            phase_a(True, stats=True)
            profiling.stage()
        rec["capture_ms"] = 1e3 * timings["spans"]["rv.graph_capture"]["s"]
        walls = {False: [], True: []}
        for graph in (False, True, True, False) * ((IMAGE_GRAPH_REPS + 1) // 2):
            if len(walls[graph]) < IMAGE_GRAPH_REPS:
                walls[graph].append(wall(graph))
        rec["eager_ms"] = statistics.median(walls[False])
        rec["graph_ms"] = statistics.median(walls[True])
        rec["eager_walls_ms"], rec["graph_walls_ms"] = walls[False], walls[True]
        rec["graph_cheaper"] = rec["graph_ms"] < rec["eager_ms"]
        rows.append(rec)
        _emit({"image_graph_rows": rec})
        del bufs, dirs
    rows.append(_image_graph_batch(dev))
    _emit({"image_graph_rows": rows[-1]})
    ph.out["cases"] = rows
    cheaper = [r["rows"] for r in rows if r["scene"] == "vault" and r["graph_cheaper"]]
    ph.out["largest_cheaper_vault_rows"] = max(cheaper, default=0)
    ph.out["IMAGE_GRAPH_ROWS"] = trace.IMAGE_GRAPH_ROWS
    if not all(r["equal"] for r in rows):
        raise AssertionError("phase A's graph and its eager loop differ: "
                             f"{[(r['scene'], r['rows']) for r in rows if not r['equal']]}")
    return rows


def _image_graph_batch(dev):
    """The datagen cell's own batch (config 5: 64 pairs x 4,096 rays, one
    262,144-row trace) through render_irs_batched, phase A by its graph
    and eagerly (trace.IMAGE_GRAPH_ROWS set either side of the rows), in
    turns, each batch's wall synced, IMAGE_GRAPH_BATCH_REPS a way; the
    IRs must be equal bit for bit."""
    import statistics

    import torch

    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops import trace
    from rayverb_tpu_torch.parallel.datagen import render_irs_batched
    from rayverb_tpu_torch.scene import load_scene

    scene = load_scene(VAULT[1], VAULT[2])
    cfg = parse_config(json.dumps(DATAGEN))
    sources, mics, dirs = _datagen_inputs(scene, DATAGEN_PAIRS, cfg.rays)
    n = DATAGEN_PAIRS * cfg.rays

    def batch(graph):
        with mock.patch.object(trace, "IMAGE_GRAPH_ROWS", n if graph else n - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            irs, _ = render_irs_batched(scene, cfg, sources, mics, dirs, device=dev)
            torch.cuda.synchronize()
            return irs, 1e3 * (time.perf_counter() - t0)

    got = {graph: batch(graph)[0] for graph in (False, True)}
    rec = {"scene": "datagen_batch", "rows": n,
           "equal": bool(torch.equal(got[False], got[True]))}
    del got
    walls = {False: [], True: []}
    for graph in (False, True, True, False) * (IMAGE_GRAPH_BATCH_REPS // 2):
        walls[graph].append(batch(graph)[1])
    rec["eager_ms"] = statistics.median(walls[False])
    rec["graph_ms"] = statistics.median(walls[True])
    rec["eager_walls_ms"], rec["graph_walls_ms"] = walls[False], walls[True]
    rec["graph_cheaper"] = rec["graph_ms"] < rec["eager_ms"]
    return rec


def main() -> int:
    threading.Thread(target=_watchdog, daemon=True).start()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    try:
        import rayverb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the rayverb_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="rayverb_chip_smoke_")
    try:
        with Phase("device") as ph:
            from rayverb_tpu_torch.device import card_name_and_power

            smi = card_name_and_power()
            ph.out["nvidia_smi"] = smi
            ph.out["torch_device"] = torch.cuda.get_device_name(0)
            ph.out["torch"] = torch.__version__
            ph.out["cuda"] = torch.version.cuda
            from concurrent.futures import ThreadPoolExecutor

            from rayverb_tpu_torch import cuda_build
            from rayverb_tpu_torch.ops import biquad_cuda, intersect_cuda, ray_keys_cuda

            # one nvcc per source, all started together
            t0 = time.perf_counter()
            builds = (intersect_cuda.build, biquad_cuda.build, ray_keys_cuda.build)
            with ThreadPoolExecutor(len(builds)) as pool:
                for f in [pool.submit(b) for b in builds]:
                    f.result()
            ph.out["build_s"] = time.perf_counter() - t0
            ph.out["build_s_each"] = {k: v["seconds"] for k, v in cuda_build.build_info.items()}
            ph.out["ptxas"] = {
                k: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in cuda_build.build_info.items()
            }
            ph.out["sass"] = _sass_loops(cuda_build.build_info["closest_hit"]["path"])
        with Phase("kernel_vs_plain") as ph:
            batches = _phase_kernel(ph, dev)
        with Phase("main_path") as ph:
            runs = _phase_main(ph, tmp)
        with Phase("render_kernel_vs_plain") as ph:
            _phase_render(ph, dev)
        with Phase("small_render_card_vs_cpu") as ph:
            _phase_small_vs_cpu(ph, dev)
        with Phase("hrtf_main_path") as ph:
            hrtf_runs = _phase_main(ph, tmp, HRTF_VAULT)
        with Phase("hrtf_render_kernel_vs_plain") as ph:
            _phase_hrtf_render(ph, dev)
        with Phase("hrtf_small_card_vs_cpu") as ph:
            _phase_hrtf_small_vs_cpu(ph, dev)
        with Phase("hall_kernel_vs_plain") as ph:
            hall_scene = _hall(ph, tmp)
            hall_loads = dict(ph.out)
            hall = _phase_hall(ph, dev, hall_scene)
        with Phase("north_star") as ph:
            north, north_ir = _phase_north_star(ph, dev, hall_scene, hall_loads)
            north_order = ph.out
        with Phase("order_vs_plain") as ph:
            order_rec = _phase_order(ph, dev, hall_scene)
        with Phase("biquad_vs_plain") as ph:
            biquad = _phase_biquad(ph, dev)
        with Phase("modular_main_path") as ph:
            modular_runs = _phase_modular_main(ph, dev, tmp)
            biquad_main = ph.out["biquad_at_main_shape"]
        with Phase("modular_vs_fused") as ph:
            _phase_modular_vs_fused(ph, dev)
        with Phase("raw_and_dump") as ph:
            _phase_raw_and_dump(ph, dev, tmp)
        with Phase("datagen") as ph:
            datagen_runs = _phase_datagen(ph, dev)
            datagen_scan = ph.out["scan_finalize"]
            datagen_scan_passes = ph.out["scan_passes_vs_plain"]
        with Phase("sharded") as ph:
            sharded_runs = _phase_sharded(ph, dev, hall_scene, north_ir, tmp)
        with Phase("datagen_mesh") as ph:
            datagen_mesh_run = _phase_datagen_mesh(ph, dev, tmp)
        with Phase("corpus") as ph:
            corpus_run = _phase_corpus(ph, tmp)
        with Phase("kernel_parity") as ph:
            _phase_kernel_parity(ph, dev, hall_scene)
        with Phase("ray_keys_vs_plain") as ph:
            keys = _phase_ray_keys(ph, dev)
        with Phase("image_graph_rows") as ph:
            _phase_image_graph_rows(ph, dev, hall_scene)
        del north_ir
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    primary = batches[0]
    epilogue = primary["epilogue"]
    # launches of each path, counted from 0 just before its warm run (the
    # north star's: its warm render); "launches" is the binaural vault's
    paths = {"main_path": runs[-1], "hrtf_main_path": hrtf_runs[-1], "north_star": north[-1],
             "modular_main_path": modular_runs[-1], "datagen": datagen_runs[-1],
             "sharded": sharded_runs[1], "sharded_vault_scan": sharded_runs[2],
             "datagen_mesh": datagen_mesh_run, "corpus": corpus_run}
    _emit({"kernels": [{
        "name": "closest_hit",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/closest_hit.cu",
        "replaces": "rayverb_tpu/ops/intersect_pallas.py:139",
        "launches": hrtf_runs[-1]["launches"],
        "launches_by_path": {k: r["launches"] for k, r in paths.items()},
        "max_abs_err": max(b["max_abs_err"] for b in batches + [hall]),
        "max_abs_diff_vs_plain": max(b["max_abs_err"] for b in batches + [hall]),
        "ms": primary["ms"],
        "plain_ms": primary["plain_ms"],
        "bound_ms": primary["bound_ms"],
        "bound_own_ms": primary["bound_own_ms"],
        "bound_by": primary["bound_by"],
        "library_ms": None,
        "executed_pairs": primary["executed_pairs"],
        "schedule": primary["schedule"],
        "hall_ms": hall["ms"],
        "hall_plain_ms": hall["plain_ms"],
        "hall_bound_ms": hall["bound_ms"],
    }, {
        "name": "closest_hit_order",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/closest_hit.cu",
        "replaces": "rayverb_tpu/ops/intersect_pallas.py:604",
        "launches": hrtf_runs[-1]["order_launches"],
        "launches_by_path": {k: r["order_launches"] for k, r in paths.items()},
        "max_abs_err": float(max(b["order_mismatch"] for b in batches + [hall])),
        # device time per launch, the order and its cull (torch.profiler);
        # call_ms is the wrapper's call under CUDA events, which the host
        # sets at the vault's size; plain_ms is cull_order of block_order
        # and block_keep; bound_ms counts the rank, superblock and block box
        # tests beside the bytes (_order_bound)
        "ms": primary["order_device_ms"],
        "call_ms": primary["order_ms"],
        "plain_ms": primary["order_plain_ms"],
        "bound_ms": primary["order_bound_ms"],
        "bound_by": primary["order_bound_by"],
        "box_tests": primary["order_box_tests"],
        # no single PyTorch call computes the order; sort_call_ms is
        # torch.argsort of the same keys at 1M x 1,024, the sort half alone
        "library_ms": None,
        "sort_call_ms": north_order["order_sort_call_ms_1M_rays"],
        "hall_ms": hall["order_device_ms"],
        "hall_plain_ms": hall["order_plain_ms"],
        "north_star_ms": north_order["order_device_ms_1M_rays"],
        "north_star_bound_ms": north_order["order_bound_ms_1M_rays"],
        "k": {"primary": primary["order_k"], "hall": hall["order_k"], **order_rec["north_star_k"]},
        "edge_case_mismatches": order_rec["mismatches"],
    }, {
        # the merge of the kernel's outputs and the Hit mapping, done by the
        # sweep's epilogue: no launch of its own; "ms" is the sweep's device
        # time, which carries it, beside the card's launch floor
        "name": "closest_hit_epilogue",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/closest_hit.cu",
        "replaces": "rayverb_tpu/ops/intersect_pallas.py:472",
        "folded_into": "closest_hit_sweep",
        "launches": 0,
        "launches_by_path": {k: 0 for k in paths},
        "max_abs_err": float(epilogue["mismatch"]),
        "ms": epilogue["sweep_ms"],
        "plain_ms": epilogue["plain_ms"],
        "bound_ms": epilogue["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": epilogue["launch_floor_ms"],
        "device_ops_per_call": epilogue["device_ops_per_call"],
    }, {
        "name": "biquad_scan",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/biquad_scan.cu",
        # no Pallas counterpart: the JAX package's lax.scan
        "replaces": "rayverb_tpu/ops/filters.py:157",
        "launches": modular_runs[-1]["biquad_launches"],
        "launches_by_path": {k: r["biquad_launches"] for k, r in paths.items()},
        "max_abs_err": max([biquad_main["max_abs_err"]]
                           + [c["max_abs_err"] for c in biquad["cases"]]),
        # one pass at the modular vault's first filter shape: device time
        # per launch (torch.profiler); call_ms under CUDA events, wrapper
        # included; the plain version once at the same shape
        "ms": biquad_main["ms"],
        "call_ms": biquad_main["call_ms"],
        "plain_ms": biquad_main["plain_ms"],
        "shape": biquad_main["shape"],
        "bound_ms": biquad_main["bound_ms"],
        "bound_by": biquad_main["bound_by"],
        "chain_bound_ms": biquad_main["chain_bound_ms"],
        # no PyTorch call computes an IIR scan
        "library_ms": None,
        # the batched scan finalize: one launch per pass for all pairs
        "launches_datagen_scan": datagen_scan["biquad_launches"],
        "series_per_launch_datagen_scan": datagen_scan["series_per_launch"],
        "ms_datagen_scan_pass": {k: v["ms"] for k, v in datagen_scan_passes.items()},
        "ms_per_pass_524288": biquad["ms_per_pass"],
        "bounds_524288": biquad["bounds"],
        "full_length_max_err_over_peak": biquad["full_length"]["max_err_over_peak"],
    }, {
        "name": "ray_keys",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/ray_keys.cu",
        # no Pallas counterpart: the JAX trace's sort keys, fused by XLA
        "replaces": "rayverb_tpu/ops/trace.py:110",
        "launches": hrtf_runs[-1]["ray_keys_launches"],
        "launches_by_path": {k: r["ray_keys_launches"] for k, r in paths.items()},
        # keys that differ from the plain version's, in every case (0)
        "max_abs_err": float(sum(keys["mismatched_rows"].values())),
        # the bounce key at the vault's 50,000 rows: device time per launch
        # (torch.profiler); plain_ms the plain key's call under CUDA events;
        # bound_ms its bytes at the HBM's bandwidth; the shadow key beside it
        "ms": keys["vault"]["bounce_ms"],
        "plain_ms": keys["vault"]["bounce_plain_ms"],
        "bound_ms": keys["vault"]["bounce_bound_ms"],
        "bound_by": "bytes",
        # no PyTorch call computes a Morton key
        "library_ms": None,
        "shadow_ms": keys["vault"]["shadow_ms"],
        "shadow_plain_ms": keys["vault"]["shadow_plain_ms"],
        "shadow_bound_ms": keys["vault"]["shadow_bound_ms"],
        "rows_1M": keys["1M"],
        "cases": {k: {"calls": keys["calls"][k], "rows": keys["rows"][k]}
                  for k in keys["calls"]},
    }]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
