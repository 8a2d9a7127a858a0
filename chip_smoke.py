#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rayverb_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time:

  1. device   nvidia-smi's name and power limit, the CUDA device name, and
              the nvcc build of the closest-hit kernels (with its seconds)
  2. kernel   the CUDA kernel against its plain PyTorch version on the
              vault scene, on the card: 50,000 Morton-sorted primary rays,
              the first bounce's reversed shadow rows, a ragged batch of 777
              rays with bounds and any-hit thresholds, and a 5-triangle
              scene, each at one slice in table order, at the schedule the
              port chooses (sweep_schedule) and at the slice counts of
              SLICE_SCAN. best_t, best_i and the executed-pair counters
              must be equal bit for bit; the order table of the order
              kernel must equal its plain version's, on the card and on the
              CPU, also on tables of 16,384 and 32,768 random blocks;
              closest-hit rows and decided rows' verdicts must not depend
              on the schedule.
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
  6. kernels  one JSON line per the port's kernel table; the device line
              also carries the instruction counts of the sweep kernel's
              loops, read from `cuobjdump -sass` where the toolkit has it

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

DEADLINE_S = 300
REPO = os.path.dirname(os.path.abspath(__file__))
VAULT = (
    os.path.join(REPO, "assets", "configs", "vault.json"),
    os.path.join(REPO, "assets", "test_models", "vault.obj"),
    os.path.join(REPO, "assets", "materials", "vault.json"),
)
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, HBM3 bandwidth
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
# FP32 operations per pair test, as the JAX kernel's cost estimate counts
# them (rayverb_tpu/ops/intersect_pallas.py:414)
FLOPS_PER_PAIR = 40


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


def _nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


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


def _run_schedule(soup, args, order, slices):
    """Kernel vs plain on one batch and schedule; raises unless results
    and executed-pair counters are equal bit for bit. Returns the record."""
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import closest_hit_plain

    pt, pi, p_ex = closest_hit_plain(*args, order, slices, with_stats=True)
    kt, ki, k_ex = intersect_cuda.closest_hit_cuda(*args, order, slices, with_stats=True)
    torch.cuda.synchronize()
    rec = {
        "slices": slices,
        "hits": int((ki >= 0).sum()),
        "mismatch_t": int((pt.view(torch.int32) != kt.view(torch.int32)).sum()),
        "mismatch_i": int((pi != ki).sum()),
        "mismatch_executed": int((p_ex != k_ex).sum()),
        "executed_pairs": int(k_ex.sum()),
    }
    both = torch.isfinite(pt) & torch.isfinite(kt)
    rec["max_abs_err"] = float((pt - kt).abs()[both].max()) if bool(both.any()) else 0.0
    rec["ms"] = _cuda_ms(lambda: intersect_cuda.closest_hit_cuda(*args, order, slices), 20)
    rec["bound_own_ms"] = _pair_bound_ms(rec["executed_pairs"])
    if rec["mismatch_t"] or rec["mismatch_i"] or rec["mismatch_executed"]:
        raise AssertionError(f"kernel != plain at {slices} slices: {rec}")
    return rec, (kt, ki)


def _compare_batch(name, soup, o, d, tmax, decide):
    """Kernel vs plain on one batch, bit for bit, at one slice in table
    order, at the chosen schedule (sweep_schedule) and over
    SLICE_SCAN with the near-to-far order. Returns the batch's record: rows,
    mismatches, executed pairs, times, bounds."""
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import (
        SWEEP_RAYS, block_order, closest_hit_plain, sweep_schedule, table_order,
    )

    args = (o, d, soup.packed, soup.block_aabb, tmax, decide)
    m = o.shape[0]
    nb = soup.block_aabb.shape[0]
    tp = soup.packed.shape[0]
    order, slices = sweep_schedule(o, d, tmax, soup.block_aabb,
                                   bool((decide > 0).any()))
    # the order kernel against its plain version, on the card and on the CPU
    order_args = (o, d, tmax, soup.block_aabb)
    plain_order = block_order(*order_args)
    cpu_order = block_order(*(x.cpu() for x in order_args))
    order_mismatch = int((order != plain_order).sum()) + int((order.cpu() != cpu_order).sum())
    if order_mismatch:
        raise AssertionError(f"batch {name}: the order table differs between its kernel, "
                             f"its plain version and the CPU ({order_mismatch} entries)")
    order_ms = _cuda_ms(lambda: intersect_cuda.block_order_cuda(*order_args), 20)
    order_plain_ms = _cuda_ms(lambda: block_order(*order_args), 5)
    table, table_out = _run_schedule(soup, args, table_order(m, nb, o.device), 1)
    chosen, chosen_out = _run_schedule(soup, args, order, slices)
    closest = decide == 0
    for a, b in zip(table_out, chosen_out):
        if not torch.equal(a[closest].view(torch.int32), b[closest].view(torch.int32)):
            raise AssertionError(f"batch {name}: closest-hit rows depend on the schedule")
    # decided rows may return another witness, never another verdict
    verdict = lambda out: (out[1] < 0) | (out[0] > decide)  # noqa: E731
    if not torch.equal(verdict(table_out)[~closest], verdict(chosen_out)[~closest]):
        raise AssertionError(f"batch {name}: decided rows' verdicts depend on the schedule")
    scan = [_run_schedule(soup, args, order, s)[0]
            for s in SLICE_SCAN if s <= nb // 2]
    plain_ms = _cuda_ms(lambda: closest_hit_plain(*args, order, slices), 2)
    # least time for this work on the card: the larger of the executed pair
    # tests' FP32 operations over the FP32 peak and the bytes the function
    # must move (inputs read once, outputs written once) over HBM bandwidth
    in_bytes = 4 * (8 * m + tp * 16 + soup.block_aabb.numel() + order.numel())
    out_bytes = 8 * m
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    # bound_ms counts the executed pairs of one slice in table order, which
    # do not depend on the schedule chosen; bound_own_ms counts the chosen
    # schedule's own pairs
    ops_ms = _pair_bound_ms(table["executed_pairs"])
    own_ms = _pair_bound_ms(chosen["executed_pairs"])
    # the same bound over ISSUED pairs (every ray against every row) and
    # the table re-read once per thread block
    issued_ops_ms = _pair_bound_ms(m * tp)
    reread_ms = (-(-m // SWEEP_RAYS)) * tp * 64 / HBM_BYTES_PER_S * 1e3
    # the order kernel's least time: t_max read, one representative ray per
    # group, the AABBs once, the table written; ~40 FP32 operations per
    # (group, block) slab test
    order_bytes_ms = (4 * (m + order.shape[0] * 6 + 8 * nb + order.numel())
                      / HBM_BYTES_PER_S * 1e3)
    order_ops_ms = order.numel() * 40 / FP32_PEAK * 1e3
    rec = {
        "batch": name,
        "rows": m,
        "hits": chosen["hits"],
        "mismatch_t": table["mismatch_t"] + chosen["mismatch_t"],
        "mismatch_i": table["mismatch_i"] + chosen["mismatch_i"],
        "mismatch_executed": table["mismatch_executed"] + chosen["mismatch_executed"],
        "max_abs_err": max(table["max_abs_err"], chosen["max_abs_err"]),
        "schedule": {"order": "near_to_far", "slices": slices,
                     "ctas": -(-m // SWEEP_RAYS) * slices},
        "ms": chosen["ms"],
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
        "order_plain_ms": order_plain_ms,
        "order_bound_ms": max(order_bytes_ms, order_ops_ms),
        "order_bound_by": "operations" if order_ops_ms >= order_bytes_ms else "bytes",
    }
    return rec


def _order_large_tables(dev, rng):
    """The order kernel against block_order on tables of random AABBs past
    the vault's size: 16,384 blocks (keys sorted in shared memory) and
    32,768 (past shared memory: keys sorted in device memory). 100 rays in
    4 groups, the last group dead. Raises on any difference."""
    import numpy as np
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import block_order

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
        args = [torch.from_numpy(x).to(dev) for x in (o, d, tm, box)]
        kern = intersect_cuda.block_order_cuda(*args)
        plain = block_order(*args)
        rec = {"nblocks": nb, "groups": int(kern.shape[0]),
               "mismatch": int((kern != plain).sum()),
               "ms": _cuda_ms(lambda: intersect_cuda.block_order_cuda(*args), 3)}
        out.append(rec)
        if rec["mismatch"]:
            raise AssertionError(f"order kernel != block_order on a large table: {rec}")
    return out


def _phase_kernel(ph, dev):
    import numpy as np
    import torch

    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.ops.intersect import closest_hit, scene_fields, soup_from_scene
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
    ph.out["mismatches"] = sum(
        b["mismatch_t"] + b["mismatch_i"] + b["mismatch_executed"] for b in batches
    )
    return batches


def _phase_main(ph, tmp):
    import numpy as np

    from rayverb_tpu_torch import cli
    from rayverb_tpu_torch.config.schema import load_config
    from rayverb_tpu_torch.io.audio import read_audio
    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.trace import sweep_count

    expected = sweep_count(load_config(VAULT[0]).reflections)
    runs = []
    for label in ("cold", "warm"):
        out = os.path.join(tmp, f"vault_{label}.wav")
        intersect_cuda.launches = 0
        intersect_cuda.order_launches = 0
        t0 = time.perf_counter()
        rc = cli.main([*VAULT, out, "--stats", "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = intersect_cuda.launches
        order_launches = intersect_cuda.order_launches
        if rc != 0:
            raise AssertionError(f"{label} CLI run exited {rc}")
        data, sr, bits = read_audio(out)
        peak = float(np.abs(data).max()) if data.size else 0.0
        run = {"run": label, "wall_s": wall, "launches": launches,
               "order_launches": order_launches,
               "channels": int(data.shape[0]), "samples": int(data.shape[1]),
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
    ph.out["runs"] = runs
    ph.out["expected_sweeps"] = expected
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
    n = min(gpu.shape[-1], cpu.shape[-1])
    peak = float(np.abs(cpu).max())
    g = gpu[:, :n].astype(np.float64)
    errs = [np.abs(g - np.roll(cpu, s, axis=-1)[:, :n]) for s in (0, 1, -1)]
    err = float(np.minimum(np.minimum(errs[0], errs[1]), errs[2]).max()) / peak
    ph.out.update({"shape_gpu": list(gpu.shape), "shape_cpu": list(cpu.shape),
                   "max_err_over_peak": err})
    if not np.all(np.isfinite(gpu)) or err >= 1e-3 or abs(gpu.shape[-1] - cpu.shape[-1]) > 1:
        raise AssertionError(f"card render differs from the CPU's: {ph.out}")


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
            smi = _nvidia_smi()
            ph.out["nvidia_smi"] = smi
            ph.out["torch_device"] = torch.cuda.get_device_name(0)
            ph.out["torch"] = torch.__version__
            ph.out["cuda"] = torch.version.cuda
            from rayverb_tpu_torch import cuda_build
            from rayverb_tpu_torch.ops import intersect_cuda

            t0 = time.perf_counter()
            intersect_cuda.build()
            ph.out["build_s"] = time.perf_counter() - t0
            log = cuda_build.build_info["closest_hit"]["log"]
            ph.out["ptxas"] = [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]
            ph.out["sass"] = _sass_loops(cuda_build.build_info["closest_hit"]["path"])
        with Phase("kernel_vs_plain") as ph:
            batches = _phase_kernel(ph, dev)
        with Phase("main_path") as ph:
            runs = _phase_main(ph, tmp)
        with Phase("render_kernel_vs_plain") as ph:
            _phase_render(ph, dev)
        with Phase("small_render_card_vs_cpu") as ph:
            _phase_small_vs_cpu(ph, dev)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    primary = batches[0]
    _emit({"kernels": [{
        "name": "closest_hit",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/closest_hit.cu",
        "replaces": "rayverb_tpu/ops/intersect_pallas.py:139",
        "launches": runs[-1]["launches"],
        "max_abs_err": max(b["max_abs_err"] for b in batches),
        "max_abs_diff_vs_plain": max(b["max_abs_err"] for b in batches),
        "ms": primary["ms"],
        "plain_ms": primary["plain_ms"],
        "bound_ms": primary["bound_ms"],
        "bound_own_ms": primary["bound_own_ms"],
        "bound_by": primary["bound_by"],
        "library_ms": None,
        "executed_pairs": primary["executed_pairs"],
        "schedule": primary["schedule"],
    }, {
        "name": "closest_hit_order",
        "route": "cuda",
        "source": "rayverb_tpu_torch/csrc/closest_hit.cu",
        "replaces": "rayverb_tpu/ops/intersect_pallas.py:604",
        "launches": runs[-1]["order_launches"],
        "max_abs_err": float(max(b["order_mismatch"] for b in batches)),
        "ms": primary["order_ms"],
        "plain_ms": primary["order_plain_ms"],
        "bound_ms": primary["order_bound_ms"],
        "bound_by": primary["order_bound_by"],
        "library_ms": None,
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
