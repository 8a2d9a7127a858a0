#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rayverb_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time:

  1. device   nvidia-smi's name and power limit, the CUDA device name, and
              the nvcc build of the closest-hit kernel (with its seconds)
  2. kernel   the CUDA kernel against its plain PyTorch version on the
              vault scene, on the card: 50,000 Morton-sorted primary rays,
              the first bounce's reversed shadow rows, a ragged batch of 777
              rays with bounds and any-hit thresholds, and a 5-triangle
              scene. best_t and best_i must be equal bit for bit.
  3. main     the port's CLI renders the full vault demo (50,000 rays x 128
              reflections, two speakers, 44.1 kHz, 24-bit) on cuda, cold and
              warm; the WAV must read back as 2 finite, non-silent channels
              and every sweep of the render must go through the kernel
  4. render   render_fused on the vault with the kernel and with the plain
              sweep: the IRs agree to max|d| <= 1e-6 * peak
  5. small    a small box render on the card against the same render on
              the CPU (the path the CPU tests hold against the JAX package):
              within -60 dB of peak
  6. kernels  one JSON line per the port's kernel table

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


def _compare_batch(name, soup, o, d, tmax, decide):
    """Kernel vs plain on one batch; raises unless bit-equal. Returns the
    batch's record (rows, mismatches, ms, plain_ms, bounds)."""
    import torch

    from rayverb_tpu_torch.ops import intersect_cuda
    from rayverb_tpu_torch.ops.intersect import closest_hit_plain

    args = (o, d, soup.packed, soup.block_aabb, tmax, decide)
    pt, pi, executed = closest_hit_plain(*args, with_stats=True)
    kt, ki = intersect_cuda.closest_hit_cuda(*args)
    torch.cuda.synchronize()
    mism_t = int((pt.view(torch.int32) != kt.view(torch.int32)).sum())
    mism_i = int((pi != ki).sum())
    both = torch.isfinite(pt) & torch.isfinite(kt)
    max_abs = float((pt - kt).abs()[both].max()) if bool(both.any()) else 0.0
    m = o.shape[0]
    tp = soup.packed.shape[0]
    ms = _cuda_ms(lambda: intersect_cuda.closest_hit_cuda(*args), 20)
    plain_ms = _cuda_ms(lambda: closest_hit_plain(*args), 2)
    # least time for this work on the card: the larger of the executed pair
    # tests' FP32 operations over the FP32 peak and the bytes the function
    # must move (inputs read once, outputs written once) over HBM bandwidth
    pairs = int(executed.sum())
    in_bytes = 4 * (8 * m + tp * 16 + soup.block_aabb.numel())
    out_bytes = 8 * m
    ops_ms = pairs * FLOPS_PER_PAIR / FP32_PEAK * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    # the same bound over ISSUED pairs (every ray against every row) and
    # the table re-read once per 128-ray thread block
    issued_ops_ms = m * tp * FLOPS_PER_PAIR / FP32_PEAK * 1e3
    reread_ms = (-(-m // 128)) * tp * 64 / HBM_BYTES_PER_S * 1e3
    rec = {
        "batch": name,
        "rows": m,
        "hits": int((ki >= 0).sum()),
        "mismatch_t": mism_t,
        "mismatch_i": mism_i,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "executed_pairs": pairs,
        "issued_pairs": m * tp,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_issued_ms": max(issued_ops_ms, reread_ms),
    }
    if mism_t or mism_i:
        raise AssertionError(f"kernel != plain on batch {name}: {rec}")
    return rec


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
    for b in batches:
        if b["hits"] == 0:
            raise AssertionError(f"batch {b['batch']} has no hits: {b}")
    ph.out["batches"] = batches
    ph.out["rows_compared"] = sum(b["rows"] for b in batches)
    ph.out["mismatches"] = sum(b["mismatch_t"] + b["mismatch_i"] for b in batches)
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
        t0 = time.perf_counter()
        rc = cli.main([*VAULT, out, "--stats", "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = intersect_cuda.launches
        if rc != 0:
            raise AssertionError(f"{label} CLI run exited {rc}")
        data, sr, bits = read_audio(out)
        peak = float(np.abs(data).max()) if data.size else 0.0
        run = {"run": label, "wall_s": wall, "launches": launches,
               "channels": int(data.shape[0]), "samples": int(data.shape[1]),
               "sample_rate": sr, "bit_depth": bits, "peak": peak}
        runs.append(run)
        if data.shape[0] != 2 or data.shape[1] == 0:
            raise AssertionError(f"unexpected WAV shape {data.shape}")
        if not np.all(np.isfinite(data)) or peak == 0.0:
            raise AssertionError(f"WAV is not finite or is silent: {run}")
        if launches != expected:
            raise AssertionError(
                f"{label} run launched the kernel {launches} times, "
                f"expected {expected} sweeps"
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
        "bound_by": primary["bound_by"],
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
