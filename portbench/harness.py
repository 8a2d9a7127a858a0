"""The port bench's harness: one run of one cell of BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file found by its name:

  configs/<config>.json    the scene (files, or a generator), its source
  traffic/<mix>.json       the entry's adapter, the render configuration,
                           the environment, the pool of inputs, and what
                           is checked and profiled
  entries/<entry>.py       how the entry's inputs are made, how it is
                           called (FUNCTION, "module:function") and how the
                           reference renders the same inputs
  metrics/<metric>.py      one reader per metric (or per stem, before the
                           first dot): read(ctx) -> number or None
  checks/<cell>.json       the limit of each number that decides ``correct``

A run (``run_cell``) loads the scene and the inputs that the seed makes
(enough that no call in the window sees an input twice), warms the cell's
shapes up, then calls the entry back to back for the window's seconds (a closed loop with one caller: each call ends with its
impulse responses on the host). With ``trace`` the window's calls return
their phase walls and a few more calls run under torch.profiler. After the
window the program's state is freed and the plain reference
(``reference/``) renders a sample of the window's calls, drawn from the
seed, from the same inputs; their relative difference decides ``correct``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

from . import inputs
from .devtrace import profile as profile_window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rayverb_tpu")


def load_spec(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    return inputs.load_json(path)


def resolve(spec: dict, cell_name: str) -> dict:
    """The cell's workload entry, configuration file, traffic file and
    limits, read by name."""
    cell = next((w for w in spec["workloads"] if w["name"] == cell_name), None)
    if cell is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": inputs.load_json(os.path.join(ROOT, entry["file"])),
        "traffic": inputs.load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        "checks": inputs.load_json(os.path.join(HERE, "checks", cell_name + ".json")),
    }


def reported(spec: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with trace the
    per-layer metrics that list the cell (or, listing none, move an
    end-to-end metric the cell reports), else its end-to-end metrics."""
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])]


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, directory: str = os.path.join(HERE, "metrics")):
    """The ``read`` function of metrics/<name>.py, or, where there is none,
    of the file of the name's stem (before its first dot): one reader
    serves ``sweep_ms.render`` and ``sweep_ms.datagen``."""
    path = os.path.join(directory, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(directory, name.split(".", 1)[0] + ".py")
    return _load(path, f"portbench_metric_{name}").read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: rayverb_tpu_torch is the port)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class _Reservoir:
    """A uniform sample of ``k`` of the window's outputs, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(inputs.unit_seed(seed, 0, stream=7))
        self.kept = []

    def offer(self, index: int, output):
        if index < self.k:
            self.kept.append((index, output))
        else:
            j = int(self.rng.integers(0, index + 1))
            if j < self.k:
                self.kept[j] = (index, output)


def _noop():
    pass


def entry(name: str, directory: str = os.path.join(HERE, "entries")):
    """The adapter module entries/<name>.py of a traffic's ``entry``."""
    return _load(os.path.join(directory, name + ".py"), f"portbench_entry_{name}")


def function(target: str):
    """The callable of a "module:function" string."""
    module, _, attr = target.partition(":")
    return getattr(importlib.import_module(module), attr)


def apply_env(traffic: dict):
    """Set the traffic's ``env`` (strings) in this process's environment;
    run.py does so before the program is imported."""
    os.environ.update({k: str(v) for k, v in traffic.get("env", {}).items()})


class Cell:
    """A cell's program side, set up: the scene loaded by the program, its
    configuration, the HRTF table, the entry's adapter (``entries/``) and
    its function. ``overrides`` replaces keys of the traffic (and of its
    ``render`` document) for runs at a smaller size; ``program`` replaces
    the entry's function (tests)."""

    def __init__(self, cell_name: str, *, spec: dict | None = None, device="cuda",
                 impl: str = "auto", overrides: dict | None = None, program=None,
                 progress=_noop):
        import torch

        spec = load_spec() if spec is None else spec
        self.name = cell_name
        self.spec = spec
        self.parts = parts = resolve(spec, cell_name)
        traffic = parts["traffic"]
        for k, v in (overrides or {}).items():
            if k == "render":
                traffic["render"] = {**traffic["render"], **v}
            else:
                traffic[k] = v
        self.traffic = traffic
        self.doc = doc = traffic["render"]
        self.dev = torch.device(device)
        self.impl = impl
        self.rays = int(doc["rays"])

        import rayverb_tpu_torch as rv

        self.adapter = entry(traffic["entry"])
        self.fn = program or function(self.adapter.FUNCTION)
        self.spans = {}
        t0 = time.perf_counter()
        self.files = inputs.scene_files(parts["config"])
        self.scene = rv.load_scene(*self.files)
        self.spans["scene_load_s"] = time.perf_counter() - t0
        progress()
        self.cfg = rv.parse_config(json.dumps(doc))
        self.table = inputs.hrtf_table() if "hrtf" in doc["attenuation_model"] else None
        self.adapter.setup(self)
        self.pairs = int(self.adapter.pairs(self))

    def inputs(self, seed: int, index: int):
        """Input ``index`` of a run seeded ``seed``."""
        return self.adapter.make_input(self, seed, index)

    def call(self, x, stats: bool = False):
        """One call of the entry: (its responses on the host, its info)."""
        return self.adapter.call(self.fn, self, x, stats)

    def sync(self):
        if self.dev.type == "cuda":
            import torch

            torch.cuda.synchronize(self.dev)


class _Pool:
    """The run's inputs, none used twice: ``size`` made in set-up, and any
    call past them given a fresh input made when it is due (counted in
    ``late``)."""

    def __init__(self, cell: Cell, seed: int, size: int):
        self.cell, self.seed = cell, seed
        self.items = [cell.inputs(seed, i) for i in range(size)]
        self.late = 0

    def __getitem__(self, i: int):
        if i < len(self.items):
            return self.items[i]
        self.late += 1
        return self.cell.inputs(self.seed, i)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             impl: str = "auto", t_process: float | None = None, spec: dict | None = None,
             overrides: dict | None = None, progress=_noop, program=None) -> dict:
    """One run of a cell; returns the result line's object."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    cell = Cell(cell_name, spec=spec, device=device, impl=impl, overrides=overrides,
                program=program, progress=progress)
    traffic, dev = cell.traffic, cell.dev
    chips = int(cell.parts["cell"]["chips"])
    t0 = time.perf_counter()
    pool = _Pool(cell, seed, int(traffic["pool"]))
    cell.spans["inputs_s"] = time.perf_counter() - t0
    progress()

    # warm-up and the window take inputs in turn: no call sees an input twice
    t0 = time.perf_counter()
    used = 0
    for _ in range(int(traffic.get("warmup", 1))):
        cell.call(pool[used])
        used += 1
        progress()
    cell.sync()
    cell.spans["warmup_ir_s"] = time.perf_counter() - t0
    if dev.type == "cuda" and trace:
        for d in range(chips):
            torch.cuda.reset_peak_memory_stats(d)

    # the window: calls back to back, each ending with its outputs on the host
    sample = _Reservoir(int(traffic.get("check", 1)), seed)
    stats, walls = [], []
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    n = 0
    while True:
        x = pool[used]
        used += 1
        t_call = time.perf_counter()
        out, info = cell.call(x, stats=trace)
        walls.append(time.perf_counter() - t_call)
        sample.offer(n, (x, out))
        if trace:
            stats.append(info.get("timings", {}))
        n += 1
        progress()
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    late = pool.late
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips)) if dev.type == "cuda" else 0

    ctx = {
        "cell": cell_name, "units": n, "window_s": window_s, "setup_s": setup_s,
        "pairs": cell.pairs, "rays": cell.rays, "reflections": int(cell.doc["reflections"]),
        "triangles": int(cell.scene.num_triangles),
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "spans": cell.spans, "stats": stats, "peak_bytes": peak, "profile": None,
    }
    result_device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": ctx["device_kind"], "count": chips if dev.type == "cuda" else 1,
                     "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        k = int(traffic.get("profile", 2))
        xs = [pool[used + j] for j in range(k)]
        prof = profile_window(lambda: [cell.call(x) for x in xs], k, dev)
        ctx["profile"] = prof
        result_device["busy_s"] = prof.busy_s
        result_device["window_s"] = prof.wall_s
        breakdown = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}
        progress()

    metrics = {}
    for m in reported(cell.spec, cell_name, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    kept = sample.kept
    parts, doc, adapter, cell_spans = cell.parts, cell.doc, cell.adapter, cell.spans
    del cell, pool, x, out, info
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from .reference.render import RAY_ORDERS

    t_ref = time.perf_counter()
    ref = Reference(parts, doc, dev)
    value = compare([out for _, (_, out) in kept],
                    [adapter.reference(ref, x, RAY_ORDERS, progress) for _, (x, _) in kept])
    checks = {"ir_rel_err": {"value": value, "limit": float(parts["checks"]["ir_rel_err"]["limit"])}}
    print(f"portbench: {cell_name} setup {setup_s:.3f} s (scene {cell_spans['scene_load_s']:.3f}, "
          f"inputs {cell_spans['inputs_s']:.3f}, warm-up {cell_spans['warmup_ir_s']:.3f}), window "
          f"{window_s:.3f} s ({n} calls: {min(walls):.4f} / {np.median(walls):.4f} / "
          f"{max(walls):.4f} s, first {', '.join(f'{w:.4f}' for w in walls[:3])}; inputs made "
          f"late {late}), reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": n * ctx["pairs"],
        "failed": 0 if correct else len(kept) * ctx["pairs"],
        "metrics": metrics,
        "device": result_device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def relative_error(got, want) -> float:
    """||got - want|| / ||want|| over every channel and sample, the shorter
    response padded with zeros."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    length = max(got.shape[-1], want.shape[-1])
    pad = lambda x: np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, length - x.shape[-1])])  # noqa: E731
    g, w = pad(got), pad(want)
    num, den = np.linalg.norm(g - w), np.linalg.norm(w)
    if den > 0:
        return float(num / den)
    # a pair the reference leaves silent (a source walled in) must be silent
    return 0.0 if num == 0 else float("inf")


class Reference:
    """The plain reference of a cell on ``dev``, in ``dtype`` (float32, or
    bfloat16 for the control): it reads the scene's files itself and is
    handed the same inputs as the program; the entry's adapter arranges
    them (``reference(ref, x, orders, tick)``)."""

    def __init__(self, parts: dict, doc: dict, dev, dtype=None):
        import torch

        from .reference import render as ref_render
        from .reference import scene as ref_scene

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.doc = doc
        self.scene = ref_render.Scene(ref_scene.load(*inputs.scene_files(parts["config"])),
                                      torch.float32 if dtype is None else dtype, dev)
        self.table = inputs.hrtf_table() if "hrtf" in doc["attenuation_model"] else None
        self.render_fn = ref_render.render

    def render(self, sources, mics, dirs, orders, tick=_noop):
        """(B, C, L) of B pairs under each of ``orders``."""
        return self.render_fn(self.scene, self.doc, sources, mics, dirs, self.table, tick=tick,
                              orders=orders)


def compare(outs, refs) -> float:
    """The largest relative difference of a checked response from the
    reference's, each response held to the nearest of the reference's ray
    orders. ``outs``: per checked call, its responses; ``refs``: per call,
    per response, the reference's under each order."""
    worst = 0.0
    for got, want in zip(outs, refs):
        for g, cands in zip(got, want, strict=True):
            worst = max(worst, min(relative_error(g, r) for r in cands))
    return worst
