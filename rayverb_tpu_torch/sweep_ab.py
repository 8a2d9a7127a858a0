"""The closest-hit call of this checkout against another checkout's, in
turns on one card, and the renders of both, bit for bit.

    python -m rayverb_tpu_torch.sweep_ab PARENT [--corpus]

PARENT is the root of another checkout that holds ``rayverb_tpu_torch/``
and ``assets/`` (e.g. a parent commit unpacked with ``git archive`` into
the ignored ``_checkout/``). Its package is imported whole under another
name, so each side runs its own ``intersect.closest_hit``, wrapper and
kernel library (built from its own ``csrc/`` into its own ``_build/``) and
its own renders; this checkout's measuring code serves both. Prints one
JSON object per line:

- ``card``: nvidia-smi's name and power limit.
- ``batch``: the vault render's primary batch (its first bounce sweep),
  its second bounce sweep and its first shadow sweep (decided), and the
  north star's hall (scripts/gen_hall.py's, written to a temporary
  directory) at 8,192 primary rays. For each: whether the two sides'
  Hits are equal bit for bit; in the turns parent, change, change, parent
  the device ms of one closest_hit call (all its device operations summed,
  torch.profiler), its device operations by kind, and the sweep's
  device ms.
- ``host``: host microseconds per closest_hit call on one group of 32
  rays, enqueued back to back (the device keeps up), in turns.
- ``render``: the vault, the HRTF vault and the north star, one warm render
  per turn under torch.profiler: wall, device events, busy ms, the
  closest-hit kernels; whether the two sides' IRs are equal bit for bit.
- ``datagen``: config 5 (chip_smoke.py's) through render_irs_batched on
  both sides: IRs and contents equal bit for bit.
- ``kernel_parity``: both sides' records on the vault and the hall, equal.
- ``corpus`` (with --corpus): gen.covering()'s 29 renders on both sides,
  held against impulses/: WAV bytes and every reading equal.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np

TURNS = ("parent", "change", "change", "parent")
_PARENT = "_ab_parent_rayverb_tpu_torch"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALL_ROWS = 8192
# where the batches and renders run (the card; a rehearsal on the CPU sets
# it to "cpu" and stands the kernels in with their plain versions)
DEVICE = "cuda"
# device-event kinds of one closest_hit call, by kernel name
_KINDS = (("order", "closest_hit_order"), ("sweep", "closest_hit_sweep"),
          ("unpack", "closest_hit_unpack"), ("memset", "Memset"), ("fill", "FillFunctor"))


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _side(root):
    """The package under ``root``/rayverb_tpu_torch, imported as _PARENT
    (with its submodules on demand)."""
    if _PARENT not in sys.modules:
        pkg = os.path.join(root, "rayverb_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            _PARENT, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_PARENT] = mod
        spec.loader.exec_module(mod)
    return sys.modules[_PARENT]


def _mod(side, name):
    return importlib.import_module(f"{side.__name__}.{name}")


def _kind(name):
    return next((k for k, n in _KINDS if n in name), "other")


def call_profile(fn, reps=20):
    """One call of ``fn`` (one closest_hit) under torch.profiler, ``reps``
    calls, the device synchronised after each: device ms per call (all
    device events summed), device events per call by kind, and the sweep's
    ms per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    kinds, total_us, sweep = {}, 0.0, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        total_us += us
        kind = _kind(e.name)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "sweep":
            sweep.append(us)
    return {
        "device_ms_per_call": total_us / reps / 1e3,
        "device_ops_per_call": sum(kinds.values()) / reps,
        "ops_by_kind": {k: v / reps for k, v in sorted(kinds.items())},
        "sweep_ms": sum(sweep) / len(sweep) / 1e3 if sweep else None,
    }


def _vault_batches(scene_mod, config_mod, render_mod, intersect_cuda):
    """Inputs (origins, dirs, t_max, t_decide) of the vault render's
    primary, second bounce and first shadow sweeps, cloned."""
    import torch

    from .ops import trace
    from .profile_render import VAULT
    from .utils.directions import random_directions

    cfg = config_mod.load_config(VAULT[0])
    scene = scene_mod.load_scene(VAULT[1], VAULT[2])
    real = intersect_cuda.closest_hit_cuda
    kept = {}

    def spy(o, d, packed, aabb, t_max, t_decide, order, slices, **kw):
        if o.shape[0] >= cfg.rays:
            kind = ("decided" if t_decide is not None else
                    "bounce" if "primary" in kept else "primary")
            if kind not in kept:
                kept[kind] = tuple(None if x is None else x.clone()
                                   for x in (o, d, t_max, t_decide))
        return real(o, d, packed, aabb, t_max, t_decide, order, slices, **kw)

    # phase A eager: a captured bounce's tensors hold no values to keep
    with mock.patch.object(intersect_cuda, "closest_hit_cuda", spy), \
            mock.patch.object(trace, "_image_graph_engages", lambda *a: False):
        render_mod.render_fused(scene, cfg, random_directions(cfg.rays, seed=cfg.seed),
                                device=DEVICE)
    torch.cuda.synchronize()
    return scene, kept


def _hall_batch(hall_scene, north_star):
    import torch

    from .utils.directions import morton_sort, random_directions

    d = torch.from_numpy(morton_sort(random_directions(HALL_ROWS, seed=0))).to(DEVICE)
    o = torch.tensor(north_star["source_position"], device=DEVICE).expand(
        HALL_ROWS, 3).contiguous()
    return o, d, torch.full((HALL_ROWS,), float("inf"), device=DEVICE), None


def _host(x):
    """A numpy array of a tensor on any device, or of an array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _equal_hits(a, b):
    import torch

    return bool(torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
                and torch.equal(a.index.long(), b.index.long())
                and torch.equal(a.hit, b.hit))


def batches(sides, named):
    """The ``batch`` lines: ``named`` maps a batch's name to (soup,
    origins, dirs, t_max, t_decide)."""
    from .ops.intersect import SWEEP_RAYS, sweep_slices

    isect = {w: _mod(s, "ops.intersect") for w, s in sides.items()}
    for name, (soup, o, d, t_max, t_decide) in named.items():
        call = {w: (lambda m=m: m.closest_hit(o, d, soup, t_max=t_max, t_decide=t_decide))
                for w, m in isect.items()}
        slices = sweep_slices(o.shape[0], soup.block_aabb.shape[0], t_decide is not None)
        _emit({
            "batch": name, "rows": int(o.shape[0]), "groups": -(-o.shape[0] // SWEEP_RAYS),
            "nblocks": int(soup.block_aabb.shape[0]), "slices": slices,
            "decided": t_decide is not None,
            "hits_equal": _equal_hits(call["parent"](), call["change"]()),
            "turns": [[w, call_profile(call[w])] for w in TURNS],
        })


def host_turns(sides, soup, calls=200):
    """Host microseconds per closest_hit call on one group of SWEEP_RAYS
    rays, ``calls`` enqueued back to back, in turns."""
    import torch

    from .ops.intersect import SWEEP_RAYS

    gen = torch.Generator(device="cpu").manual_seed(0)
    d = torch.randn((SWEEP_RAYS, 3), generator=gen).to(DEVICE)
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    o = ((soup.bounds[0] + soup.bounds[1]) / 2).expand(SWEEP_RAYS, 3).contiguous()
    t_max = torch.full((SWEEP_RAYS,), float("inf"), device=DEVICE)
    out = []
    for w in TURNS:
        m = _mod(sides[w], "ops.intersect")
        row = {}
        for label, kw in (("no_bounds", {}), ("t_max", {"t_max": t_max})):
            for _ in range(10):
                m.closest_hit(o, d, soup, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                m.closest_hit(o, d, soup, **kw)
            torch.cuda.synchronize()
            row[label] = (time.perf_counter() - t0) / calls * 1e6
        out.append([w, row])
    _emit({"host": "closest_hit", "rows": SWEEP_RAYS, "us_per_call": out})


def renders(sides, cells):
    """The ``render`` lines: ``cells`` maps a cell's name to (config path
    or dict, model, materials)."""
    from .profile_render import device_breakdown
    from .utils.directions import random_directions

    for cell, (config, model, materials) in cells.items():
        work, irs = {}, {}
        for w, side in sides.items():
            schema = _mod(side, "config.schema")
            cfg = (schema.parse_config(json.dumps(config)) if isinstance(config, dict)
                   else schema.load_config(config))
            scene = _mod(side, "scene").load_scene(model, materials)
            soup = _mod(side, "ops.intersect").soup_from_scene(scene, device=DEVICE)
            dirs = random_directions(cfg.rays, seed=cfg.seed)
            render = _mod(side, "ops.render").render_fused
            work[w] = (lambda render=render, scene=scene, cfg=cfg, dirs=dirs, soup=soup:
                       render(scene, cfg, dirs, device=DEVICE, soup=soup))
            irs[w] = work[w]()[0]
        turns = []
        for w in TURNS:
            r = device_breakdown(work[w])
            turns.append([w, {k: r[k] for k in ("wall_ms", "device_events", "device_busy_ms",
                                                 "device_idle_share", "closest_hit_kernels")}])
        _emit({"render": cell, "ir_shape": list(irs["change"].shape),
               "irs_equal": bool(np.array_equal(_host(irs["parent"]), _host(irs["change"]))),
               "turns": turns})


def datagen(sides):
    smoke = _smoke()
    out = {}
    for w, side in sides.items():
        cfg = _mod(side, "config.schema").parse_config(json.dumps(smoke.DATAGEN))
        scene = _mod(side, "scene").load_scene(*smoke.VAULT[1:])
        sources, mics, dirs = smoke._datagen_inputs(scene, smoke.DATAGEN_PAIRS,
                                                    smoke.DATAGEN["rays"])
        batched = _mod(side, "parallel.datagen").render_irs_batched
        out[w] = [_host(x) for x in batched(scene, cfg, sources, mics, dirs,
                                            device=DEVICE)[:2]]
    _emit({"datagen": "config_5", "pairs": smoke.DATAGEN_PAIRS,
           "irs_equal": bool(np.array_equal(out["parent"][0], out["change"][0])),
           "contents_equal": bool(np.array_equal(out["parent"][1], out["change"][1]))})


def parity(sides, hall_scenes):
    recs = {}
    for w, side in sides.items():
        kp = _mod(side, "kernel_parity")
        recs[w] = [kp.check_scene("vault", kp.vault_scene(), 2048, 3, DEVICE),
                   kp.check_scene("hall100k", hall_scenes[w], 2048, 4, DEVICE)]
    strip = lambda rs: [{k: v for k, v in r.items() if not k.endswith("_s")} for r in rs]  # noqa: E731
    _emit({"kernel_parity": strip(recs["change"]),
           "equal": strip(recs["parent"]) == strip(recs["change"])})


def corpus(sides, tmp):
    reports = {}
    for w, side in sides.items():
        gen = _mod(side, "gen")
        reports[w] = gen.render(gen.covering(), os.path.join(tmp, f"corpus_{w}"),
                                device=DEVICE, check_against=os.path.join(_REPO, "impulses"),
                                log=lambda _: None)
    readings = {w: [(r["combo"], {n: c and c["value"]
                                  for n, c in r.get("check", {}).get("checks", {}).items()})
                    for r in rep["renders"]] for w, rep in reports.items()}
    files_equal = []
    for root, _, files in os.walk(os.path.join(tmp, "corpus_change")):
        for f in files:
            mine = os.path.join(root, f)
            theirs = mine.replace("corpus_change", "corpus_parent", 1)
            with open(mine, "rb") as a, open(theirs, "rb") as b:
                files_equal.append(a.read() == b.read())
    _emit({"corpus": len(readings["change"]), "readings_equal":
           readings["parent"] == readings["change"],
           "files": len(files_equal), "files_equal": all(files_equal),
           "failures": {w: r["failures"] for w, r in reports.items()}})


def _smoke():
    """chip_smoke.py at the checkout's root, for its config 5 and helpers;
    importing it runs nothing."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(parent, with_corpus=False):
    import torch

    from . import probe
    from . import scene as scene_mod
    from .config import schema
    from .device import card_name_and_power
    from .ops import intersect_cuda, render
    from .ops.intersect import soup_from_scene
    from .profile_render import VAULT

    if not torch.cuda.is_available():
        raise RuntimeError("sweep_ab needs a CUDA device")
    sides = {"parent": _side(parent), "change": sys.modules[__package__]}
    _emit({"card": card_name_and_power(), "torch_device": torch.cuda.get_device_name(0),
           "parent": parent})
    with tempfile.TemporaryDirectory(prefix="sweep_ab_") as tmp:
        hall = os.path.join(tmp, "hall.obj")
        probe.write_hall(hall)
        hall_scenes = {w: _mod(s, "scene").load_scene(hall, probe.HALL_MATERIALS)
                       for w, s in sides.items()}
        vault_scene, kept = _vault_batches(scene_mod, schema, render, intersect_cuda)
        vsoup = soup_from_scene(vault_scene, device=DEVICE)
        hsoup = soup_from_scene(hall_scenes["change"], device=DEVICE)
        named = {f"vault_{k}": (vsoup, *kept[k]) for k in ("primary", "bounce", "decided")}
        named["hall_primary"] = (hsoup, *_hall_batch(hall_scenes["change"], probe.NORTH_STAR))
        batches(sides, named)
        host_turns(sides, vsoup)
        renders(sides, {
            "vault": VAULT,
            "hrtf_vault": (os.path.join(_REPO, "assets", "configs", "hrtf_vault.json"),
                           *VAULT[1:]),
            "north_star": (probe.NORTH_STAR, hall, probe.HALL_MATERIALS),
        })
        datagen(sides)
        parity(sides, hall_scenes)
        if with_corpus:
            corpus(sides, tmp)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", help="root of the other checkout")
    parser.add_argument("--corpus", action="store_true",
                        help="also render gen.covering() on both sides")
    ns = parser.parse_args(argv)
    run(ns.parent, ns.corpus)
    return 0


if __name__ == "__main__":
    sys.exit(main())
