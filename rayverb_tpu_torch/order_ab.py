"""The block-order kernel of this checkout against another checkout's, in
turns on one card.

    python -m rayverb_tpu_torch.order_ab PARENT [CONFIG MODEL MATERIALS]

PARENT is the root of the other checkout (e.g. a parent commit unpacked
with ``git archive`` into the ignored ``_checkout/``). Its
``rayverb_tpu_torch/csrc/closest_hit.cu`` is built with this checkout's
nvcc flags into PARENT/rayverb_tpu_torch/_build/, and its own wrapper
(``ops/intersect_cuda.py``) is loaded on that library, so each side pays
its own wrapper's host cost. Prints one JSON object per line:

- ``card``: nvidia-smi's name and power limit.
- ``batch``: the vault's 50,000 Morton-sorted primary rays (32 blocks)
  and, given a second scene (CONFIG MODEL MATERIALS, e.g. the north star
  on the hall of scripts/gen_hall.py), 8,192 and its config's rays as
  primary rays from its source. For each: whether both kernels equal
  block_order, k (blocks of finite rank per group: min, mean, max), and in
  the turns parent, change, change, parent the device ms per launch
  (torch.profiler) and the ms per call (CUDA events, wrapper included),
  with chip_smoke.py's timing helpers.
- ``render``: profile_render on the vault and on the second scene, the
  order kernel's launches and device ms per render, in the same turns.

Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from unittest import mock

TURNS = ("parent", "change", "change", "parent")


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _parent_wrapper(parent, cu="closest_hit.cu", wrapper="intersect_cuda",
                    fn="block_order_cuda", lib="order_ab_parent.so"):
    """The other checkout's wrapper ``fn`` (from ops/``wrapper``.py) on its
    own kernel library: its csrc/``cu`` built with this checkout's nvcc
    flags into PARENT/rayverb_tpu_torch/_build/``lib``."""
    from . import cuda_build

    src = os.path.join(parent, "rayverb_tpu_torch", "csrc", cu)
    out_dir = os.path.join(parent, "rayverb_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, lib)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib_path, src],
        capture_output=True, text=True, timeout=cuda_build.NVCC_TIMEOUT_S,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    so = ctypes.CDLL(lib_path)
    spec = importlib.util.spec_from_file_location(
        f"rayverb_tpu_torch.ops._ab_parent_{wrapper}",
        os.path.join(parent, "rayverb_tpu_torch", "ops", f"{wrapper}.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # its _kernel() binds its own argument types on the library it loads
    with mock.patch.object(cuda_build, "load_library", lambda *a: so):
        mod._kernel()
    return getattr(mod, fn)


def _smoke():
    """chip_smoke.py at the checkout's root, for its timing helpers
    (_profiled_ms, _cuda_ms); importing it runs nothing."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _primary(cfg_path, scene, m):
    import torch

    from .config.schema import load_config
    from .utils.directions import morton_sort, random_directions

    cfg = load_config(cfg_path)
    d = torch.from_numpy(morton_sort(random_directions(m, seed=0))).cuda()
    o = torch.tensor(cfg.source_position, device="cuda").expand(m, 3).contiguous()
    return (o, d, torch.full((m,), float("inf"), device="cuda"), scene.block_aabb)


def run(parent, second=None):
    import torch

    from . import profile_render
    from . import scene as scene_mod
    from .config.schema import load_config
    from .device import card_name_and_power
    from .ops import intersect_cuda
    from .ops.intersect import block_order, soup_from_scene
    from .ops.order_check import order_k, order_keys

    if not torch.cuda.is_available():
        raise RuntimeError("order_ab needs a CUDA device")
    smoke = _smoke()
    _emit({"card": card_name_and_power(), "torch_device": torch.cuda.get_device_name(0)})
    wrap = {"parent": _parent_wrapper(parent), "change": intersect_cuda.block_order_cuda}
    cells = {"vault": profile_render.VAULT}
    if second is not None:
        cells["second"] = tuple(second)
    scenes = {}
    real_load = scene_mod.load_scene

    def cached_load(*paths):
        if paths not in scenes:
            scenes[paths] = real_load(*paths)
        return scenes[paths]

    batches = []
    vault = profile_render.VAULT
    vsoup = soup_from_scene(cached_load(*vault[1:]), device="cuda")
    batches.append(("vault_primary", _primary(vault[0], vsoup, load_config(vault[0]).rays)))
    if second is not None:
        ssoup = soup_from_scene(cached_load(*second[1:]), device="cuda")
        for m in (8192, load_config(second[0]).rays):
            batches.append((f"second_primary_{m}", _primary(second[0], ssoup, m)))
    for name, args in batches:
        plain = block_order(*args)
        equal = {w: bool(torch.equal(fn(*args), plain)) for w, fn in wrap.items()}
        k = order_k(order_keys(*args)).float()
        _emit({
            "batch": name, "rows": int(args[0].shape[0]), "nblocks": int(args[3].shape[0]),
            "equal_to_block_order": equal,
            "k": [int(k.min()), float(k.mean()), int(k.max())],
            "device_ms": [[w, smoke._profiled_ms(lambda: wrap[w](*args),
                                                 "closest_hit_order", 20)] for w in TURNS],
            "call_ms": [[w, smoke._cuda_ms(lambda: wrap[w](*args), 50)] for w in TURNS],
        })
        if not all(equal.values()):
            raise AssertionError(f"{name}: an order kernel differs from block_order: {equal}")
    with mock.patch.object(scene_mod, "load_scene", cached_load):
        for cell, paths in cells.items():
            for w in TURNS:
                with mock.patch.object(intersect_cuda, "block_order_cuda", wrap[w]):
                    r = profile_render.profile(paths)
                _emit({"render": cell, "config": paths[0], "which": w,
                       "order": r["closest_hit_kernels"].get("closest_hit_order"),
                       "sweep": r["closest_hit_kernels"].get("closest_hit_sweep"),
                       "wall_ms": r["wall_ms"], "device_busy_ms": r["device_busy_ms"],
                       "sweep_schedule_host_us": r["host_us_per_call"]["sweep_schedule"]})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 4):
        print("usage: order_ab PARENT [config model materials]", file=sys.stderr)
        return 2
    run(argv[0], argv[1:] if len(argv) == 4 else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
