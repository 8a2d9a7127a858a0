"""Entry ``render_irs_batched``: a batch of the traffic's ``pairs`` source
and mic pairs per call, placed by config 5's generator in the scene's
bounds, one direction set per pair. See render_fused.py for what the
harness reads here."""

from portbench import inputs
from portbench.reference.scene import load as scene_arrays

FUNCTION = "rayverb_tpu_torch.parallel.datagen:render_irs_batched"


def setup(cell):
    # pairs are placed in the scene's bounds as the benchmark reads them
    cell.bounds = scene_arrays(*cell.files)["bounds"]


def pairs(cell) -> int:
    return int(cell.traffic["pairs"])


def make_input(cell, seed: int, index: int):
    n = pairs(cell)
    sources, mics = inputs.datagen_pairs(cell.bounds, n, inputs.unit_seed(seed, index))
    dirs = inputs.directions(n, cell.rays, inputs.unit_seed(seed, index, stream=1), cell.dev)
    return sources, mics, dirs


def call(fn, cell, x, stats: bool):
    out = fn(cell.scene, cell.cfg, *x, hrtf_table=cell.table, impl=cell.impl,
             device=cell.dev, stats=stats)
    irs = out[0].cpu().numpy()
    out[1].cpu()  # the contents too end on the host
    return list(irs), (out[2] if stats else {})


def reference(ref, x, orders, tick):
    outs = ref.render(*x, orders, tick)
    return [[o[b] for o in outs] for b in range(len(x[0]))]
