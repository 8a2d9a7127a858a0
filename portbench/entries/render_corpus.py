"""Entry ``render_corpus``: the demo corpus as one process renders it, one
(config, model, material) combination per call through the CLI's
per-render function (config, scene, the given rays, the render, the WAV).

Input k of a run renders the configuration's frozen list at
``combo_index(k)``: the covering combinations first (the warm-up), then the
list in strides of STRIDE. Each input carries its combination, its config
file and one direction set drawn from the seed. Each call writes its WAV
into a temporary directory made in ``setup`` and removed at exit. The
reference renders each checked call's own combination: reference/render.py
on that model and material (kept per file), that config's document, and
the benchmark's HRTF table where the config asks for one. A traffic key
``cut`` ({"rays": R, "reflections": K}, tests only) renders every config
at that size, from copies written into the temporary directory. See
render_fused.py for what the harness reads here."""

import atexit
import functools
import json
import os
import shutil
import tempfile

import numpy as np

from portbench import inputs
from portbench.reference import render as ref_render
from portbench.reference import scene as ref_scene

FUNCTION = "rayverb_tpu_torch.cli:render_files"
STRIDE = 41

# reference scenes by (files, dtype, device)
_SCENES: dict = {}


def combo_index(corpus: dict, k: int) -> int:
    """The list index that input ``k`` renders: covering[k] while k is below
    the covering's length, then STRIDE-step strides through the list."""
    cover = corpus["covering"]
    if k < len(cover):
        return cover[k]
    return (STRIDE * (k - len(cover))) % len(corpus["combos"])


def _file(corpus: dict, kind: str, name: str) -> str:
    """The path of a config, model or materials file named in the list."""
    ext = ".obj" if kind == "models" else ".json"
    return os.path.normpath(os.path.join(inputs.HERE, corpus["files"][kind], name + ext))


def setup(cell):
    corpus = cell.parts["config"]
    cell.corpus = corpus
    cell.outdir = tempfile.mkdtemp(prefix="portbench-corpus-")
    atexit.register(shutil.rmtree, cell.outdir, True)
    cut = cell.traffic.get("cut")
    cell.configs = {}  # config name -> (its file, its rays)
    for name in sorted({c for c, _, _ in corpus["combos"]}):
        path = _file(corpus, "configs", name)
        doc = inputs.load_json(path)
        if cut:
            doc.update(cut)
            path = os.path.join(cell.outdir, name + ".json")
            with open(path, "w") as fh:
                json.dump(doc, fh)
        cell.configs[name] = (path, int(doc["rays"]))


def pairs(cell) -> int:
    return 1


def make_input(cell, seed: int, index: int):
    config, model, material = cell.corpus["combos"][combo_index(cell.corpus, index)]
    path, rays = cell.configs[config]
    return {"combo": (config, model, material), "config": path,
            "model": _file(cell.corpus, "models", model),
            "materials": _file(cell.corpus, "materials", material),
            "directions": inputs.directions(1, rays, inputs.unit_seed(seed, index), cell.dev)[0]}


def call(fn, cell, x, stats: bool):
    """(the call's responses on the host, (C, L) each; its info)"""
    config, model, material = x["combo"]
    out = os.path.join(cell.outdir, f"{model}_{config}_{material}.wav")
    channels, info = fn(x["config"], x["model"], x["materials"], out,
                        directions=x["directions"], device=cell.dev, trace_impl=cell.impl,
                        stats=stats)
    return [np.asarray(channels)], (info or {})


@functools.lru_cache(maxsize=1)
def _hrtf_table():
    return inputs.hrtf_table()


def _scene(ref, x):
    key = (x["model"], x["materials"], ref.scene.dtype, str(ref.scene.device))
    if key not in _SCENES:
        _SCENES[key] = ref_render.Scene(ref_scene.load(x["model"], x["materials"]),
                                        ref.scene.dtype, ref.scene.device)
    return _SCENES[key]


def reference(ref, x, orders, tick):
    """Per response of the call, the reference's (C, L) of the call's own
    combination under each ray order."""
    doc = inputs.load_json(x["config"])
    table = _hrtf_table() if "hrtf" in doc["attenuation_model"] else None
    one = lambda key: np.asarray([doc[key]], np.float32)  # noqa: E731
    outs = ref.render_fn(_scene(ref, x), doc, one("source_position"), one("mic_position"),
                         x["directions"][None], table, tick=tick, orders=orders)
    return [[o[0] for o in outs]]
