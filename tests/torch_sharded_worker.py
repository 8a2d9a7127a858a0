"""One rank of the multi-rank CPU tests of rayverb_tpu_torch.parallel
(tests/test_torch_sharded.py starts WORLD of these over gloo).

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_sharded_worker.py OUT_DIR

The process group comes from make_mesh's env:// path (torchrun's
variables). Every rank runs every case in the same order (RENDER_CASES,
then shard_rays and the datagen cases) and writes OUT_DIR/<case>.rank<r>.npz
(or .err with the traceback, and carries on), then OUT_DIR/done.rank<r>.
Imports only torch and the port.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import traceback

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
ASSETS = REPO / "assets"
WORLD = 4

SPEAKERS = {
    "speakers": [
        {"direction": [0, 0, 1], "shape": 0.5},
        {"direction": [-1, 0, 0], "shape": 1.0},
    ]
}
HRTF = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}


def config_doc(**overrides):
    """tests/test_parallel.py's make_config."""
    doc = {
        "rays": 96,
        "reflections": 10,
        "sample_rate": 16000,
        "bit_depth": 16,
        "source_position": [0, 2, 2],
        "mic_position": [0, 2, 0],
        "attenuation_model": SPEAKERS,
        "trim_tail": False,
        "seed": 21,
    }
    doc.update(overrides)
    return doc


# render cases: (config overrides, direction seed, render_fused_sharded
# keywords, ranks of the mesh)
RENDER_CASES = {
    "speakers": ({}, 21, {}, WORLD),
    "uneven": ({"rays": 61}, 5, {}, WORLD),
    "three_rays": ({"rays": 3}, 7, {}, WORLD),
    "hrtf": ({"attenuation_model": HRTF}, 9, {}, WORLD),
    "budget_retry": ({"rays": 128}, 13, {"image_budget": 1}, WORLD),
    "scatter": ({}, 21, {"bin_mode": "scatter"}, WORLD),
    "remove_direct": ({"remove_direct": True}, 21, {}, WORLD),
    "chunked": ({"rays": 600, "reflections": 6}, 31, {"ray_chunk": 64}, WORLD),
    "submesh": ({"rays": 40}, 2, {}, 2),
    # the speaker case with every rank's trace replaced by the records of
    # the JAX package's trace of the same rays (JAX_RECORDS, written by the
    # test before the group starts)
    "speakers_jax_records": ({}, 21, {}, WORLD),
}
JAX_RECORDS = "jax_records.npz"

# tests/test_datagen.py's batch config and its mesh case's pairs
DATAGEN_DOC = {
    "rays": 48,
    "reflections": 8,
    "sample_rate": 8000,
    "bit_depth": 16,
    "source_position": [0, 0, 0],
    "mic_position": [0, 0, 0],
    "attenuation_model": {"speakers": [{"direction": [0, 0, 1], "shape": 0.5}]},
    "normalize": False,
    "trim_tail": False,
    "trim_predelay": False,
}
DATAGEN_PAIRS = 8


def datagen_inputs(pairs):
    """Sources, mics and (pairs, N, 3) directions of the datagen cases."""
    from rayverb_tpu_torch.utils.directions import random_directions

    sources = np.float32([[0, 2, 2]] * pairs)
    mics = np.float32([[0, 2 + 0.5 * i, 0] for i in range(pairs)])
    dirs = np.stack([random_directions(DATAGEN_DOC["rays"], seed=i) for i in range(pairs)])
    return sources, mics, dirs


def box():
    from rayverb_tpu_torch.scene import load_scene

    return load_scene(str(ASSETS / "test_models" / "large_square.obj"),
                      str(ASSETS / "materials" / "mat.json"))


def replay_trace(path):
    """A stand-in for render._trace_impl that hands the trace records stored
    at ``path`` (``directions`` (n, 3) and the trace's per-ray outputs) to
    the render, for whichever of those rays it is asked to trace."""
    with np.load(path) as f:
        rec = {k: f[k] for k in f.files}
    index = {row.tobytes(): i for i, row in enumerate(rec["directions"])}

    def trace(_soup, mic, source, directions, *, nreflections, impl, consume_row,
              resort, stats):
        rows = [index[d.tobytes()] for d in np.asarray(directions, np.float32)]

        def get(key):
            return torch.from_numpy(rec[key][rows])

        for b in range(nreflections):
            consume_row((get("diffuse_volume")[:, b], get("diffuse_position")[:, b],
                         get("diffuse_time")[:, b]))
        return (get("image_volume"), get("image_position"), get("image_time"),
                get("image_index").long())

    return trace


def _render_case(scene, name, out):
    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.ops import render
    from rayverb_tpu_torch.parallel import make_mesh, render_fused_sharded
    from rayverb_tpu_torch.utils.directions import random_directions

    overrides, seed, kw, ranks = RENDER_CASES[name]
    cfg = parse_config(json.dumps(config_doc(**overrides)))
    mesh = make_mesh(ranks, device="cpu")
    calls = {"scatter": 0}
    real = render._attenuate_and_bin

    def counted(*a, **k):
        calls["scatter"] += 1
        return real(*a, **k)

    real_trace = render._trace_impl
    render._attenuate_and_bin = counted
    if name == "speakers_jax_records":
        render._trace_impl = replay_trace(out / JAX_RECORDS)
    try:
        ir, info = render_fused_sharded(scene, cfg, random_directions(cfg.rays, seed=seed),
                                        mesh=mesh, device="cpu", stats=True, **kw)
    finally:
        render._attenuate_and_bin = real
        render._trace_impl = real_trace
    if ir is None:
        return {"member": False, "info_is_none": info is None}
    return {"member": True, "ir": ir, "info": json.dumps(info),
            "scatter_calls": calls["scatter"]}


def _shard_rays_case():
    from rayverb_tpu_torch.parallel import make_mesh, shard_rays
    from rayverb_tpu_torch.utils.directions import random_directions

    mesh = make_mesh(device="cpu")
    dirs = random_directions(21, seed=0)
    sharded, n = shard_rays(dirs, mesh)
    return {"n": n, "shape": list(sharded.shape), "local": sharded.to_local().numpy(),
            "placements": repr(tuple(sharded.placements))}


def _datagen_case(scene, pairs):
    from rayverb_tpu_torch.config.schema import parse_config
    from rayverb_tpu_torch.parallel import make_mesh, render_irs_batched

    cfg = parse_config(json.dumps(DATAGEN_DOC))
    sources, mics, dirs = datagen_inputs(pairs)
    mesh = make_mesh(axis="batch", device="cpu")
    irs, contents, info = render_irs_batched(scene, cfg, sources, mics, dirs, mesh=mesh,
                                             device="cpu", stats=True)
    return {"irs": irs.numpy(), "contents": contents.numpy(),
            "info": json.dumps({k: v for k, v in info.items() if k != "timings"})}


def _datagen_indivisible(scene):
    try:
        _datagen_case(scene, 6)
    except ValueError as e:
        return {"raised": "ValueError", "message": str(e)}
    return {"raised": ""}


def main(out_dir: str) -> int:
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    out = pathlib.Path(out_dir)
    scene = box()
    cases = [(name, lambda name=name: _render_case(scene, name, out)) for name in RENDER_CASES]
    cases += [
        ("shard_rays", _shard_rays_case),
        ("datagen", lambda: _datagen_case(scene, DATAGEN_PAIRS)),
        ("datagen_indivisible", lambda: _datagen_indivisible(scene)),
    ]
    for name, run in cases:
        try:
            result = run()
        except Exception:  # recorded for the case's test; the next case runs
            (out / f"{name}.rank{rank}.err").write_text(traceback.format_exc())
            continue
        np.savez(out / f"{name}.rank{rank}.npz", **result)
    dist.destroy_process_group()
    (out / f"done.rank{rank}").write_text("")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
