"""rayverb_tpu_torch.parallel on several CPU ranks over gloo: the sharded
render against the port's single-device render_fused and against the JAX
package's render_fused_sharded, shard_rays, and render_irs_batched over a
'batch' mesh against the batch without one.

One group of WORLD worker processes (tests/torch_sharded_worker.py, which
imports only torch and the port) runs every case once per module, under
GROUP_TIMEOUT_S: a group that hangs is killed and fails the tests of the
cases it did not finish, not the run. The references run here, in the
pytest process (the JAX package on its 8-device CPU mesh).

Tolerances:
  - sharded against the port's render_fused on the same directions:
    atol=2e-5, the JAX tests' own (tests/test_parallel.py:68); the ranks'
    histograms are summed in another order than one rank's
  - the speaker render against JAX render_fused_sharded(make_mesh(4)):
    -60 dB of peak, the port's cross-package criterion
    (tests/test_torch_render.py); HRTF renders are held to JAX only on
    shared trace records (tests/test_torch_hrtf.py), so the sharded HRTF
    render is held to the port's single-device one
  - the mesh datagen against the no-mesh datagen: atol=1e-5
    (tests/test_datagen.py:72-82)
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_sharded_worker as worker
from rayverb_tpu_torch.config.schema import parse_config
from rayverb_tpu_torch.ops.render import render_fused
from rayverb_tpu_torch.parallel import render_irs_batched
from rayverb_tpu_torch.utils.directions import random_directions

REPO = pathlib.Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 120
ATOL = 2e-5
DB60 = 1e-3  # -60 dB relative to peak

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_jax_records(path):
    """The JAX package's trace of the speaker case's rays (trace_chunk, in
    the rays' order), for the worker's replay_trace."""
    from rayverb_tpu import load_scene as jax_load_scene
    from rayverb_tpu.ops.intersect import soup_from_scene
    from rayverb_tpu.ops.trace import trace_chunk

    overrides, seed, _, _ = worker.RENDER_CASES["speakers_jax_records"]
    doc = worker.config_doc(**overrides)
    dirs = random_directions(doc["rays"], seed=seed)
    soup = soup_from_scene(jax_load_scene(str(worker.ASSETS / "test_models" / "large_square.obj"),
                                          str(worker.ASSETS / "materials" / "mat.json")))
    out = trace_chunk(soup, np.float32(doc["mic_position"]), np.float32(doc["source_position"]),
                      dirs, nreflections=doc["reflections"])
    np.savez(path, directions=dirs, **{
        k: np.asarray(getattr(out, k)) for k in (
            "diffuse_volume", "diffuse_position", "diffuse_time", "image_volume",
            "image_position", "image_time", "image_index")})


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the worker group once; returns (out_dir, status)."""
    out = tmp_path_factory.mktemp("sharded")
    _write_jax_records(out / worker.JAX_RECORDS)
    env = dict(
        os.environ,
        WORLD_SIZE=str(worker.WORLD),
        MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(_free_port()),
        PYTHONPATH=str(REPO),
        OMP_NUM_THREADS="1",
    )
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.pop("RAYVERB_BIN", None)
    procs, logs = [], []
    for r in range(worker.WORLD):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_sharded_worker.py"), str(out)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    timed_out = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
    status = {"timed_out": timed_out, "rcs": [p.returncode for p in procs]}
    return out, status


def _rank(group, case, r):
    out, status = group
    npz = out / f"{case}.rank{r}.npz"
    if npz.exists():
        with np.load(npz) as f:
            return {k: f[k] for k in f.files}
    err = out / f"{case}.rank{r}.err"
    if err.exists():
        pytest.fail(f"rank {r} raised in case {case}:\n{err.read_text()}")
    tail = (out / f"rank{r}.log").read_text()[-3000:]
    pytest.fail(f"rank {r} left no result for case {case} ({status}); its log:\n{tail}")


def _members(group, case, ranks=worker.WORLD):
    """Every rank's result of a render case; the members must agree bit
    for bit and return the same info but for their own walls. Returns (ir,
    info, results)."""
    results = [_rank(group, case, r) for r in range(worker.WORLD)]
    members = results[:ranks]
    assert all(bool(res["member"]) for res in members)
    infos = [json.loads(str(res["info"])) for res in members]
    walls = ("timings", "ray_bounces_per_s")
    for res, info in zip(members[1:], infos[1:]):
        np.testing.assert_array_equal(res["ir"], members[0]["ir"])
        assert {k: v for k, v in info.items() if k not in walls} == {
            k: v for k, v in infos[0].items() if k not in walls}
    return members[0]["ir"], infos[0], results


def _single(scene, case, **kw):
    overrides, seed, _, _ = worker.RENDER_CASES[case]
    cfg = parse_config(json.dumps(worker.config_doc(**overrides)))
    ir, _ = render_fused(scene, cfg, random_directions(cfg.rays, seed=seed), device="cpu", **kw)
    return ir


def _close(got, want, atol=ATOL):
    n = min(got.shape[-1], want.shape[-1])
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=atol)


@pytest.fixture(scope="module")
def box():
    return worker.box()


def test_sharded_speakers_match_single_device(group, box):
    ir, info, _ = _members(group, "speakers")
    _close(ir, _single(box, "speakers"))
    assert info["mesh"] == {"rays": 4}
    assert info["rays_per_rank"] == [24] * 4 and info["segments"] == [1] * 4
    assert info["image_rows_gathered"] == 4 * info["image_budget"] == 4 * 4096
    assert 0 < info["image_rows_distinct_per_shard_max"] <= info[
        "image_rows_distinct_per_shard_sum"]
    assert set(info["timings"]) >= {"trace_bin", "finalize", "total"}


def test_sharded_speakers_match_jax_sharded_on_shared_trace(group):
    """The port's sharded render, every rank fed the JAX package's trace
    records of its rays, against JAX render_fused_sharded(make_mesh(4)) of
    the same rays: within -60 dB of peak. On their own traces the two
    packages differ at this config (tests/test_parallel.py's, source and
    mic on large_square's symmetry plane x = 0) by 0.41 of peak: the
    image-source verdicts of chains on the plane differ between the traces
    (the class of ROADMAP Queue 3 item 6, set by XLA's fusion in the
    reference), while the diffuse-only renders agree to 1e-6 of peak."""
    ir, info, _ = _members(group, "speakers_jax_records")
    from rayverb_tpu import load_scene as jax_load_scene
    from rayverb_tpu.config.schema import parse_config as jax_parse_config
    from rayverb_tpu.parallel import make_mesh, render_fused_sharded

    overrides, seed, _, _ = worker.RENDER_CASES["speakers_jax_records"]
    doc = worker.config_doc(**overrides)
    want, jinfo = render_fused_sharded(
        jax_load_scene(str(worker.ASSETS / "test_models" / "large_square.obj"),
                       str(worker.ASSETS / "materials" / "mat.json")),
        jax_parse_config(json.dumps(doc)), random_directions(doc["rays"], seed=seed),
        mesh=make_mesh(4))
    assert jinfo["mesh"] == info["mesh"] == {"rays": 4}
    want = np.asarray(want)
    assert ir.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0
    assert np.abs(ir - want).max() < DB60 * peak


@pytest.mark.parametrize("case, rays_per_rank", [
    ("uneven", [16, 16, 16, 13]),
    ("three_rays", [1, 1, 1, 0]),
])
def test_sharded_uneven_rays(group, box, case, rays_per_rank):
    """Uneven shards, and a rank with no ray at all, which still takes part
    in every collective with a zero histogram and no image rows."""
    ir, info, _ = _members(group, case)
    assert info["rays_per_rank"] == rays_per_rank
    assert info["segments"] == [1 if k else 0 for k in rays_per_rank]
    _close(ir, _single(box, case))


def test_sharded_hrtf(group, box):
    ir, info, _ = _members(group, "hrtf")
    assert ir.shape[0] == 2
    _close(ir, _single(box, "hrtf"))


def test_sharded_image_budget_retry(group, box):
    """A budget of one row grows by 4x until it holds the largest rank's
    distinct chains; no record is dropped."""
    ir, info, _ = _members(group, "budget_retry")
    assert info["image_budget_retries"] > 0
    assert info["image_budget"] == 4 ** info["image_budget_retries"]
    assert info["image_budget"] >= info["image_rows_distinct_per_shard_max"]
    assert info["image_budget"] // 4 < info["image_rows_distinct_per_shard_max"]
    _close(ir, _single(box, "budget_retry"))


def test_sharded_honours_bin_mode(group, box):
    """bin_mode='scatter' reaches every rank's binning. The JAX function
    drops it (rayverb_tpu/parallel/sharded.py:247 does not pass bin_mode to
    _chunk_core; ADVICE.md, ROADMAP Queue 3 item 6); the port does not copy
    that fault."""
    ir, info, results = _members(group, "scatter")
    assert info["bin_mode"] == "scatter"
    assert all(int(r["scatter_calls"]) > 0 for r in results)
    sorted_ir, _, sorted_results = _members(group, "speakers")
    assert all(int(r["scatter_calls"]) == 0 for r in sorted_results)
    _close(ir, _single(box, "scatter", bin_mode="scatter"))


def test_sharded_remove_direct(group, box):
    """The buffers carry flat rows without a slot: the direct path (slot 0
    of each ray's records) must be dropped before them, not read from the
    buffer's first column."""
    ir, info, _ = _members(group, "remove_direct")
    _close(ir, _single(box, "remove_direct"))
    with_direct, _, _ = _members(group, "speakers")
    n = min(ir.shape[-1], with_direct.shape[-1])
    assert np.abs(ir[:, :n] - with_direct[:, :n]).max() > 100 * ATOL


def test_sharded_chunks_each_rank(group, box):
    ir, info, _ = _members(group, "chunked")
    assert info["rays_per_rank"] == [150] * 4 and info["segments"] == [3] * 4
    _close(ir, _single(box, "chunked"))


def test_sharded_subset_mesh(group, box):
    """make_mesh(2) on 4 ranks: ranks 2 and 3 stay out, get (None, None)
    and take part in no collective."""
    ir, info, results = _members(group, "submesh", ranks=2)
    assert info["mesh"] == {"rays": 2}
    for r in results[2:]:
        assert not bool(r["member"]) and bool(r["info_is_none"])
    _close(ir, _single(box, "submesh"))


def test_shard_rays_pads_over_four_ranks(group):
    """21 rays over 4 ranks: a (24, 3) DTensor sharded on dim 0, padded
    with +z rays (tests/test_parallel.py:50-56 on 8 devices)."""
    dirs = random_directions(21, seed=0)
    padded = np.concatenate([dirs, np.tile(np.float32([0, 0, 1]), (3, 1))])
    for r in range(worker.WORLD):
        res = _rank(group, "shard_rays", r)
        assert int(res["n"]) == 21
        assert list(res["shape"]) == [24, 3]
        assert str(res["placements"]) == "(Shard(dim=0),)"
        np.testing.assert_array_equal(res["local"], padded[6 * r:6 * (r + 1)])


def test_datagen_over_batch_mesh_matches_one_batch(group, box):
    cfg = parse_config(json.dumps(worker.DATAGEN_DOC))
    sources, mics, dirs = worker.datagen_inputs(worker.DATAGEN_PAIRS)
    want, want_contents = render_irs_batched(box, cfg, sources, mics, dirs, device="cpu")
    want = want.numpy()
    for r in range(worker.WORLD):
        res = _rank(group, "datagen", r)
        info = json.loads(str(res["info"]))
        assert info["mesh"] == {"batch": 4} and info["pairs_per_rank"] == 2
        assert info["pairs"] == worker.DATAGEN_PAIRS
        assert res["irs"].shape == want.shape
        np.testing.assert_array_equal(res["contents"], want_contents.numpy())
        np.testing.assert_allclose(res["irs"], want, atol=1e-5)
    # reported: each pair's trace and bank do not depend on the batch
    print("mesh datagen bit-equal to the no-mesh batch:",
          bool(np.array_equal(_rank(group, "datagen", 0)["irs"], want)))


def test_datagen_batch_must_divide_the_mesh(group):
    for r in range(worker.WORLD):
        res = _rank(group, "datagen_indivisible", r)
        assert str(res["raised"]) == "ValueError"
        assert "must divide" in str(res["message"])


def test_group_finished_in_time(group):
    out, status = group
    assert not status["timed_out"] and status["rcs"] == [0] * worker.WORLD, status
    assert all((out / f"done.rank{r}").exists() for r in range(worker.WORLD))
