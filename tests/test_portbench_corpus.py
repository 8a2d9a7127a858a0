"""The port bench's corpus cell (configuration ``corpus``, traffic
``corpus_mix``, entry ``render_corpus``) on the CPU: its frozen list
against the program's; the order of its inputs (the covering combinations,
then the list in strides); the program against the plain reference on
corpus combinations; the cell through the harness at a tiny size with its
new metrics; the comparison failing a bfloat16 control and an altered
channel; the new readers; and the adapter's imports."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.entries import render_corpus
from portbench.reference.render import RAY_ORDERS
from rayverb_tpu_torch import gen

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = (1 << 33) + 25
CELL = "corpus.mix"
# six warm-up calls (the HRTF and eight-speaker pillars, the tunnel), then
# the bedroom, covering[6], in the window: a short reference
TINY = {"cut": {"rays": 256, "reflections": 8}, "pool": 8, "warmup": 6, "profile": 1,
        "check": 1}
WINDOW = 6
NEW = {"load_ms.corpus", "write_ms.corpus", "trace_bin_ms.corpus", "finalize_ms.corpus",
       "filter_params_hit_share.corpus", "sweep_table_hit_share.corpus",
       "graph_bounce_share.corpus"}


@pytest.fixture(scope="module")
def corpus():
    return harness.resolve(harness.load_spec(), CELL)["config"]


def test_frozen_list_equals_the_program(corpus):
    assert [tuple(c) for c in corpus["combos"]] == gen.COMBOS
    assert corpus["covering"] == [k for k, _ in gen.covering()]


def test_order_covering_then_strides(corpus):
    """Inputs 0-28 render the covering combinations (every config, model
    and material); the next 165 render each combination once, call i the
    list's (41 i) mod 165."""
    n, cover = len(corpus["combos"]), corpus["covering"]
    order = [render_corpus.combo_index(corpus, k) for k in range(len(cover) + 2 * n)]
    assert order[:len(cover)] == cover
    window = order[len(cover):]
    assert sorted(window[:n]) == list(range(n)) and window[n:] == window[:n]
    assert window[:3] == [0, 41, 82]
    for part in range(3):
        assert {corpus["combos"][k][part] for k in cover} == {c[part] for c in corpus["combos"]}


# an eight-speaker room, the HRTF vault, the tunnel, a silent near_l on the
# small triangle's damped walls, a medium room, the vault
AGAINST = [("oct", "random_pillars", "mat"), ("hrtf_vault_l", "vault", "vault"),
           ("near_c", "echo_tunnel", "mat"), ("near_l", "small_triangle", "damped"),
           ("medium", "medium_square", "brighter"), ("vault", "vault", "vault")]


@pytest.fixture(scope="module")
def against():
    """The cell at 512 rays x 6 reflections and its reference."""
    over = {"cut": {"rays": 512, "reflections": 6}, "pool": 0}
    cell = harness.Cell(CELL, device="cpu", impl="plain", overrides=over)
    return cell, harness.Reference(cell.parts, cell.doc, cell.dev)


@pytest.mark.parametrize("combo", AGAINST, ids=["_".join(c) for c in AGAINST])
def test_program_against_the_reference(combo, corpus, against):
    """The port's plain render through the entry within the cell's limit
    of the reference of the same combination, held to the nearer ray
    order."""
    cell, ref = against
    limit = cell.parts["checks"]["ir_rel_err"]["limit"]
    k = next(i for i in range(len(corpus["combos"]) + len(corpus["covering"]))
             if corpus["combos"][render_corpus.combo_index(corpus, i)] == list(combo))
    x = cell.inputs(SEED, k)
    assert x["combo"] == combo
    got, _ = cell.call(x)
    assert got[0].shape[0] == (8 if combo[0] == "oct" else 2)
    err = harness.compare([got], [cell.adapter.reference(ref, x, RAY_ORDERS, None)])
    assert err <= limit and err < 1e-5


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_through_the_harness(trace):
    r = harness.run_cell(CELL, SEED, 0.0, trace, device="cpu", impl="plain", overrides=TINY)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.reported(harness.load_spec(), CELL, trace)}
    assert set(r["metrics"]) <= want
    if trace:
        assert NEW | {"scene_load_s", "warmup_ir_s"} <= set(r["metrics"])
        assert all(r["metrics"][m]["value"] > 0 for m in NEW - {"graph_bounce_share.corpus",
                                                                 "filter_params_hit_share.corpus",
                                                                 "sweep_table_hit_share.corpus"})
    else:
        assert set(r["metrics"]) == {"setup_s", "ir_wall_s"}
    assert r["checks"]["ir_rel_err"]["value"] <= r["checks"]["ir_rel_err"]["limit"]


def test_control_and_an_altered_channel_fail():
    """The comparison fails the reference computed in bfloat16 in the
    program's place, and the program's first channel at 0.9, planted under
    the timed path of a whole run."""
    cell = harness.Cell(CELL, device="cpu", impl="plain", overrides=TINY)
    ref = harness.Reference(cell.parts, cell.doc, cell.dev)
    low = harness.Reference(cell.parts, cell.doc, cell.dev, dtype=torch.bfloat16)
    limit = cell.parts["checks"]["ir_rel_err"]["limit"]
    x = cell.inputs(SEED, WINDOW)
    assert x["combo"] == ("bedroom", "bedroom", "mat")
    got = [c[0] for c in cell.adapter.reference(low, x, RAY_ORDERS[-1:], None)]
    assert harness.compare([got], [cell.adapter.reference(ref, x, RAY_ORDERS, None)]) > limit

    entry = harness.function(cell.adapter.FUNCTION)

    def altered(*args, **kw):
        channels, info = entry(*args, **kw)
        channels[0] *= np.float32(0.9)
        return channels, info

    r = harness.run_cell(CELL, SEED, 0.0, False, device="cpu", impl="plain", overrides=TINY,
                         program=altered)
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["ir_rel_err"]["value"] > limit


def _counters(**c):
    return {"counters": c}


def test_cache_share_readers():
    """Pooled over the window's calls, not a per-call median (which would
    read 0 or 100); nothing without the counters."""
    stats = [_counters(**{"filter_params.hits": 1, "sweep_table.builds": 1}),
             _counters(**{"filter_params.uploads": 1, "sweep_table.hits": 1}),
             _counters(**{"filter_params.hits": 1, "sweep_table.hits": 1}),
             _counters(**{"filter_params.builds": 1, "sweep_table.builds": 1}), {}]
    assert harness.reader("filter_params_hit_share.corpus")({"stats": stats}) == 50.0
    assert harness.reader("sweep_table_hit_share.corpus")({"stats": stats}) == 50.0
    for name in ("filter_params_hit_share.corpus", "sweep_table_hit_share.corpus"):
        assert harness.reader(name)({"stats": [{}, _counters()]}) is None


def test_flat_key_readers():
    stats = [{"load": 0.002, "write": 0.001, "trace_bin": 0.3, "finalize": 0.05},
             {"load": 0.004, "write": 0.003, "trace_bin": 0.1, "finalize": 0.01},
             {"load": 0.006, "write": 0.002, "trace_bin": 0.2, "finalize": 0.03}]
    for name, key in (("load_ms.corpus", "load"), ("write_ms.corpus", "write"),
                      ("trace_bin_ms.corpus", "trace_bin"), ("finalize_ms.corpus", "finalize")):
        assert harness.reader(name)({"stats": stats}) == pytest.approx(
            1e3 * float(np.median([s[key] for s in stats])))
        # a parent's render_fused keeps no load or write
        if key in ("load", "write"):
            assert harness.reader(name)({"stats": [{"trace_bin": 0.5, "total": 0.6}]}) is None


def test_adapter_imports_neither_package_nor_jax():
    """The adapter and the reference load no module of the program, of the
    JAX package or of JAX (a fresh process, as the harness checks)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.entries.render_corpus; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rayverb_tpu', 'rayverb_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
