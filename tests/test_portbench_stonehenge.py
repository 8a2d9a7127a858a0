"""The port bench's open-air cell and its reference with the biquad
crossovers (portbench/reference/biquad.py), on the CPU: Stonehenge through
the port and through the reference; the reference's two-pass bank against a
float64 biquad recursion; "hipass": false read as the port reads it; the
one-pass rows against reference/render.py's; and a run of each new cell at
a tiny size through the harness, with the live-row share among its
metrics."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import biquad
from portbench.reference import render as ref_render
from portbench.reference.render import RAY_ORDERS
from rayverb_tpu_torch.config.schema import parse_config
from rayverb_tpu_torch.constants import DEFAULT_HIPASS

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = (1 << 33) + 19


def test_stonehenge_port_against_the_reference():
    """stonehenge.json at 2,048 rays x 16 reflections: the port's plain
    render within the cell's limit of the biquad reference, under the
    nearer ray order, on two direction sets."""
    over = {"render": {"rays": 2048, "reflections": 16}, "pool": 2}
    cell = harness.Cell("stonehenge.render", device="cpu", impl="plain", overrides=over)
    assert cell.doc["filter"] == "twopass" and cell.doc["hipass"] is False
    assert cell.cfg.hipass == DEFAULT_HIPASS
    ref = harness.Reference(cell.parts, cell.doc, cell.dev)
    limit = cell.parts["checks"]["ir_rel_err"]["limit"]
    for index in range(2):
        x = cell.inputs(SEED, index)
        got, _ = cell.call(x)
        assert got[0].shape[0] == 2 and got[0].shape[1] > 1000
        err = harness.compare([got], [cell.adapter.reference(ref, x, RAY_ORDERS, None)])
        assert err <= limit and err < 1e-5


def _recursion(x, c, reverse):
    """Direct form II transposed in float64 over x (8, n), one band per row."""
    b0, b1, b2, a1, a2 = (c[:, k] for k in range(5))
    y = np.zeros_like(x)
    z1 = np.zeros(x.shape[0])
    z2 = np.zeros(x.shape[0])
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for i in steps:
        y[:, i] = b0 * x[:, i] + z1
        z1 = b1 * x[:, i] + z2 - a1 * y[:, i]
        z2 = b2 * x[:, i] - a2 * y[:, i]
    return y


@pytest.mark.parametrize("sr", [44100.0, 16000.0])
def test_twopass_bank_against_a_float64_recursion(sr):
    """reference/render.py's frequency-domain filter with biquad.py's
    two-pass passes equals the band-pass recursion run forward and then
    reversed from the content's end, in float64, bands summed."""
    rng = np.random.default_rng(7)
    length, content = 3000, 2400
    x = np.zeros((1, 1, 8, length))
    x[..., :content] = rng.standard_normal((8, content)) * (rng.random((8, content)) < 0.05)
    passes = biquad.filter_passes("twopass", sr, DEFAULT_HIPASS)
    got = ref_render._filter(torch.from_numpy(x), torch.tensor([content]), passes,
                             torch.float32)[0, 0].numpy()
    rows = biquad.bandpass_rows(sr, DEFAULT_HIPASS)
    y = _recursion(x[0, 0, :, :content], rows, reverse=False)
    y = _recursion(y, rows, reverse=True)
    want = np.zeros(length)
    want[:content] = y.sum(axis=0)
    assert np.array_equal(passes[0][0], passes[1][0])
    assert [rev for _, rev in passes] == [False, True]
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_hipass_false_keeps_the_ports_default_cutoff():
    doc = json.loads((REPO / "assets" / "configs" / "stonehenge.json").read_text())
    assert doc["hipass"] is False
    cfg = parse_config(json.dumps(doc))
    assert biquad.hipass(doc) == cfg.hipass == DEFAULT_HIPASS == 45.0
    sixty = {**doc, "hipass": 60}
    assert biquad.hipass(sixty) == parse_config(json.dumps(sixty)).hipass == 60.0
    assert biquad.hipass({k: v for k, v in doc.items() if k != "hipass"}) == DEFAULT_HIPASS
    rows = biquad.filter_passes("twopass", 44100.0, biquad.hipass(doc))[0][0]
    assert np.array_equal(rows, biquad.bandpass_rows(44100.0, 45.0))


@pytest.mark.parametrize("sr, lo", [(44100.0, 45.0), (44100.0, 60.0), (16000.0, 45.0)])
def test_onepass_rows_equal_render_pys(sr, lo):
    (mine, rev), = biquad.filter_passes("onepass", sr, lo)
    (theirs, rev2), = ref_render.filter_passes("onepass", sr, lo)
    assert rev is rev2 is False
    np.testing.assert_allclose(mine, theirs, rtol=1e-15, atol=0)
    with pytest.raises(ValueError, match="no filter"):
        biquad.filter_passes("linkwitz_riley", sr, lo)


TINY = {
    "stonehenge.render": {"render": {"rays": 256, "reflections": 8}, "pool": 2, "profile": 1},
    "vault.hrtf": {"render": {"rays": 256, "reflections": 12}, "pool": 2, "profile": 1},
}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_new_cells_run_through_the_harness(cell, trace):
    r = harness.run_cell(cell, SEED, 0.0, trace, device="cpu", impl="plain",
                         overrides=TINY[cell])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.reported(harness.load_spec(), cell, trace)}
    assert set(r["metrics"]) <= want
    if trace:
        share = r["metrics"]["live_row_share.render"]["value"]
        assert 0 < share < 60 if cell == "stonehenge.render" else share > 99
    else:
        assert set(r["metrics"]) == {"setup_s", "ir_wall_s"}
    assert r["checks"]["ir_rel_err"]["value"] <= r["checks"]["ir_rel_err"]["limit"]


def test_biquad_reference_imports_neither_package_nor_jax():
    """The reference and the new adapter load no module of the program, of
    the JAX package or of JAX (a fresh process, as the harness checks)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.biquad, portbench.entries.render_fused_biquad; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rayverb_tpu', 'rayverb_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
