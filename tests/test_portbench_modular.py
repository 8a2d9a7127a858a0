"""The port bench's modular cell and its plain reference
(portbench/reference/modular.py), on the CPU: the port's modular render
against the reference; the reference's Linkwitz-Riley bank sample by sample
against its frequency response; the per-arrival predelay against the whole-bin
shift of reference/render.py, where the two must differ; the cell through
the harness at a tiny size with its new metrics; the readers of those
metrics; and the reference's imports."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.devtrace import DeviceTrace
from portbench.reference import modular
from portbench.reference import render as ref_render
from portbench.reference.render import RAY_ORDERS
from rayverb_tpu_torch.ops.histogram import flatten_channels
from rayverb_tpu_torch.ops.postprocess import find_predelay, fix_predelay

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = (1 << 33) + 23
CELL = "vault.modular"
STAGE_METRICS = {"trace_ms.modular", "population_ms.modular", "post_ms.modular",
                 "process_ms.modular"}
TINY = {"render": {"rays": 256, "reflections": 12}, "pool": 2, "profile": 1}


def test_modular_port_against_the_reference():
    """vault.json through the modular pipeline at 2,048 rays x 16
    reflections: the port's plain render within the cell's limit of the
    modular reference, under the nearer ray order, on two direction sets."""
    over = {"render": {"rays": 2048, "reflections": 16}, "pool": 2}
    cell = harness.Cell(CELL, device="cpu", impl="plain", overrides=over)
    assert cell.doc["filter"] == "linkwitz_riley" and cell.doc["trim_predelay"]
    ref = harness.Reference(cell.parts, cell.doc, cell.dev)
    limit = cell.parts["checks"]["ir_rel_err"]["limit"]
    for index in range(2):
        x = cell.inputs(SEED, index)
        got, _ = cell.call(x)
        assert got[0].shape[0] == 2 and got[0].shape[1] > 10000
        err = harness.compare([got], [cell.adapter.reference(ref, x, RAY_ORDERS, None)])
        assert err <= limit and err < 1e-4


@pytest.mark.parametrize("sr", [44100.0, 16000.0])
def test_linkwitz_riley_recurrence_against_frequency_response(sr):
    """The bank's four passes (low-pass forward and reversed, high-pass
    forward and reversed, per band) as the float64 recurrence equal their
    frequency responses on reference/render.py's FFT grid, bands summed."""
    rng = np.random.default_rng(11)
    length = 3000
    x = rng.standard_normal((2, 8, length)) * (rng.random((2, 8, length)) < 0.05)
    doc = {"filter": "linkwitz_riley", "hipass": 60}
    passes = modular.filter_passes(doc, sr)
    assert [rev for _, rev in passes] == [False, True, False, True]
    assert np.array_equal(passes[0][0], passes[1][0])
    assert np.array_equal(passes[2][0], passes[3][0])
    got = ref_render._filter(torch.from_numpy(x)[None], torch.tensor([length]), passes,
                             torch.float32)[0].numpy()
    want = modular.recurrence(x, passes).sum(axis=-2)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_per_arrival_predelay_against_whole_bin_shift():
    """Arrivals at 10.4, 10.8 and 20.3 samples: the modular pipeline
    subtracts the predelay from each arrival before binning (0.4 lands in
    sample 0), where a whole-bin shift moves sample 11 to 1; its length is
    the last arrival's bin + 1. The port and the reference agree."""
    sr = 8000.0
    times = torch.tensor([[0.0, 10.4, 10.8, 20.3]], dtype=torch.float32) / np.float32(sr)
    vols = torch.zeros((1, 4, 8))
    vols[0, 1:] = torch.tensor([1.0, 2.0, 4.0])[:, None]
    shifted, pre = modular.fix_predelay(times)
    assert pre == float(times[0, 1]) and pre == find_predelay(times)
    assert torch.equal(shifted, fix_predelay(times, pre))
    hist = modular.histogram(vols, shifted, sr)
    assert hist.shape == (1, 8, 11)
    assert hist[0, 0, 0] == 1.0 + 2.0 and hist[0, 0, 10] == 4.0
    assert torch.equal(hist, flatten_channels(vols, shifted, sr))
    whole = (torch.floor(times * np.float32(sr) + 0.5)
             - torch.floor(times[0, 1] * np.float32(sr) + 0.5)).to(torch.int64)
    assert whole[0, 1:].tolist() == [0, 1, 10]
    assert torch.floor(shifted * np.float32(sr) + 0.5).to(torch.int64)[0, 1:].tolist() == [0, 0, 10]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_through_the_harness(trace):
    r = harness.run_cell(CELL, SEED, 0.0, trace, device="cpu", impl="plain", overrides=TINY)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.reported(harness.load_spec(), CELL, trace)}
    assert set(r["metrics"]) <= want
    if trace:
        assert STAGE_METRICS | {"graph_bounce_share.modular", "scene_load_s",
                                "warmup_ir_s"} <= set(r["metrics"])
        assert all(r["metrics"][m]["value"] > 0 for m in STAGE_METRICS)
    else:
        assert set(r["metrics"]) == {"setup_s", "ir_wall_s"}
    assert r["checks"]["ir_rel_err"]["value"] <= r["checks"]["ir_rel_err"]["limit"]


def test_control_and_an_altered_channel_fail():
    """The comparison fails what it must at a tiny size: the reference
    computed in bfloat16 in the program's place, and the program's first
    channel at 0.9, planted under the timed path of a whole run."""
    cell = harness.Cell(CELL, device="cpu", impl="plain", overrides=TINY)
    ref = harness.Reference(cell.parts, cell.doc, cell.dev)
    low = harness.Reference(cell.parts, cell.doc, cell.dev, dtype=torch.bfloat16)
    limit = cell.parts["checks"]["ir_rel_err"]["limit"]
    x = cell.inputs(SEED, 0)
    got = [c[0] for c in cell.adapter.reference(low, x, RAY_ORDERS[-1:], None)]
    assert harness.compare([got], [cell.adapter.reference(ref, x, RAY_ORDERS, None)]) > limit

    entry = harness.function(cell.adapter.FUNCTION)

    def altered(*args, **kw):
        result = entry(*args, **kw)
        result.channels[0] *= np.float32(0.9)
        return result

    r = harness.run_cell(CELL, SEED, 0.0, False, device="cpu", impl="plain",
                         overrides=TINY, program=altered)
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["ir_rel_err"]["value"] > limit


def _profile(us):
    ops = [("void biquad_scan<true>(float const*, float*)", 0.0, us)] if us else []
    return DeviceTrace(ops + [("closest_hit_sweep", 0.0, 10.0)], [], 1.0, 2)


@pytest.mark.parametrize("stats, us, want", [
    ([{"counters": {"biquad.series_samples": n}} for n in (3, 4, 5)], 200.0,
     100.0 * 8 * 4 / 3.35e12 / 100e-6),
    ([{"counters": {}}], 200.0, None),
    ([{"counters": {"biquad.series_samples": 4}}], 0.0, None),
    ([], 200.0, None),
], ids=["program", "no_counter", "no_kernel", "untraced"])
def test_biquad_readers(stats, us, want):
    """biquad_roofline.modular: the counter's median x 8 B over the HBM
    bandwidth, over the kernel's device time per profiled call, in percent;
    biquad_ms.modular that time; nothing without the counter or the
    kernel."""
    ctx = {"stats": stats, "profile": _profile(us), "device_kind": "NVIDIA H100 80GB HBM3"}
    got = harness.reader("biquad_roofline.modular")(ctx)
    assert got == (None if want is None else pytest.approx(want))
    ms = harness.reader("biquad_ms.modular")(ctx)
    assert ms == (pytest.approx(us / 2 / 1e3) if us else None)


def test_stage_readers():
    stats = [{"trace": 0.5, "population": 0.01, "post": 0.02, "process": 0.03}, {}]
    for name, key in zip(sorted(STAGE_METRICS), ("population", "post", "process", "trace")):
        assert harness.reader(name)({"stats": stats}) == pytest.approx(1e3 * stats[0][key])
        # a render_fused call keeps none of these keys
        assert harness.reader(name)({"stats": [{"trace_bin": 0.5, "total": 0.6}]}) is None


def test_modular_reference_imports_neither_package_nor_jax():
    """The reference and the adapter load no module of the program, of the
    JAX package or of JAX (a fresh process, as the harness checks)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.modular, portbench.entries.render_modular; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rayverb_tpu', 'rayverb_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
