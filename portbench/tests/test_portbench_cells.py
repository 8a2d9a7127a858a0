"""Each cell's loop at a tiny size on the CPU, with the plain sweep: the
result line's keys, the metrics each run reports, and the reference's
agreement with the program."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.reference.render import RAY_ORDERS

from .tiny import SEED, TINY, run

CELLS = sorted(TINY)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    r = run(cell, trace)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[5:] == (["breakdown", "checks"] if trace else ["checks"])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.reported(harness.load_spec(), cell, trace)}
    # device-trace readers find nothing on the CPU and leave their metric out
    assert set(r["metrics"]) <= want
    host = {"setup_s", "ir_wall_s", "pairs_per_s", "scene_load_s", "warmup_ir_s",
            "trace_bin_ms.render", "finalize_ms.render", "dg_trace_ms.datagen",
            "dg_bin_ms.datagen"}
    assert want & host <= set(r["metrics"])
    for name, m in r["metrics"].items():
        assert m["value"] > 0, name
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    c = r["checks"]["ir_rel_err"]
    assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_program(cell):
    cell_ = harness.Cell(cell, device="cpu", impl="plain", overrides=TINY[cell])
    ref = harness.Reference(cell_.parts, cell_.doc, cell_.dev)
    for index in range(2):
        x = cell_.inputs(SEED, index)
        got, _ = cell_.call(x)
        err = harness.compare([got], [cell_.adapter.reference(ref, x, RAY_ORDERS, None)])
        assert err < 1e-5


def test_reference_follows_the_morton_ray_order():
    """At 2,048 rays and more the program traces rays in the Morton order of
    their directions, which decides the record an image chain keeps: its
    response is the reference's under that order."""
    over = {"render": {"rays": 2048, "reflections": 3}, "pool": 1}
    cell = harness.Cell("vault.render", device="cpu", impl="plain", overrides=over)
    ref = harness.Reference(cell.parts, cell.doc, cell.dev)
    x = cell.inputs(SEED, 0)
    got, _ = cell.call(x)
    assert harness.compare([got], [cell.adapter.reference(ref, x, ("morton",), None)]) < 1e-5


def test_compare_takes_the_nearest_ray_order():
    a, b = np.ones((2, 10)), np.full((2, 10), 2.0)
    assert harness.compare([[a]], [[[b, a]]]) == 0.0
    assert harness.compare([[a]], [[[b]]]) == pytest.approx(0.5)
    # every response of a call counts, each against its own orders
    assert harness.compare([[a, a]], [[[a], [b, b]]]) == pytest.approx(0.5)


def test_no_input_is_used_twice():
    """The window and the warm-up take fresh inputs; past the pool made in
    set-up, each is made when it is due."""
    from portbench.entries import render_fused as adapter

    seen = []
    fn = harness.function(adapter.FUNCTION)

    def program(scene, cfg, x, **kw):
        seen.append(x.tobytes())
        return fn(scene, cfg, x, **kw)

    run("vault.render", True, program=program, overrides={"warmup": 2, "pool": 2})
    assert len(seen) == 2 + 1 + TINY["vault.render"]["profile"]
    assert len(set(seen)) == len(seen)


def test_relative_error_of_silent_pairs():
    z = np.zeros((2, 10))
    assert harness.relative_error(z, z) == 0.0
    assert harness.relative_error(z + 1e-3, z) == float("inf")
    a = np.ones((2, 10))
    assert harness.relative_error(a[:, :8], a) == pytest.approx(np.sqrt(4 / 20))


def test_reservoir_is_drawn_from_the_seed():
    picks = []
    for _ in range(2):
        res = harness._Reservoir(1, SEED)
        for i in range(50):
            res.offer(i, i)
        picks.append(res.kept[0][0])
    assert picks[0] == picks[1]


def test_calibrate_prints_program_and_control_readings(capsys):
    from portbench import calibrate

    calibrate.main(["--workload", "vault.datagen", "--seeds", "2", "--control", "1",
                    "--device", "cpu", "--overrides", json.dumps(TINY["vault.datagen"])])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kind"] for r in rows] == ["program", "control", "program"]
    limit = harness.resolve(harness.load_spec(), "vault.datagen")["checks"]["ir_rel_err"]["limit"]
    assert rows[0]["ir_rel_err"] < limit < rows[1]["ir_rel_err"]
