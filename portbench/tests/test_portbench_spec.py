"""BENCHMARK.json against the contract, and every name of it resolving to
its file."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert not SPEC["paths"][0].endswith("_torch")


def test_run_seconds_fit_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_bounds_and_metric_links():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reports
    for cell in cells:
        assert harness.reported(SPEC, cell, False)
        assert harness.reported(SPEC, cell, True)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    parts = harness.resolve(SPEC, cell)
    adapter = harness.entry(parts["traffic"]["entry"])
    module, _, name = adapter.FUNCTION.partition(":")
    assert module.split(".", 1)[0] == "rayverb_tpu_torch" and name
    assert parts["checks"]["ir_rel_err"]["limit"] > 0
    for m in harness.reported(SPEC, cell, False) + harness.reported(SPEC, cell, True):
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("config", [c["file"] for c in SPEC["configs"]])
def test_config_file(config):
    with open(os.path.join(ROOT, config)) as fh:
        doc = json.load(fh)
    assert doc["reduced"] == [] and doc["source"]


def test_metric_added_in_a_new_file_is_found(tmp_path):
    (tmp_path / "calls_total.py").write_text("def read(ctx):\n    return ctx['units'] * 2\n")
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"].append({"name": "calls_total", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "fused render",
                              "moves": "ir_wall_s", "workloads": ["vault.render"]})
    assert "calls_total" in {m["name"] for m in harness.reported(spec, "vault.render", True)}
    assert "calls_total" not in {m["name"] for m in harness.reported(spec, "vault.datagen", True)}
    assert harness.reader("calls_total", directory=str(tmp_path))({"units": 3}) == 6


def test_entry_and_environment_from_a_traffic_file(tmp_path, monkeypatch):
    """A new entry is an adapter file, its function a "module:function"
    string, and a traffic's ``env`` reaches the process's environment."""
    (tmp_path / "twice.py").write_text(
        "FUNCTION = 'os.path:join'\n"
        "def call(fn, cell, x, stats):\n    return [fn(x, x)], {}\n")
    adapter = harness.entry("twice", directory=str(tmp_path))
    fn = harness.function(adapter.FUNCTION)
    assert adapter.call(fn, None, "a", False) == (["a/a"], {})
    monkeypatch.delenv("PORTBENCH_TEST_KNOB", raising=False)
    harness.apply_env({"env": {"PORTBENCH_TEST_KNOB": "scan"}})
    assert os.environ["PORTBENCH_TEST_KNOB"] == "scan"
    monkeypatch.delenv("PORTBENCH_TEST_KNOB")


def test_metric_stem_serves_its_suffixes():
    for name in ("sweep_ms.render", "sweep_ms.datagen", "device_idle_pct.render",
                 "device_idle_pct.datagen", "peak_mem_gib.render", "peak_mem_gib.datagen"):
        assert callable(harness.reader(name))
    assert harness.reader("peak_mem_gib.datagen")({"peak_bytes": 2**30}) == 1.0
