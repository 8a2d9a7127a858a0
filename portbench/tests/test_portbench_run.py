"""run.py as the driver starts it: no result without a card, none in a
directory that holds only the benchmark, and on the card one cell end to
end (marked ``card``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ARGS = ["--workload", "vault.render", "--seed", str((1 << 33) + 3), "--seconds", "2",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=900, env=env)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(harness.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_watchdog_stops_a_stalled_run():
    code = ("import sys, time; sys.path.insert(0, 'portbench'); import run;"
            " w = run.Watchdog(1.0); time.sleep(10)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 3 and "no progress" in out.stderr


@pytest.mark.card
def test_cell_on_the_card(card):
    out = _run(harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ir_rel_err")
