"""The import boundary: a rehearsal of each cell loads neither JAX nor the
JAX package (top-level module names compared whole: rayverb_tpu_torch is
the port), and the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

from .tiny import TINY

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_rehearsal_loads_no_jax(cell):
    code = (
        "import json, sys\n"
        "from portbench.tests.tiny import run\n"
        "from portbench import harness\n"
        f"r = run({cell!r})\n"
        "assert r['correct'], r\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True, timeout=600)
    tops = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "rayverb_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "rayverb_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rayverb_tpu_torch.extra", sys)
    assert "rayverb_tpu" not in sys.modules
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".", 1)[0] not in ("rayverb_tpu_torch", "rayverb_tpu", "jax")
    code = (
        "import sys, numpy as np, torch\n"
        "from portbench.reference import render, scene\n"
        "from portbench import inputs\n"
        "s = render.Scene(scene.load('assets/test_models/vault.obj',"
        " 'assets/materials/vault.json'), torch.float32, 'cpu')\n"
        "doc = inputs.load_json('portbench/traffic/vault_speakers.json')['render']\n"
        "doc['reflections'] = 3\n"
        "one = lambda k: np.asarray([doc[k]], np.float32)\n"
        "dirs = inputs.directions(1, 64, inputs.unit_seed(1, 0), 'cpu')\n"
        "out = render.render(s, doc, one('source_position'), one('mic_position'), dirs)\n"
        "assert len(out) == len(render.RAY_ORDERS) and out[0].shape[1] == 2\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    assert "rayverb_tpu_torch" not in out.stdout
