"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, its device helper never drops to the CPU by itself, and
chip_smoke.py compiles and refuses to run without a GPU."""

import ast
import pathlib
import py_compile
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "rayverb_tpu_torch"
# the entry points of the corpus and the correctness tools
TOOLS = ("gen", "corpus_check", "kernel_parity", "health", "probe", "convolve")


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_sharded_worker.py"]
    assert len(files) > 15
    return files


def test_scan_covers_the_multi_rank_modules():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    assert {"rayverb_tpu_torch/parallel/sharded.py", "rayverb_tpu_torch/native/__init__.py",
            "tests/torch_sharded_worker.py"} <= names


def test_scan_covers_the_tools():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    assert {f"rayverb_tpu_torch/{m}.py" for m in TOOLS} <= names


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "rayverb_tpu"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    sample = tmp_path / "sample.py"
    sample.write_text(
        "import jax.numpy as jnp\nfrom rayverb_tpu.ops import trace\n"
        "import rayverb_tpu_torch\nfrom . import x\n"
    )
    found = [m for m in _imported_modules(sample) if _forbidden(m)]
    assert found == ["jax.numpy", "rayverb_tpu.ops"]


def test_port_imports_in_a_fresh_interpreter_without_jax():
    code = (
        "import sys\n"
        "import rayverb_tpu_torch, rayverb_tpu_torch.cli, rayverb_tpu_torch.params\n"
        "import rayverb_tpu_torch.ops.render, rayverb_tpu_torch.ops.intersect_cuda\n"
        "import rayverb_tpu_torch.parallel.sharded, rayverb_tpu_torch.native\n"
        + "".join(f"import rayverb_tpu_torch.{m}\n" for m in TOOLS) +
        "sys.path.insert(0, 'tests')\n"
        "import torch_sharded_worker\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rayverb_tpu', 'triton')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_device_helper_raises_without_cuda():
    from rayverb_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_compiles(tmp_path):
    py_compile.compile(str(REPO / "chip_smoke.py"), cfile=str(tmp_path / "c.pyc"), doraise=True)


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    """Without a GPU (and alone in a directory) the script exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
