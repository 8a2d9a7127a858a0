"""The port's native C++ OBJ parser (rayverb_tpu_torch/native) against its
pure-Python reader and the JAX package's, bit for bit (the counterparts of
tests/test_native.py). It builds with g++ into rayverb_tpu_torch/_build/."""

import glob
import os

import numpy as np
import pytest

from rayverb_tpu.scene.objloader import load_obj_python as jax_load_obj_python
from rayverb_tpu_torch import cuda_build
from rayverb_tpu_torch.native import get_lib, load_obj_native
from rayverb_tpu_torch.scene import objloader
from rayverb_tpu_torch.scene.objloader import load_obj_python


@pytest.fixture(scope="module")
def lib():
    lib = get_lib()
    assert lib is not None, "the native OBJ parser did not build (g++)"
    return lib


def test_built_from_the_ports_source_into_build_dir(lib):
    path = cuda_build.build_info["objparse"]["path"]
    assert lib._name == path
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("objparse-")
    here = os.path.dirname(os.path.abspath(objloader.__file__))
    assert os.path.isfile(os.path.join(os.path.dirname(here), "native", "objparse.cpp"))


def test_equivalent_on_demo_corpus(assets_dir, lib):
    paths = sorted(glob.glob(str(assets_dir / "test_models" / "*.obj")))
    assert paths
    for path in paths:
        nat = load_obj_native(path)
        for ref in (load_obj_python(path), jax_load_obj_python(path)):
            assert nat.vertices.dtype == ref.vertices.dtype == np.float32
            assert nat.faces.dtype == ref.faces.dtype == np.int64
            assert nat.vertices.tobytes() == ref.vertices.tobytes(), path
            assert nat.faces.tobytes() == ref.faces.tobytes(), path
            assert nat.face_materials == ref.face_materials, path


def test_negative_indices(tmp_path, lib):
    p = tmp_path / "neg.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl m1\n"
        "f -4 -3 -2 -1\n"
    )
    py = load_obj_python(str(p))
    nat = load_obj_native(str(p))
    np.testing.assert_array_equal(nat.faces, py.faces)
    np.testing.assert_array_equal(nat.faces, [[0, 1, 2], [0, 2, 3]])
    assert nat.face_materials == py.face_materials == ["m1", "m1"]


def test_error_cases(tmp_path, lib):
    with pytest.raises(FileNotFoundError):
        load_obj_native(str(tmp_path / "missing.obj"))
    p = tmp_path / "empty.obj"
    p.write_text("# nothing\n")
    with pytest.raises(ValueError):
        load_obj_native(str(p))


def test_load_obj_prefers_native_unless_no_native(assets_dir, monkeypatch, lib):
    path = str(assets_dir / "test_models" / "large_square.obj")
    calls = []
    real = objloader.load_obj_python
    monkeypatch.setattr(objloader, "load_obj_python",
                        lambda p: calls.append(p) or real(p))
    assert objloader.load_obj(path).num_triangles == 12
    assert calls == []
    monkeypatch.setenv("RAYVERB_NO_NATIVE", "1")
    assert objloader.load_obj(path).num_triangles == 12
    assert calls == [path]
