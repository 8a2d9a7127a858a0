"""The native (C++) OBJ parser and its ctypes binding (the PyTorch port's
counterpart of rayverb_tpu/native/__init__.py).

``objparse.cpp`` is the port's own copy of the JAX package's parser. It is
built with g++ at first use into ``_build/`` (cuda_build.load_host_library:
keyed by the SHA-256 of the source and the compile command, under a
timeout), never next to the source. The pure-Python reader
(scene/objloader.py::load_obj_python) defines the semantics; this one makes
large scenes fast. A failed build is printed to stderr once and the loader
falls back to Python.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "objparse.cpp")

_lock = threading.Lock()
_state = {"lib": None, "failed": False}


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("nvertices", ctypes.c_longlong),
        ("faces", ctypes.POINTER(ctypes.c_longlong)),
        ("face_material", ctypes.POINTER(ctypes.c_int)),
        ("nfaces", ctypes.c_longlong),
        ("material_names", ctypes.POINTER(ctypes.c_char)),
        ("names_bytes", ctypes.c_longlong),
        ("nmaterials", ctypes.c_int),
        ("error", ctypes.c_char * 256),
    ]


def get_lib():
    """The native library, built at first use; None when it cannot be built
    or loaded (the failure is printed to stderr once)."""
    from ..cuda_build import load_host_library

    with _lock:
        if _state["lib"] is not None or _state["failed"]:
            return _state["lib"]
        try:
            lib = load_host_library("objparse", [_SOURCE])
        except (RuntimeError, OSError) as e:
            print(f"rayverb_tpu_torch: native OBJ parser unavailable ({e}); "
                  "using the Python reader", file=sys.stderr)
            _state["failed"] = True
            return None
        lib.rayverb_load_obj.restype = ctypes.POINTER(_ObjMesh)
        lib.rayverb_load_obj.argtypes = [ctypes.c_char_p]
        lib.rayverb_free_obj.restype = None
        lib.rayverb_free_obj.argtypes = [ctypes.POINTER(_ObjMesh)]
        _state["lib"] = lib
        return lib


def load_obj_native(path: str):
    """Parse an OBJ with the native parser. Returns a scene.objloader.RawMesh,
    or None when the library is unavailable. Raises FileNotFoundError and
    ValueError as the Python reader does."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.rayverb_load_obj(os.fsencode(path))
    if not handle:
        raise MemoryError("native OBJ parser allocation failed")
    try:
        mesh = handle.contents
        err = bytes(mesh.error).split(b"\0", 1)[0].decode()
        if err:
            if "cannot open" in err:
                raise FileNotFoundError(f"{path}: {err}")
            raise ValueError(f"OBJ file {path!r}: {err}")
        nv = int(mesh.nvertices)
        nf = int(mesh.nfaces)
        vertices = np.ctypeslib.as_array(mesh.vertices, shape=(nv, 3)).copy()
        faces = np.ctypeslib.as_array(mesh.faces, shape=(nf, 3)).copy()
        mats = np.ctypeslib.as_array(mesh.face_material, shape=(nf,)).copy()
        blob = ctypes.string_at(mesh.material_names, mesh.names_bytes)
        # the Python reader's lenient decoding (errors="replace")
        names = blob.decode(errors="replace").split("\0")[: mesh.nmaterials]
        face_materials = ["" if m < 0 else names[m] for m in mats]
    finally:
        lib.rayverb_free_obj(handle)

    from ..scene.objloader import RawMesh

    return RawMesh(
        vertices=vertices.astype(np.float32),
        faces=faces.astype(np.int64),
        face_materials=face_materials,
    )
