"""ctypes bridge to the native host runtime (native/src/ipt_native.cpp), the
counterpart of the JAX package's utils/native.py: a C++ fast path for the
host-side ingest, OBJ parsing and BVH builds.

The library is compiled on first use with g++ into ``build/native/`` at the
repository root (listed in .gitignore).  Its file name carries a hash of
the source and the flags; it is written under a temporary name and moved
into place, so that processes that build at once do not race.  Every
consumer (scene/obj_loader.py load_obj, ops/bvh.py build_bvh) takes it
only when asked (use_native=True), and then takes the pure-Python path when
the library is unavailable; the tests hold the two to identical results.
Unlike the JAX bridge, a failed build keeps its error: build_error()
returns it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Optional

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_ROOT, "native", "src", "ipt_native.cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
build_seconds: Optional[float] = None  # the g++ time of this process's build, if it built

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"ipt_native_{h.hexdigest()[:16]}.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface (native/src/ipt_native.cpp extern "C")."""
    vp = ctypes.c_void_p
    lib.obj_parse.restype = vp
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [vp]
    lib.obj_counts.restype = ctypes.c_int
    lib.obj_counts.argtypes = [vp, _i32p, _i32p, _i32p, _i32p]
    lib.obj_fill.restype = ctypes.c_int
    lib.obj_fill.argtypes = [vp, _f32p, _f32p, _i32p, _i32p, _i32p]
    lib.obj_mat_name.restype = ctypes.c_char_p
    lib.obj_mat_name.argtypes = [vp, ctypes.c_int32]
    lib.obj_mtllibs.restype = ctypes.c_char_p
    lib.obj_mtllibs.argtypes = [vp]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [vp]
    lib.bvh_build.restype = vp
    lib.bvh_build.argtypes = [_f32p, ctypes.c_int32, ctypes.c_int32]
    lib.bvh_n_nodes.restype = ctypes.c_int32
    lib.bvh_n_nodes.argtypes = [vp]
    lib.bvh_fill.restype = ctypes.c_int
    lib.bvh_fill.argtypes = [vp, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p]
    lib.bvh_free.restype = None
    lib.bvh_free.argtypes = [vp]
    return lib


def _library() -> Optional[ctypes.CDLL]:
    """The bound library, built first if needed; None after a failed build
    (whose error build_error() keeps)."""
    global _lib, _error, build_seconds
    if _lib is not None:
        return _lib
    if _error is not None:
        return None
    try:
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], capture_output=True,
                                  text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed (rc={proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
            build_seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    return _lib


def native_available() -> bool:
    return _library() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _library()
    return _error


def load_obj_native(path: str):
    """Native OBJ parse -> the same ObjMesh as obj_loader.load_obj, or None
    if the library is unavailable.  A missing file raises FileNotFoundError."""
    lib = _library()
    if lib is None:
        return None
    from inverse_path_tracer_torch.scene.obj_loader import ObjMesh

    h = lib.obj_parse(path.encode())
    try:
        err = lib.obj_error(h)
        if err:
            raise FileNotFoundError(err.decode())
        nv, nn, nf, nm = (ctypes.c_int32() for _ in range(4))
        lib.obj_counts(h, nv, nn, nf, nm)
        verts = np.zeros((nv.value, 3), dtype=np.float32)
        norms = np.zeros((nn.value, 3), dtype=np.float32)
        faces = np.zeros((nf.value, 3), dtype=np.int32)
        fnorm = np.zeros((nf.value, 3), dtype=np.int32)
        fmat = np.zeros((nf.value,), dtype=np.int32)
        lib.obj_fill(h, verts.ctypes.data_as(_f32p), norms.ctypes.data_as(_f32p),
                     faces.ctypes.data_as(_i32p), fnorm.ctypes.data_as(_i32p),
                     fmat.ctypes.data_as(_i32p))
        names = [lib.obj_mat_name(h, i).decode() for i in range(nm.value)]
        raw_libs = lib.obj_mtllibs(h).decode()
        return ObjMesh(vertices=verts, normals=norms, faces=faces, face_normals_idx=fnorm,
                       material_names=[names[i] if i >= 0 else None for i in fmat],
                       mtllibs=raw_libs.split("\n") if raw_libs else [])
    finally:
        lib.obj_free(h)


def build_bvh_native(vertices: np.ndarray, leaf_size: int = 4):
    """Native BVH build over (nT, 3, 3) vertices -> dict of the SoA arrays
    (bbox_min, bbox_max, start, n_prims, right_offset, tri_order), or None."""
    lib = _library()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 9)
    n_t = v.shape[0]
    h = lib.bvh_build(v.ctypes.data_as(_f32p), n_t, leaf_size)
    try:
        m = lib.bvh_n_nodes(h)
        out = {"bbox_min": np.zeros((m, 3), dtype=np.float32),
               "bbox_max": np.zeros((m, 3), dtype=np.float32),
               "start": np.zeros((m,), dtype=np.int32),
               "n_prims": np.zeros((m,), dtype=np.int32),
               "right_offset": np.zeros((m,), dtype=np.int32),
               "tri_order": np.zeros((n_t,), dtype=np.int32)}
        lib.bvh_fill(h, *(out[k].ctypes.data_as(_f32p) for k in ("bbox_min", "bbox_max")),
                     *(out[k].ctypes.data_as(_i32p)
                       for k in ("start", "n_prims", "right_offset", "tri_order")))
        return out
    finally:
        lib.bvh_free(h)
