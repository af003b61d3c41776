"""Native (C++) host code of the port, loaded through ctypes: the marching
tetrahedra extractor (mc_native.cpp, the port's copy of
holoscene_tpu/native/mc_native.cpp).

`g++ -O3 -shared -fPIC` builds the library on first use, and again
whenever the source is newer, into holoscene_tpu_torch/build/ (next to the
CUDA kernels' library). A failed build raises: there is no fallback to the
numpy extractor. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("mc_native.cpp")
BUILD = Path(__file__).resolve().parents[1] / "build"
LIB = BUILD / "libmc_native.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build() -> None:
    """Compile SRC into LIB when missing or stale (one process may race
    another: each writes its own file and renames it into place)."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"g++ not runnable ({exc}): the native marching "
                           "tetrahedra are built from source on first use"
                           ) from exc
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({done.returncode}): {' '.join(cmd)}"
                           f"\n{done.stdout}\n{done.stderr}")
    os.replace(tmp, LIB)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded extractor (built first if needed)."""
    build()
    lib = ctypes.CDLL(str(LIB))
    lib.mc_run.restype = ctypes.c_int64
    lib.mc_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.mc_copy.restype = None
    lib.mc_copy.argtypes = [ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_int64)]
    lib.mc_free.restype = None
    lib.mc_free.argtypes = []
    return lib


def marching_tetrahedra_native(sdf: np.ndarray, level: float = 0.0):
    """Isosurface of a dense [X, Y, Z] grid: (verts [V, 3] float64 in grid
    coordinates, faces [F, 3] int64), unoriented (the caller orients)."""
    lib = library()
    sdf_f = np.ascontiguousarray(sdf, dtype=np.float32)
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    lib.mc_run(sdf_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               *sdf_f.shape, float(level), ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), dtype=np.float64)
    faces = np.empty((nf.value, 3), dtype=np.int64)
    lib.mc_copy(verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    lib.mc_free()
    return verts, faces
