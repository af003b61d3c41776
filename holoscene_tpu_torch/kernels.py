"""Build and load the hand-written CUDA kernels of csrc/.

`nvcc` compiles every csrc/*.cu (one process per source, all started
together) and links them into one shared library with a plain C interface
(build/libholoscene_kernels.so), loaded with ctypes: no PyTorch headers, so
a cold build takes seconds. The build happens on first use and again
whenever a source is newer than the library. Importing this module
builds nothing (the tests on machines without nvcc import every module).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB = BUILD / "libholoscene_kernels.so"
# -fmad=false: no multiply-add contraction, so every per-candidate alpha is
# rounded exactly as PyTorch's elementwise ops round it in the plain
# versions; with contraction a candidate sitting at the 1/255 cut flips
# between kernel and plain, moving the total log(1-alpha) by 3.9e-3.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (argtypes) — each returns cudaGetLastError() as int
_SIGNATURES = {
    # cand, cs, cc, out, n_tiles, tiles_x, tile_size, img_w, img_h, stream
    "splat_flat_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cand, cs, fwd, v, dcand, n_tiles, tiles_x, tile_size, img_w, img_h,
    # stream
    "splat_flat_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cand, origins, counts, out, used, n_tiles, k_total, tile_size, img_w,
    # img_h, stream
    "splat_topk_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cand, origins, used, fwd, v, dcand, n_tiles, k_total, tile_size,
    # img_w, img_h, stream
    "splat_topk_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x01, emb_a, emb_b, scales, ints, feats_a, J, feats_b, n, n_levels,
    # interp (0 trilinear, 1 tetrahedral), fetch_raw, stream
    "hash_fused_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x01, ct_fa, ct_J, ct_fb, u_b, u_a, scales, ints, acc (the int64 work
    # buffer), grad_a, grad_b, n, n_rows, n_levels, mode, interp, stream
    "hash_fused_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _P),
    # x01, emb, scales, ints, out, n, n_levels, packed, interp, stream
    "hash_sampler_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # rays_o, rays_d, g13, spheres, n_rays, n_gauss, k, min_kernel,
    # min_alpha, near, degree, idx, count, stream
    "gs_trace_select": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P, _P,
                        _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from csrc/ on first use")


def build(force: bool = False) -> dict:
    """Compile csrc/*.cu into LIB when missing or stale. Returns
    {"seconds": build wall time (0.0 when up to date), "log": nvcc's
    -Xptxas -v report (registers, shared memory, spills)}."""
    sources = sorted(CSRC.glob("*.cu"))
    deps = sources + sorted(CSRC.glob("*.cuh"))
    if (not force and LIB.exists() and LIB.stat().st_mtime
            >= max(p.stat().st_mtime for p in deps)):
        return {"seconds": 0.0, "log": ""}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objects = [BUILD / f"{src.stem}.{tag}.o" for src in sources]
    tmp = LIB.with_name(f"{LIB.name}.{tag}")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({done.returncode}): "
                               f"{' '.join(link)}\n{done.stdout}\n"
                               f"{done.stderr}")
        os.replace(tmp, LIB)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return {"seconds": time.perf_counter() - t0, "log": "".join(logs)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes and
    restype declared for every entry point."""
    build()
    lib = ctypes.CDLL(str(LIB))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")
