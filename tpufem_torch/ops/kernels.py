"""Build and load the hand-written CUDA kernels (``tpufem_torch/csrc/*.cu``).

The sources are compiled with nvcc for Hopper (``sm_90a``), one nvcc process
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes. The build happens at first use, into
``build/`` at the repository root (listed in .gitignore), and the library's
file name carries a hash of the sources, so an edited source is never served
a stale binary. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.

Each C entry point launches on the stream it is given, allocates nothing, and
returns ``cudaGetLastError()``; ``check`` turns a nonzero status into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # (msgs, seg, out, E, C, num_segments, stream)
    "tpufem_sorted_segment_sum_f32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_int, _P],
    # (g, seg, out, E, C, num_segments, stream)
    "tpufem_segment_gather_f32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_int, _P],
    # (g, vol, us, y, B, NI, NK, NJ, lam, mu, stream)
    "tpufem_strain_apply_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_double, ctypes.c_double, _P],
    "tpufem_strain_apply_f64": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_double, ctypes.c_double, _P],
    # (grads, vols, tets, u, fe, T, lam, mu, stream)
    "tpufem_tet4_force_f32": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_double,
                              ctypes.c_double, _P],
    "tpufem_tet4_force_f64": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_double,
                              ctypes.c_double, _P],
    # (vals, order, starts, out, N, C, stream)
    "tpufem_csr_segment_sum_f32": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
    "tpufem_csr_segment_sum_f64": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
}

# what the last build printed (ptxas register/spill report) and how long it took
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


@lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on any failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libtpufem_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]

        def compile_one(src: Path, obj: Path):
            return subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  capture_output=True, text=True)

        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            procs = list(pool.map(compile_one, sources, objs))
        for src, proc in zip(sources, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                                   f"{proc.stderr}")
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file
        build_info["log"] = "".join(p.stderr for p in procs)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["path"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (refused launch, bad config)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
