"""Build and load the hand-written CUDA kernels (``tpufem_torch/csrc/*.cu``).

The sources are compiled with nvcc for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ctypes. The build happens at
first use, into ``build/`` at the repository root (listed in .gitignore), and
the library's file name carries a hash of the sources, so an edited source is
never served a stale binary. Nothing here runs at import time: the CPU tests
import every module on a machine without nvcc.

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
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file
        build_info["log"] = proc.stderr
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
