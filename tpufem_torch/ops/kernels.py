"""Build and load the hand-written CUDA kernels (``tpufem_torch/csrc/*.cu``).

The sources are compiled with nvcc for Hopper (``sm_90a``), one nvcc process
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes. The build happens at first use, into
``build/`` at the repository root (listed in .gitignore), and the library's
file name carries a hash of the sources and their headers (``*.cuh``), so an
edited source is never served a stale binary. Nothing here runs at import time: the CPU tests import every
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # (seg, rowptr, E, num_segments, stream)
    "tpufem_segment_rowptr_i32": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    # (msgs, rowptr, out, E, C, num_segments, stream)
    "tpufem_sorted_segment_sum_f32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_int, _P],
    # (x, idx, w, rowdiv, rowptr, out, deg_out, x_rows, C, num_segments, normalize, stream)
    "tpufem_gather_row_sum_f32": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    # (g, seg, out, E, C, num_segments, stream)
    "tpufem_segment_gather_f32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_int, _P],
    # (g, vol, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream)
    "tpufem_strain_apply_f32": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, _P],
    "tpufem_strain_apply_f64": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, _P],
    # (grads, vols, tets, pos, btet, bt_start, bnode, starts, x, free or null, y, n_blocks,
    #  slots, lam, mu, stream)
    "tpufem_stiffness_apply_f32": [_P] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                               ctypes.c_double, _P],
    "tpufem_stiffness_apply_f64": [_P] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                               ctypes.c_double, _P],
    # (g, u, sig, B, NI, NK, NJ, weld_te, lam, mu, stream)
    "tpufem_element_stress_f32": [_P, _P, _P] + [ctypes.c_int] * 5 + [ctypes.c_double,
                                                                      ctypes.c_double, _P],
    "tpufem_element_stress_f64": [_P, _P, _P] + [ctypes.c_int] * 5 + [ctypes.c_double,
                                                                      ctypes.c_double, _P],
    # (g, vol, sig, u, free, y, B, NI, NK, NJ, weld_te, stream)
    "tpufem_geom_apply_f32": [_P] * 6 + [ctypes.c_int] * 5 + [_P],
    "tpufem_geom_apply_f64": [_P] * 6 + [ctypes.c_int] * 5 + [_P],
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


def build_library(csrc: Path) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of the sources in
    `csrc`; raises on any failure. The port's own library is load_kernels();
    the profilers' --compare builds another commit's csrc/ beside it."""
    csrc = Path(csrc)
    sources = sorted(csrc.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(csrc.glob("*.cu*")):  # the sources and the headers they include
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


@lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the port's kernel library; raises on any
    failure."""
    return build_library(CSRC)


def compare_libraries(specs) -> dict:
    """{label: library} for the profilers' --compare LABEL=DIR arguments:
    each DIR a csrc/ of another commit or variant (e.g. unpacked with `git
    archive <rev> tpufem_torch/csrc`), built with build_library. Measuring
    aids only: no entry point of the port loads them."""
    out = {}
    for spec in specs:
        label, sep, path = spec.partition("=")
        if not sep or not label or not path:
            raise ValueError(f"--compare takes LABEL=DIR, not {spec!r}")
        out[label] = build_library(Path(path))
    return out


def wants_grad(t: torch.Tensor) -> bool:
    """True where autograd would record an op on t: a ctypes launch has no
    grad_fn, so a wrapper without a backward must raise there instead of
    returning a detached result."""
    return torch.is_grad_enabled() and t.requires_grad


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (refused launch, bad config)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
