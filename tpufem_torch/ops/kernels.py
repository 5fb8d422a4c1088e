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
import re
import shutil
import subprocess
import threading
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
    # (g, vol, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream)
    "tpufem_stvk_force_f64": [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_double] * 2 + [_P],
    # (g, vol, x, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream)
    "tpufem_stvk_tangent_f64": [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_double] * 2 + [_P],
    # (B, NI, NK, NJ, int[2] out) -> 0: the tile (own_j, own_i) of H's and I's launch
    "tpufem_grid_tile_f64": [ctypes.c_int] * 4 + [_P],
    # (B, NI, NK, NJ) -> the number of per-block partials
    "tpufem_stvk_energy_blocks": [ctypes.c_int] * 4,
    # (g, vol, u, free, partial, ticket, out, B, NI, NK, NJ, weld_te, lam, mu, stream)
    "tpufem_stvk_energy_f64": [_P] * 7 + [ctypes.c_int] * 5 + [ctypes.c_double] * 2 + [_P],
    # (g, vol, u, w, free, gbar, volbar, B, NI, NK, NJ, weld_te, lam, mu, stream)
    "tpufem_strain_geo_vjp_f64": [_P] * 7 + [ctypes.c_int] * 5 + [ctypes.c_double] * 2 + [_P],
    # (g, vol, u2, free2, y, partial, ticket, B, NI2, NK2, NJ2, weld_te, TI, TJ, lam, mu, stream)
    "tpufem_strain_apply10_tiled_f32": [_P] * 7 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2
    + [_P],
    "tpufem_strain_apply10_tiled_f64": [_P] * 7 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2
    + [_P],
    # (x4, dup2, free2, y2, B, NI, NK, NJ, weld_te, stream)
    "tpufem_prolong_p_f32": [_P] * 4 + [ctypes.c_int] * 5 + [_P],
    "tpufem_prolong_p_f64": [_P] * 4 + [ctypes.c_int] * 5 + [_P],
    # (r2, free4, y4, B, NI, NK, NJ, weld_te, TIr, TJr, stream)
    "tpufem_restrict_p_tiled_f32": [_P] * 3 + [ctypes.c_int] * 7 + [_P],
    "tpufem_restrict_p_tiled_f64": [_P] * 3 + [ctypes.c_int] * 7 + [_P],
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


def build_library(csrc: Path, info: dict | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of the sources in
    `csrc`; raises on any failure. The port's own library is load_kernels();
    the profilers' --compare builds another commit's csrc/, or an edited
    copy, beside it. `info` (default build_info) receives the build's ptxas report
    (kept beside the library, so a cached build reports it too) and time."""
    csrc = Path(csrc)
    info = build_info if info is None else info
    sources = sorted(csrc.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(csrc.glob("*.cu*")):  # the sources and the headers they include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libtpufem_kernels_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")  # nvcc's -Xptxas -v report
    t0 = time.perf_counter()
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # the process and thread: two builds of the same sources at once
        # (compare_libraries) never share an object or a temporary
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}.{threading.get_ident()}"
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
        tmp = lib_path.with_suffix(f".{tag}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        log_path.write_text("".join(p.stderr for p in procs))
        os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file
    info["log"] = log_path.read_text() if log_path.exists() else ""
    info["seconds"] = time.perf_counter() - t0
    info["path"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        if csrc != CSRC and not hasattr(lib, name):
            continue  # another commit's sources may predate an entry point
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the port's kernel library; raises on any
    failure."""
    return build_library(CSRC)


def parse_compare_specs(specs) -> list:
    """[(label, Path)] of the profilers' --compare LABEL=DIR arguments; raises
    ValueError on a malformed one (no label, no '=' or no directory)."""
    parsed = []
    for spec in specs:
        label, sep, path = spec.partition("=")
        if not sep or not label or not path:
            raise ValueError(f"--compare takes LABEL=DIR, not {spec!r}")
        parsed.append((label, Path(path)))
    return parsed


def compare_libraries(specs) -> dict:
    """{label: library} for the profilers' --compare LABEL=DIR arguments:
    each DIR a csrc/ of another commit (e.g. unpacked with `git archive <rev>
    tpufem_torch/csrc`) or an edited copy of the port's, built with
    build_library, all libraries at once. Each library's build report is its
    `build_info` attribute. Measuring aids only: no entry point of the port
    loads them."""
    parsed = [(label, path, {}) for label, path in parse_compare_specs(specs)]
    with ThreadPoolExecutor(max_workers=max(len(parsed), 1)) as pool:
        libs = list(pool.map(lambda a: build_library(a[1], a[2]), parsed))
    out = {}
    for (label, _, info), lib in zip(parsed, libs):
        lib.build_info = info
        out[label] = lib
    return out


def ptxas_report(log: str) -> dict:
    """{kernel entry (mangled name): (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
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
