"""Native host-side mesh kernel (C++ via ctypes), with numpy fallback — port
of ``tpufem/native/__init__.py``.

``meshcore.cpp`` (this package's own copy of tpufem's) is built with g++ at
first use into the repository's ``build/`` (listed in .gitignore, where the
CUDA kernels build too), and rebuilt when the source is newer than the
library. The build leaves out tpufem's ``-march=native``: the library may be
built on one host and loaded on another. On a host without g++, or where the
build fails, ``available()`` is False, every entry point returns None and the
callers take their numpy paths, as in tpufem; unlike tpufem, the failure's
text is kept in ``build_error``. Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from tpufem_torch.ops.kernels import BUILD_DIR

_SRC = Path(__file__).parent / "meshcore.cpp"
_SO = BUILD_DIR / "libmeshcore.so"
_lib = None
# why the last build or load failed (None: it has not failed)
build_error: str | None = None


def _build() -> None:
    """Compile meshcore.cpp into _SO: into a file of this process's own, then
    renamed over _SO, so a process that loads _SO never finds it half
    written."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, _SO)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, build_error
    if _lib is not None or build_error is not None:
        return _lib
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
    except subprocess.CalledProcessError as e:
        build_error = f"g++ exited {e.returncode}: {e.stderr.strip()}"
        return None
    except (OSError, subprocess.SubprocessError) as e:  # no g++, a timeout, a bad library
        build_error = f"{type(e).__name__}: {e}"
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.boundary_faces.restype = ctypes.c_int64
    lib.boundary_faces.argtypes = [i32p, ctypes.c_int64, i32p]
    lib.unique_edges.restype = ctypes.c_int64
    lib.unique_edges.argtypes = [i32p, ctypes.c_int64, i32p]
    lib.unique_tri_edges.restype = ctypes.c_int64
    lib.unique_tri_edges.argtypes = [i32p, ctypes.c_int64, i32p]
    i64ref = ctypes.POINTER(ctypes.c_int64)
    lib.msh2_counts.restype = ctypes.c_int
    lib.msh2_counts.argtypes = [ctypes.c_char_p, i64ref, i64ref, i64ref]
    lib.msh2_parse.restype = ctypes.c_int
    lib.msh2_parse.argtypes = [ctypes.c_char_p, i64p, f64p, i64p, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def boundary_faces_native(tets: np.ndarray) -> np.ndarray | None:
    """Outward boundary faces of positive tets, or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    tets32 = np.ascontiguousarray(tets, dtype=np.int32)
    out = np.empty((len(tets32) * 4, 3), dtype=np.int32)
    n = lib.boundary_faces(tets32, len(tets32), out)
    return np.ascontiguousarray(out[:n])


def unique_edges_native(tets: np.ndarray) -> np.ndarray | None:
    """The sorted unique edges (E,2) of tets (T,4), or None."""
    lib = _load()
    if lib is None:
        return None
    tets32 = np.ascontiguousarray(tets, dtype=np.int32)
    out = np.empty((len(tets32) * 6, 2), dtype=np.int32)
    n = lib.unique_edges(tets32, len(tets32), out)
    return np.ascontiguousarray(out[:n])


def unique_tri_edges_native(faces: np.ndarray) -> np.ndarray | None:
    """The sorted unique edges (E,2) of triangles (F,3), or None."""
    lib = _load()
    if lib is None:
        return None
    f32 = np.ascontiguousarray(faces, dtype=np.int32)
    out = np.empty((len(f32) * 3, 2), dtype=np.int32)
    n = lib.unique_tri_edges(f32, len(f32), out)
    return np.ascontiguousarray(out[:n])


def msh2_parse_native(text: str):
    """(node_ids, node_xyz, tris, tets) of an MSH v2 ASCII text, or None
    (native unavailable, or an element type the parser does not know).
    `msh2_parse_native.calls` counts the parses that went native."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("utf-8")
    n_nodes, n_tris, n_tets = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.msh2_counts(raw, ctypes.byref(n_nodes), ctypes.byref(n_tris), ctypes.byref(n_tets)) != 0:
        return None
    node_ids = np.empty(n_nodes.value, dtype=np.int64)
    node_xyz = np.empty((n_nodes.value, 3), dtype=np.float64)
    tris = np.empty((n_tris.value, 3), dtype=np.int64)
    tets = np.empty((n_tets.value, 4), dtype=np.int64)
    if lib.msh2_parse(raw, node_ids, node_xyz, tris, tets) != 0:
        return None
    msh2_parse_native.calls += 1
    return node_ids, node_xyz, tris, tets


msh2_parse_native.calls = 0
