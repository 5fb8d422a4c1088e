"""Binary STL read/write in pure numpy — port of ``tpufem/utils/stl.py``
(the geometry stage's ``wing.stl`` and a user's own STL). Binary STL layout:
80-byte header, uint32 triangle count, then per-triangle records of (normal
f32x3, 3 vertices f32x3, uint16 attribute)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

_TRI_DTYPE = np.dtype(
    [
        ("normal", "<f4", (3,)),
        ("verts", "<f4", (3, 3)),
        ("attr", "<u2"),
    ]
)


def write_stl(path: Path | str, vertices: np.ndarray, faces: np.ndarray, header: str = "tpufem") -> None:
    """Write a binary STL from (V,3) float vertices and (F,3) int faces."""
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    tri = vertices[faces]  # (F, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.divide(n, np.maximum(norm, 1e-30))

    rec = np.zeros(len(faces), dtype=_TRI_DTYPE)
    rec["normal"] = n.astype(np.float32)
    rec["verts"] = tri.astype(np.float32)

    head = header.encode("utf-8")[:80].ljust(80, b"\0")
    with open(path, "wb") as f:
        f.write(head)
        f.write(np.uint32(len(faces)).tobytes())
        f.write(rec.tobytes())


def read_stl(path: Path | str) -> tuple[np.ndarray, np.ndarray]:
    """Read a binary (or ASCII) STL; returns welded (vertices (V,3) f64,
    faces (F,3) i64).

    Coincident vertices (exact float equality after f32 round-trip) are welded so
    downstream face-adjacency logic sees a closed surface.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:5] == b"solid" and b"facet" in raw[:1024]:
        return _read_ascii(raw)
    if len(raw) < 84:
        raise ValueError(f"{path}: too short for a binary STL")
    count = int(np.frombuffer(raw[80:84], dtype="<u4")[0])
    if len(raw) < 84 + count * _TRI_DTYPE.itemsize:
        raise ValueError(f"{path}: binary STL truncated ({count} triangles announced)")
    rec = np.frombuffer(raw[84 : 84 + count * _TRI_DTYPE.itemsize], dtype=_TRI_DTYPE)
    tri = rec["verts"].astype(np.float64)  # (F,3,3)
    return _weld(tri)


def _read_ascii(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    verts = []
    for line in raw.decode("utf-8", errors="replace").splitlines():
        parts = line.split()
        if parts and parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    tri = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
    return _weld(tri)


def _weld(tri: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    flat = tri.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=9), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int64)
    return uniq, faces
