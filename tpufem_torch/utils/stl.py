"""Binary STL writer in pure numpy — port of ``tpufem/utils/stl.py``'s
``write_stl`` (the geometry stage's ``wing.stl``). Binary STL layout: 80-byte
header, uint32 triangle count, then per-triangle records of (normal f32x3,
3 vertices f32x3, uint16 attribute)."""

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
