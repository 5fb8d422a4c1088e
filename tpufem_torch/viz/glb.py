"""Minimal binary glTF 2.0 (GLB) writer, pure Python/numpy — copy of
``tpufem/viz/glb.py``, byte for byte the same output (JSON key order,
float formats, 4-byte padding).

Replaces trimesh/PyVista GLB export (reference viz.py:18-99). Emits one scene
with one node per mesh; vertices float32, indices uint32, optional per-vertex
RGBA colors as normalized uint8 COLOR_0 (the standard vertex-color path,
reference docs/spec.md:37-41). Validates the 'glTF' magic the same way the
reference guards its exports (viz.py:7-15).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_MAGIC = b"glTF"
_JSON_CHUNK = 0x4E4F534A
_BIN_CHUNK = 0x004E4942


@dataclass
class GLBMesh:
    vertices: np.ndarray  # (V,3)
    faces: np.ndarray  # (F,3)
    colors: np.ndarray | None = None  # (V,4) float in [0,1] or uint8
    name: str = "mesh"


def _pad4(b: bytes, fill: bytes) -> bytes:
    rem = len(b) % 4
    return b + fill * ((4 - rem) % 4) if rem else b


def write_glb(path: Path | str, meshes: list[GLBMesh] | GLBMesh) -> None:
    if isinstance(meshes, GLBMesh):
        meshes = [meshes]

    bin_parts: list[bytes] = []
    buffer_views = []
    accessors = []
    gltf_meshes = []
    nodes = []
    offset = 0

    def add_view(data: bytes, target: int | None) -> int:
        nonlocal offset
        data = _pad4(data, b"\0")
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        bin_parts.append(data)
        offset += len(data)
        return len(buffer_views) - 1

    for mi, m in enumerate(meshes):
        verts = np.ascontiguousarray(m.vertices, dtype=np.float32)
        faces = np.ascontiguousarray(m.faces, dtype=np.uint32)

        pos_view = add_view(verts.tobytes(), 34962)
        accessors.append(
            {
                "bufferView": pos_view,
                "componentType": 5126,
                "count": len(verts),
                "type": "VEC3",
                "min": verts.min(axis=0).tolist() if len(verts) else [0, 0, 0],
                "max": verts.max(axis=0).tolist() if len(verts) else [0, 0, 0],
            }
        )
        pos_acc = len(accessors) - 1

        idx_view = add_view(faces.tobytes(), 34963)
        accessors.append(
            {
                "bufferView": idx_view,
                "componentType": 5125,
                "count": faces.size,
                "type": "SCALAR",
            }
        )
        idx_acc = len(accessors) - 1

        attributes = {"POSITION": pos_acc}
        if m.colors is not None:
            col = np.asarray(m.colors)
            if col.dtype != np.uint8:
                col = (np.clip(col, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            if col.shape[1] == 3:
                col = np.concatenate(
                    [col, np.full((len(col), 1), 255, np.uint8)], axis=1
                )
            col_view = add_view(np.ascontiguousarray(col).tobytes(), 34962)
            accessors.append(
                {
                    "bufferView": col_view,
                    "componentType": 5121,
                    "count": len(col),
                    "type": "VEC4",
                    "normalized": True,
                }
            )
            attributes["COLOR_0"] = len(accessors) - 1

        gltf_meshes.append(
            {
                "name": m.name,
                "primitives": [
                    {"attributes": attributes, "indices": idx_acc, "mode": 4}
                ],
            }
        )
        nodes.append({"mesh": mi, "name": m.name})

    bin_blob = b"".join(bin_parts)
    gltf = {
        "asset": {"version": "2.0", "generator": "tpufem"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(bin_blob)}],
    }
    json_blob = _pad4(json.dumps(gltf, separators=(",", ":")).encode("utf-8"), b" ")

    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<II", 2, total))
        f.write(struct.pack("<II", len(json_blob), _JSON_CHUNK))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), _BIN_CHUNK))
        f.write(bin_blob)


def is_binary_glb(path: Path | str) -> bool:
    """Magic check, parity with reference viz.py:7-15."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def read_glb(path: Path | str) -> dict:
    """Parse a GLB back to {json, bin} for tests/round-trips."""
    raw = Path(path).read_bytes()
    if raw[:4] != _MAGIC:
        raise ValueError(f"{path}: not a binary GLB")
    version, total = struct.unpack_from("<II", raw, 4)
    out: dict = {"version": version}
    off = 12
    while off < total:
        length, ctype = struct.unpack_from("<II", raw, off)
        off += 8
        chunk = raw[off : off + length]
        off += length
        if ctype == _JSON_CHUNK:
            out["json"] = json.loads(chunk.decode("utf-8"))
        elif ctype == _BIN_CHUNK:
            out["bin"] = chunk
    return out
