"""Gmsh MSH v2 ASCII ingestion for externally produced meshes — port of
``tpufem/msh2.py`` (reference meshing.py:112-176, ``parse_msh2``).

$Nodes -> coordinates, $Elements -> surface triangles (types 2 linear / 9
quadratic, corner nodes) and tetrahedra (types 4 linear / 11 quadratic,
corner nodes); renumbered to dense 0-based ids, tets positively oriented,
outward boundary faces. This is tpufem's numpy parser. tpufem first tries
its host C++ parser (``tpufem/native/meshcore.cpp``, built with g++ at first
use); that host code is not carried by the port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpufem_torch.mesh_types import Mesh
from tpufem_torch.mesher import boundary_faces

_TRI_TYPES = {2: 3, 9: 6}  # type -> nodes per element (corners first)
_TET_TYPES = {4: 4, 11: 10}


def parse_msh2(path: Path | str) -> Mesh:
    text = Path(path).read_text()
    nodes_id, nodes_xyz = _parse_nodes(text)
    tris, tets = _parse_elements(text)

    # Renumber gmsh 1-based sparse ids -> dense 0-based.
    remap = np.full(nodes_id.max() + 1, -1, dtype=np.int64)
    remap[nodes_id] = np.arange(len(nodes_id))
    if tets.size and tets.max() >= len(remap):
        raise ValueError("element references undefined node id")
    tets = remap[tets]
    if (tets < 0).any():
        raise ValueError("element references undefined node id")

    # Positive orientation.
    v = nodes_xyz[tets]
    vol6 = np.einsum("ti,ti->t", v[:, 1] - v[:, 0], np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]))
    flip = vol6 < 0
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]

    surf = boundary_faces(tets)
    return Mesh(
        nodes=nodes_xyz,
        tets=tets.astype(np.int32),
        surf_faces=surf.astype(np.int32),
        meta={"source": str(path), "n_file_tris": int(len(tris))},
    )


def _section(text: str, name: str) -> str:
    try:
        start = text.index(f"${name}")
        end = text.index(f"$End{name}")
    except ValueError:
        raise ValueError(f"MSH2 file has no ${name} section") from None
    return text[start + len(name) + 1 : end]


def _parse_nodes(text: str) -> tuple[np.ndarray, np.ndarray]:
    body = _section(text, "Nodes").strip().split("\n")
    count = int(body[0])
    data = np.array(" ".join(body[1 : 1 + count]).split(), dtype=np.float64).reshape(count, 4)
    return data[:, 0].astype(np.int64), data[:, 1:4]


def _parse_elements(text: str) -> tuple[np.ndarray, np.ndarray]:
    body = _section(text, "Elements").strip().split("\n")
    count = int(body[0])
    tris, tets = [], []
    for line in body[1 : 1 + count]:
        parts = line.split()
        etype = int(parts[1])
        ntags = int(parts[2])
        conn = [int(p) for p in parts[3 + ntags :]]
        if etype in _TRI_TYPES:
            tris.append(conn[:3])
        elif etype in _TET_TYPES:
            tets.append(conn[:4])
    tris_a = np.asarray(tris, dtype=np.int64) if tris else np.zeros((0, 3), np.int64)
    tets_a = np.asarray(tets, dtype=np.int64) if tets else np.zeros((0, 4), np.int64)
    return tris_a, tets_a
