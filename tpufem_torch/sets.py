"""Boundary sets: root clamp nodes, full surface, loaded upper surface.

Port of ``tpufem/sets.py`` (numpy + scipy.sparse.csgraph):
  - NROOT      = nodes with y <= y_tol
  - SURF_ALL   = all positive-area boundary triangles
  - SURF_UPPER = faces with outward n_z >= nz_min whose centroid y > 5*y_tol,
                 restricted to the largest edge-connected component, with
                 nz_min relaxed by 0.05 down to -0.2 until the upper-area
                 ratio reaches min_upper_ratio.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from tpufem_torch.mesh_types import Mesh


@dataclass
class BoundarySets:
    nroot_nodes: np.ndarray  # (R,) int32 clamped node ids
    surf_all_faces: np.ndarray  # (F,) int32 indices into mesh.surf_faces
    surf_upper_faces: np.ndarray  # (U,) int32 indices into mesh.surf_faces
    nz_min_used: float
    upper_area_ratio: float

    def to_json_dict(self, mesh: Mesh) -> dict:
        """Artifact-compatible boundary_sets.json payload (reference meshing.py:728-752)."""
        upper_nodes = np.unique(mesh.surf_faces[self.surf_upper_faces])
        surf_nodes = np.unique(mesh.surf_faces[self.surf_all_faces])
        return {
            "nroot_nodes": self.nroot_nodes.tolist(),
            "surf_all_nodes": surf_nodes.tolist(),
            "surf_upper_nodes": upper_nodes.tolist(),
            "surf_all_faces": self.surf_all_faces.tolist(),
            "surf_upper_faces": self.surf_upper_faces.tolist(),
            "nz_min_used": self.nz_min_used,
            "upper_area_ratio": self.upper_area_ratio,
        }


def face_normals_areas(nodes: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unit normals (as-wound) and areas of triangles."""
    v = nodes[faces]
    n = 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = np.linalg.norm(n, axis=1)
    unit = n / np.maximum(area, 1e-300)[:, None]
    return unit, area


def _largest_component(faces: np.ndarray, selected: np.ndarray) -> np.ndarray:
    """Restrict boolean face selection to its largest edge-connected component."""
    idx = np.nonzero(selected)[0]
    if len(idx) <= 1:
        return selected
    sub = faces[idx]
    edges = np.concatenate([sub[:, [0, 1]], sub[:, [1, 2]], sub[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    _, edge_ids = np.unique(edges, axis=0, return_inverse=True)
    face_of = np.tile(np.arange(len(sub)), 3)
    order = np.argsort(edge_ids, kind="stable")
    eid, fid = edge_ids[order], face_of[order]
    # faces sharing an edge appear consecutively; connect consecutive pairs
    same = eid[1:] == eid[:-1]
    rows, cols = fid[:-1][same], fid[1:][same]
    g = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(len(sub), len(sub)))
    n_comp, labels = connected_components(g, directed=False)
    if n_comp <= 1:
        return selected
    largest = np.bincount(labels).argmax()
    out = np.zeros_like(selected)
    out[idx[labels == largest]] = True
    return out


def build_boundary_sets(
    mesh: Mesh,
    y_tol: float = 1e-4,
    nz_min: float = 0.2,
    min_upper_ratio: float = 0.2,
    max_relax_iters: int = 12,
) -> BoundarySets:
    """Classify the boundary into root clamp / all / loaded-upper sets.

    Raises ValueError if NROOT is empty or the upper-area ratio stays below
    `min_upper_ratio` after relaxation.
    """
    nodes, faces = mesh.nodes, mesh.surf_faces
    nroot = np.nonzero(nodes[:, 1] <= y_tol)[0].astype(np.int32)
    if len(nroot) == 0:
        raise ValueError("NROOT empty: no nodes at the wing root (y <= y_tol)")

    normals, areas = face_normals_areas(nodes, faces)
    total_area = areas.sum()
    centroid_y = nodes[faces][:, :, 1].mean(axis=1)
    away_from_root = centroid_y > 5.0 * y_tol
    positive_area = areas > 0

    nz = nz_min
    upper = np.zeros(len(faces), dtype=bool)
    ratio = 0.0
    for _ in range(max_relax_iters):
        upper = (normals[:, 2] >= nz) & away_from_root & positive_area
        upper = _largest_component(faces, upper)
        ratio = float(areas[upper].sum() / max(total_area, 1e-300))
        if ratio >= min_upper_ratio:
            break
        nz -= 0.05
        if nz < -0.2:
            break
    if ratio < min_upper_ratio:
        raise ValueError(
            f"upper-surface area ratio {ratio:.3f} < {min_upper_ratio} after nz_min relaxation"
        )

    return BoundarySets(
        nroot_nodes=nroot,
        surf_all_faces=np.nonzero(positive_area)[0].astype(np.int32),
        surf_upper_faces=np.nonzero(upper)[0].astype(np.int32),
        nz_min_used=float(nz),
        upper_area_ratio=ratio,
    )
