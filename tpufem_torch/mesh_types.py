"""Host-side mesh container (numpy) — copy of ``tpufem/mesh_types.py``'s Mesh
and pad_to. The jit-padded PaddedMesh has no user in the port."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class Mesh:
    """A single tetrahedral mesh with oriented boundary surface.

    nodes (N,3) float64; tets (T,4) int32, positive orientation;
    surf_faces (F,3) int32, outward-oriented; meta: provenance. (tpufem's
    optional tet10 field is not carried: nothing reads it; the quadratic
    mesh is tpufem_torch.fem.tet10.Tet10Mesh.)
    """

    nodes: np.ndarray
    tets: np.ndarray
    surf_faces: np.ndarray
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_tets(self) -> int:
        return len(self.tets)

    @property
    def num_surf_faces(self) -> int:
        return len(self.surf_faces)

    def tet_volumes(self) -> np.ndarray:
        v = self.nodes[self.tets]
        return np.einsum(
            "ti,ti->t", v[:, 1] - v[:, 0], np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0])
        ) / 6.0

    def validate(self) -> None:
        """Raise ValueError on out-of-range node ids or non-positive tets."""
        if self.tets.min() < 0 or self.tets.max() >= self.num_nodes:
            raise ValueError("tet node id out of range")
        vols = self.tet_volumes()
        if not (vols > 0).all():
            raise ValueError(f"{(vols <= 0).sum()} non-positive tets")


def pad_to(arr: np.ndarray, n: int, fill: float | int = 0) -> np.ndarray:
    """Pad axis 0 of `arr` to length `n` with `fill`."""
    if len(arr) > n:
        raise ValueError(f"cannot pad length {len(arr)} down to {n}")
    pad = [(0, n - len(arr))] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)
