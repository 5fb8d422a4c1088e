"""Structured tetrahedral wing mesher (numpy) — port of ``tpufem/mesher.py``.

A structured (chord x span x thickness) hex grid fit to the NACA-00xx section,
Kuhn 6-tet subdivision, leading edge (and a sharp trailing edge) welded into
wedges, degenerate tets dropped. For a fixed WingMeshResolution the topology
is identical for every wing in the PRD box; only node coordinates change.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from tpufem_torch.geometry import naca00xx_half_thickness, stations
from tpufem_torch.mesh_types import Mesh

# Kuhn subdivision of the unit hex along the v0-v6 diagonal; consistent across a
# structured grid (shared-face diagonals match between neighbor cells).
_KUHN_TETS = np.array(
    [
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
        [0, 5, 1, 6],
    ],
    dtype=np.int64,
)

# Hex corner offsets in (i: chord, j: span, k: thickness) index space.
_HEX_CORNERS = np.array(
    [
        (0, 0, 0),  # v0
        (1, 0, 0),  # v1
        (1, 1, 0),  # v2
        (0, 1, 0),  # v3
        (0, 0, 1),  # v4
        (1, 0, 1),  # v5
        (1, 1, 1),  # v6
        (0, 1, 1),  # v7
    ],
    dtype=np.int64,
)


@dataclass(frozen=True)
class WingMeshResolution:
    """Structured grid resolution: n_chord x n_span x n_thick cells.

    te_floor_frac > 0 floors the trailing-edge half-thickness at
    te_floor_frac * chord * s (a sharp TE drives the stiffness condition
    number past what CG converges on); spacing='le' clusters chord stations
    at the leading edge only.
    """

    n_chord: int = 32
    n_span: int = 24
    n_thick: int = 4
    te_floor_frac: float = 0.0
    spacing: str = "cosine"  # 'cosine' (both ends) | 'le' (leading edge only)

    @property
    def key(self) -> tuple:
        return (self.n_chord, self.n_span, self.n_thick, self.te_floor_frac, self.spacing)


COARSE = WingMeshResolution(12, 8, 2)
MEDIUM = WingMeshResolution(32, 24, 4)
# the batched-solve configuration: 64x80x6 cells, 109,107 DOF
DOF100K = WingMeshResolution(64, 80, 6, te_floor_frac=0.006, spacing="le")
# the tet10 flagship: 96x128x8 cells, 2.51M DOF once promoted to tet10
# (tpufem_torch.fem.tet10)
DOF1M_TET10 = WingMeshResolution(96, 128, 8, te_floor_frac=0.006, spacing="le")


@dataclass(frozen=True)
class WingTopology:
    """Welded connectivity + per-node parametric basis for a fixed resolution.

    node_basis columns: (s, yfrac, zfrac, zbase). station_id = i*(n_span+1)+j
    and slot (thickness index) describe the through-thickness lines; node
    numbering is station-major.
    """

    tets: np.ndarray  # (T,4) int32, positively oriented for any PRD params
    surf_faces: np.ndarray  # (F,3) int32 outward-oriented
    node_basis: np.ndarray  # (N,4) float64
    num_nodes: int
    station_id: np.ndarray  # (N,) int32
    slot: np.ndarray  # (N,) int32
    num_stations: int
    slots_per_station: int  # n_thick + 1
    te_floor: float = 0.0


@lru_cache(maxsize=8)
def wing_topology(res: WingMeshResolution) -> WingTopology:
    nc, ns, nt = res.n_chord, res.n_span, res.n_thick
    s = stations(nc, res.spacing)  # LE..TE
    zbase = naca00xx_half_thickness(s, 1.0)

    # Full grid ids g(i,j,k); weld all k to k=0 at the LE (i=0) and, when the
    # TE is sharp (te_floor_frac == 0), at the TE (i=nc).
    NI, NJ, NK = nc + 1, ns + 1, nt + 1

    def gid(i, j, k):
        return (i * NJ + j) * NK + k

    I, J, K = np.meshgrid(np.arange(NI), np.arange(NJ), np.arange(NK), indexing="ij")
    weld = (I == 0) | ((I == nc) & (res.te_floor_frac == 0.0))
    rep = gid(I, J, np.where(weld, 0, K)).ravel()

    uniq, new_of_old = np.unique(rep, return_inverse=True)
    num_nodes = len(uniq)

    ri = uniq // (NJ * NK)
    rj = (uniq // NK) % NJ
    rk = uniq % NK
    zfrac = 2.0 * rk / nt - 1.0
    node_basis = np.stack([s[ri], rj / ns, zfrac, zbase[ri]], axis=1)  # (N,4)

    ci, cj, ck = np.meshgrid(np.arange(nc), np.arange(ns), np.arange(nt), indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    corners = np.empty((len(ci), 8), dtype=np.int64)
    for c, (di, dj, dk) in enumerate(_HEX_CORNERS):
        corners[:, c] = new_of_old[gid(ci + di, cj + dj, ck + dk)]
    tets = corners[:, _KUHN_TETS].reshape(-1, 4)

    # Drop degenerate tets (welded duplicate vertices at LE/TE wedges).
    t_sorted = np.sort(tets, axis=1)
    nondeg = np.all(np.diff(t_sorted, axis=1) != 0, axis=1)
    tets = tets[nondeg]

    # Orientation from a reference geometry (invariant over the PRD box).
    nodes = nodes_from_params(node_basis, 1.0, 0.35, 10.0, 0.10, res.te_floor_frac)
    v = nodes[tets]
    vol6 = np.einsum(
        "ti,ti->t", v[:, 1] - v[:, 0], np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0])
    )
    flip = vol6 < 0
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]

    surf = boundary_faces(tets)
    return WingTopology(
        tets=tets.astype(np.int32),
        surf_faces=surf.astype(np.int32),
        node_basis=node_basis,
        num_nodes=num_nodes,
        station_id=(ri * NJ + rj).astype(np.int32),
        slot=rk.astype(np.int32),
        num_stations=NI * NJ,
        slots_per_station=NK,
        te_floor=res.te_floor_frac,
    )


def boundary_faces(tets: np.ndarray) -> np.ndarray:
    """Outward-oriented boundary triangles of a positively-oriented tet mesh:
    the faces (a,c,b), (a,b,d), (b,c,d), (a,d,c) whose vertex set occurs once."""
    a, b, c, d = tets[:, 0], tets[:, 1], tets[:, 2], tets[:, 3]
    faces = np.concatenate(
        [
            np.stack([a, c, b], axis=1),
            np.stack([a, b, d], axis=1),
            np.stack([b, c, d], axis=1),
            np.stack([a, d, c], axis=1),
        ],
        axis=0,
    )
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    return faces[counts[inv] == 1]


def nodes_from_params(
    basis: np.ndarray,
    span_m: float,
    chord_m: float,
    sweep_deg: float,
    thickness_ratio: float,
    te_floor: float = 0.0,
) -> np.ndarray:
    """(N,3) node coordinates from wing parameters and the (N,4) basis.

    tpufem keeps a jnp twin of this map for vmap; the port builds batched
    coordinates on the device in tpufem_torch.fem.stencil.nodes_grid."""
    s, yfrac, zfrac, zbase = basis[:, 0], basis[:, 1], basis[:, 2], basis[:, 3]
    y = span_m * yfrac
    x = chord_m * s + np.tan(np.deg2rad(sweep_deg)) * y
    half = np.maximum(thickness_ratio * zbase, te_floor * s)
    z = chord_m * half * zfrac
    return np.stack([x, y, z], axis=1)


def structured_wing_mesh(
    span_m: float,
    chord_m: float,
    sweep_deg: float,
    thickness_ratio: float,
    res: WingMeshResolution = MEDIUM,
) -> Mesh:
    """Mesh one wing instance (host-side numpy Mesh)."""
    topo = wing_topology(res)
    nodes = nodes_from_params(
        topo.node_basis, span_m, chord_m, sweep_deg, thickness_ratio, topo.te_floor
    )
    return Mesh(
        nodes=nodes,
        tets=topo.tets.copy(),
        surf_faces=topo.surf_faces.copy(),
        meta={
            "params": {
                "span_m": span_m,
                "chord_m": chord_m,
                "sweep_deg": sweep_deg,
                "thickness_ratio": thickness_ratio,
            },
            "resolution": res.key,
            "source": "tpufem-structured",
            "station_id": topo.station_id,
            "slot": topo.slot,
            "num_stations": topo.num_stations,
            "slots_per_station": topo.slots_per_station,
            "num_span_stations": res.n_span + 1,
        },
    )


def compute_tet_quality(mesh: Mesh) -> dict:
    """Aspect-ratio quality metric, vectorized.

    Same definition as reference meshing.py:516-593: AR = max_edge /
    (2*sqrt(6)*inradius), inradius = 3V/A_total, degenerate -> 1e6;
    quality_ok_ratio = share of tets with AR < 3.
    """
    v = mesh.nodes[mesh.tets]  # (T,4,3)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    edges = np.stack([np.linalg.norm(v[:, i] - v[:, j], axis=1) for i, j in pairs], axis=1)
    max_edge = edges.max(axis=1)
    vol = np.abs(mesh.tet_volumes())
    tri_ids = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    area = sum(
        0.5 * np.linalg.norm(np.cross(v[:, b] - v[:, a], v[:, c] - v[:, a]), axis=1)
        for a, b, c in tri_ids
    )
    inradius = 3.0 * vol / np.maximum(area, 1e-300)
    ar = np.where(inradius > 1e-300, max_edge / (2.0 * np.sqrt(6.0) * inradius), 1e6)
    return {
        "aspect_ratio_mean": float(ar.mean()),
        "aspect_ratio_p95": float(np.percentile(ar, 95)),
        "aspect_ratio_max": float(ar.max()),
        "quality_ok_ratio": float((ar < 3.0).mean()),
    }
