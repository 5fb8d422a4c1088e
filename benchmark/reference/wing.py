"""The plain wing model the benchmark's reference judges the port against.

A structured chord x span x thickness hex grid fit to the NACA-00xx section,
each cell cut into the 6 Kuhn tets of its v0-v6 diagonal, the leading edge
(and a sharp trailing edge) welded into wedges, degenerate tets dropped: the
mesh of the upstream project's structured wing, written out again here in
numpy so that the reference shares no code with the program. The node
numbering is station-major, (i * NJ + j) * NK + k over the unique welded
nodes: the order in which the program returns displacements and stresses.

Boundary sets: the root clamp is every node at y <= 1e-4; the loaded upper
surface is the boundary faces of a stated reference wing whose outward
normal has n_z >= 0.2 and whose centroid lies off the root, restricted to
their largest edge-connected component (the threshold relaxed by 0.05 until
they hold a fifth of the boundary's area). The topology, and with it the
upper set, is the same for every wing of the PRD box.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

KUHN_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]],
    dtype=np.int64,
)
# hex corners v0..v7 as (i: chord, j: span, k: thickness) offsets
HEX_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    dtype=np.int64,
)
NACA = (0.2969, -0.1260, -0.3516, 0.2843, -0.1036)
ROOT_Y = 1e-4


def chord_stations(n: int, spacing: str) -> np.ndarray:
    """n + 1 chordwise stations in [0, 1]: clustered at the leading edge only
    ('le'), or at both ends ('cosine')."""
    if spacing == "le":
        return 1.0 - np.cos(np.linspace(0.0, np.pi / 2, n + 1))
    return 0.5 * (1.0 - np.cos(np.linspace(0.0, np.pi, n + 1)))


def naca_half(s: np.ndarray) -> np.ndarray:
    """Half-thickness over chord of a NACA-00xx section at unit thickness ratio."""
    a0, a1, a2, a3, a4 = NACA
    z = 5.0 * (a0 * np.sqrt(np.clip(s, 0.0, None)) + a1 * s + a2 * s**2 + a3 * s**3 + a4 * s**4)
    return np.clip(z, 0.0, None)


def node_coords(basis: np.ndarray, p4: np.ndarray, te_floor: float) -> np.ndarray:
    """(N, 3, B) float64 coordinates of B wings p4 (B, 4) = (span, chord,
    sweep in degrees, thickness ratio) from the (N, 4) basis (s, y fraction,
    z fraction, NACA half-thickness)."""
    s, yf, zf, zb = (basis[:, c, None] for c in range(4))
    span, chord, sweep, tc = (np.asarray(p4, np.float64)[None, :, c] for c in range(4))
    y = span * yf
    x = chord * s + np.tan(np.deg2rad(sweep)) * y
    z = chord * np.maximum(tc * zb, te_floor * s) * zf
    return np.stack([x, y, z], axis=1)


def topology(mesh: dict) -> dict:
    """The welded tet4 topology of the configuration's `mesh` (n_chord,
    n_span, n_thick, te_floor_frac, spacing): tets (T, 4) positively
    oriented, the node basis (N, 4), each node's grid index (i, j, k), the
    boundary faces (F, 3) outward, and the root and upper-surface sets."""
    nc, ns, nt = mesh["n_chord"], mesh["n_span"], mesh["n_thick"]
    te_floor = float(mesh["te_floor_frac"])
    s = chord_stations(nc, mesh["spacing"])
    zb = naca_half(s)
    NI, NJ, NK = nc + 1, ns + 1, nt + 1
    I, J, K = np.meshgrid(np.arange(NI), np.arange(NJ), np.arange(NK), indexing="ij")
    weld = (I == 0) | ((I == nc) & (te_floor == 0.0))
    rep = ((I * NJ + J) * NK + np.where(weld, 0, K)).ravel()
    uniq, new_of_old = np.unique(rep, return_inverse=True)
    ri, rj, rk = uniq // (NJ * NK), (uniq // NK) % NJ, uniq % NK
    basis = np.stack([s[ri], rj / ns, 2.0 * rk / nt - 1.0, zb[ri]], axis=1)

    ci, cj, ck = (a.ravel() for a in np.meshgrid(np.arange(nc), np.arange(ns), np.arange(nt),
                                                 indexing="ij"))
    corners = np.stack([new_of_old[((ci + di) * NJ + cj + dj) * NK + ck + dk]
                        for di, dj, dk in HEX_CORNERS], axis=1)
    tets = corners[:, KUHN_TETS].reshape(-1, 4)
    srt = np.sort(tets, axis=1)
    tets = tets[np.all(np.diff(srt, axis=1) != 0, axis=1)]
    x = node_coords(basis, np.array([[1.0, 0.35, 10.0, 0.10]]), te_floor)[:, :, 0]
    v = x[tets]
    vol6 = np.einsum("ti,ti->t", v[:, 1] - v[:, 0],
                     np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]))
    tets[vol6 < 0] = tets[vol6 < 0][:, [0, 1, 3, 2]]
    return {"tets": tets, "basis": basis, "te_floor": te_floor, "num_nodes": len(uniq),
            "ijk": np.stack([ri, rj, rk], axis=1), "faces": boundary_faces(tets, len(uniq))}


def boundary_faces(tets: np.ndarray, num_nodes: int) -> np.ndarray:
    """The faces (a,c,b), (a,b,d), (b,c,d), (a,d,c) of positively oriented
    tets whose vertex set occurs once: the outward boundary triangles."""
    a, b, c, d = tets.T
    faces = np.concatenate([np.stack(f, axis=1) for f in
                            ((a, c, b), (a, b, d), (b, c, d), (a, d, c))])
    k = np.sort(faces, axis=1)
    key = (k[:, 0] * num_nodes + k[:, 1]) * num_nodes + k[:, 2]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1]


def _largest_component(faces: np.ndarray, sel: np.ndarray) -> np.ndarray:
    idx = np.nonzero(sel)[0]
    if len(idx) <= 1:
        return sel
    sub = faces[idx]
    e = np.sort(np.concatenate([sub[:, [0, 1]], sub[:, [1, 2]], sub[:, [2, 0]]]), axis=1)
    _, eid = np.unique(e[:, 0] * (int(faces.max()) + 1) + e[:, 1], return_inverse=True)
    eid = eid.reshape(-1)
    fid = np.tile(np.arange(len(sub)), 3)
    order = np.argsort(eid, kind="stable")
    eid, fid = eid[order], fid[order]
    same = eid[1:] == eid[:-1]
    g = sp.coo_matrix((np.ones(int(same.sum())), (fid[:-1][same], fid[1:][same])),
                      shape=(len(sub), len(sub)))
    n, labels = connected_components(g, directed=False)
    if n <= 1:
        return sel
    out = np.zeros_like(sel)
    out[idx[labels == np.bincount(labels).argmax()]] = True
    return out


def upper_faces(topo: dict, wing) -> np.ndarray:
    """(U, 3) the loaded upper-surface faces, classified on the wing `wing`
    (span, chord, sweep, thickness ratio)."""
    faces = topo["faces"]
    x = node_coords(topo["basis"], np.array([wing], np.float64), topo["te_floor"])[:, :, 0]
    v = x[faces]
    n = 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = np.linalg.norm(n, axis=1)
    nz = n[:, 2] / np.maximum(area, 1e-300)
    off_root = v[:, :, 1].mean(axis=1) > 5.0 * ROOT_Y
    thresh = 0.2
    for _ in range(12):
        sel = _largest_component(faces, (nz >= thresh) & off_root & (area > 0))
        if area[sel].sum() >= 0.2 * area.sum():
            return faces[sel]
        thresh -= 0.05
        if thresh < -0.2:
            break
    raise ValueError("the upper surface holds under a fifth of the boundary's area")


def root_nodes(topo: dict) -> np.ndarray:
    """The clamped nodes: y <= 1e-4 (the span fraction is 0 there for every wing)."""
    return np.nonzero(topo["basis"][:, 1] <= 0.0)[0]
