"""Parametric NACA-00xx wing geometry (numpy) — copy of ``tpufem/geometry.py``:
the airfoil section and chordwise stations the structured mesher reads, and
the watertight surface loft the geometry stage writes as ``wing.stl``.

Coordinates: +X chord, +Y span (root at y=0), +Z thickness. Sweep shifts the
tip section by span*tan(sweep) in +X.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Closed-trailing-edge NACA 4-digit thickness polynomial (-0.1036 instead of the
# classic open-TE -0.1015, so z(c) == 0 exactly).
_NACA_COEFFS = (0.2969, -0.1260, -0.3516, 0.2843, -0.1036)


def naca00xx_half_thickness(x_over_c: np.ndarray, thickness_ratio: float) -> np.ndarray:
    """Half-thickness z/c of a symmetric NACA-00xx airfoil at chordwise x/c."""
    x = np.asarray(x_over_c, dtype=np.float64)
    a0, a1, a2, a3, a4 = _NACA_COEFFS
    z = 5.0 * thickness_ratio * (
        a0 * np.sqrt(np.clip(x, 0.0, None)) + a1 * x + a2 * x**2 + a3 * x**3 + a4 * x**4
    )
    return np.clip(z, 0.0, None)


def cosine_stations(n: int) -> np.ndarray:
    """n+1 chordwise stations in [0,1], cosine-clustered at BOTH ends."""
    theta = np.linspace(0.0, np.pi, n + 1)
    return 0.5 * (1.0 - np.cos(theta))


def le_stations(n: int) -> np.ndarray:
    """n+1 chordwise stations clustered at the leading edge only (blunt TE)."""
    theta = np.linspace(0.0, np.pi / 2, n + 1)
    return 1.0 - np.cos(theta)


def stations(n: int, spacing: str) -> np.ndarray:
    """Chordwise stations for a WingMeshResolution.spacing value."""
    return (le_stations if spacing == "le" else cosine_stations)(n)


def airfoil_ring(chord_m: float, thickness_ratio: float, n_chord: int = 48) -> np.ndarray:
    """Closed airfoil ring (2*n_chord points, CCW seen from +Y): TE → upper → LE → lower → TE.

    Mirrors the reference's `_build_airfoil_loop` (blender/generate_wing.py:57-64)
    but with cosine clustering and an exactly closed trailing edge.
    """
    s = cosine_stations(n_chord)  # 0..1, LE..TE
    z = chord_m * naca00xx_half_thickness(s, thickness_ratio)
    x = chord_m * s
    # upper TE→LE (exclusive of duplicated endpoints), then LE, then lower LE→TE
    upper = np.stack([x[::-1], z[::-1]], axis=1)  # TE..LE inclusive
    lower = np.stack([x[1:-1], -z[1:-1]], axis=1)  # LE+1 .. TE-1
    ring = np.concatenate([upper, lower], axis=0)  # 2*n_chord points
    return ring


@dataclass(frozen=True)
class WingSurface:
    """Watertight triangulated wing surface."""

    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int64, outward-oriented

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.faces)


def generate_wing_surface(
    span_m: float,
    chord_m: float,
    sweep_deg: float,
    thickness_ratio: float,
    n_chord: int = 48,
    n_span: int = 16,
) -> WingSurface:
    """Loft the parametric wing into a watertight triangle surface.

    Replaces reference `generate_wing_mesh` (blender/generate_wing.py:80-135):
    instead of bmesh hole-fill caps the caps are chord-strip triangulations that
    share the ring vertices, so the result is watertight by construction.
    """
    ring2d = airfoil_ring(chord_m, thickness_ratio, n_chord)  # (R,2) in (x,z)
    R = len(ring2d)
    sweep_dx = span_m * np.tan(np.deg2rad(sweep_deg))
    y = np.linspace(0.0, span_m, n_span + 1)
    dx = np.linspace(0.0, sweep_dx, n_span + 1)

    # Rings stacked along span: vertex id = j*R + i
    verts = np.empty(((n_span + 1) * R, 3), dtype=np.float64)
    for j in range(n_span + 1):
        verts[j * R : (j + 1) * R, 0] = ring2d[:, 0] + dx[j]
        verts[j * R : (j + 1) * R, 1] = y[j]
        verts[j * R : (j + 1) * R, 2] = ring2d[:, 1]

    faces = []
    # Side wall quads between ring j and j+1.
    i = np.arange(R)
    inext = (i + 1) % R
    for j in range(n_span):
        a = j * R + i
        b = j * R + inext
        c = (j + 1) * R + inext
        d = (j + 1) * R + i
        # Ring is CCW seen from +Y (outside at root is -Y side): orient outward.
        faces.append(np.stack([a, c, b], axis=1))
        faces.append(np.stack([a, d, c], axis=1))

    # Caps: ring index layout is upper = ring[0..n_chord] (TE..LE),
    # lower station k (1..n_chord-1) = ring[2*n_chord - k].
    n = R // 2  # == n_chord

    def cap_faces(j: int, outward_plus_y: bool) -> np.ndarray:
        base = j * R
        u = base + np.arange(n + 1)  # TE..LE along upper (u[0]=TE, u[n]=LE)
        low = np.concatenate([[u[0]], base + (2 * n - np.arange(1, n)), [u[n]]])
        tris = []
        # Strip between upper station k and k+1 (TE-side to LE-side).
        for k in range(n):
            a, b = u[k], u[k + 1]
            c, d = low[k], low[k + 1]
            if a != c:  # not the TE degenerate pair
                tris.append([a, c, d])
            if b != d:
                tris.append([a, d, b])
        t = np.asarray(tris, dtype=np.int64)
        # As built the strip triangles have +Y normals; the root cap (y=0) needs -Y.
        if not outward_plus_y:
            t = t[:, [0, 2, 1]]
        return t

    faces.append(cap_faces(0, outward_plus_y=False))  # root cap, normal -Y
    faces.append(cap_faces(n_span, outward_plus_y=True))  # tip cap, normal +Y

    F = np.concatenate(faces, axis=0)
    surf = WingSurface(vertices=verts, faces=F)
    return _orient_outward(surf)


def _orient_outward(surf: WingSurface) -> WingSurface:
    """Flip all faces so signed volume is positive (outward normals)."""
    if surface_signed_volume(surf) < 0:
        return WingSurface(surf.vertices, surf.faces[:, [0, 2, 1]])
    return surf


def surface_signed_volume(surf: WingSurface) -> float:
    """Signed volume via divergence theorem; positive for outward orientation."""
    v = surf.vertices[surf.faces]
    return float(np.einsum("fi,fi->f", v[:, 0], np.cross(v[:, 1], v[:, 2])).sum() / 6.0)


def surface_is_watertight(surf: WingSurface) -> bool:
    """Every undirected edge shared by exactly two faces."""
    f = surf.faces
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return bool(np.all(counts == 2))


def surface_is_consistently_oriented(surf: WingSurface) -> bool:
    """Every *directed* edge appears exactly once (manifold, coherent winding).

    This is the property the reference enforces dynamically with a DFS
    (src/deep_fem_uav_wing/meshing.py:222-306); the loft guarantees it by
    construction and this predicate verifies that in tests.
    """
    f = surf.faces
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return bool(np.all(counts == 1))
