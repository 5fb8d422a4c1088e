"""Pressure-arrow glyph meshes — copy of ``tpufem/viz/arrows.py``; parity with reference viz_results.py:36-69,
243-303: sample <=200 upper faces (seeded from the case_id hex, fem.py:663-667),
place a cylinder+cone arrow above each face centroid pointing inward (against
the outward normal), rotated from +Z via Rodrigues' formula.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _arrow_template(n_seg: int = 8, shaft_r: float = 0.15, shaft_h: float = 0.6,
                    head_r: float = 0.3, head_h: float = 0.4):
    """Unit arrow pointing -Z (tip at origin), height 1, before scaling."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    circ = np.stack([np.cos(ang), np.sin(ang)], axis=1)

    verts = [np.array([[0.0, 0.0, 0.0]])]  # tip
    head_ring = np.concatenate([head_r * circ, np.full((n_seg, 1), head_h)], axis=1)
    shaft_lo = np.concatenate([shaft_r * circ, np.full((n_seg, 1), head_h)], axis=1)
    shaft_hi = np.concatenate(
        [shaft_r * circ, np.full((n_seg, 1), head_h + shaft_h)], axis=1
    )
    top_center = np.array([[0.0, 0.0, head_h + shaft_h]])
    verts += [head_ring, shaft_lo, shaft_hi, top_center]
    V = np.concatenate(verts, axis=0)

    f = []
    hr = 1
    sl = 1 + n_seg
    sh = 1 + 2 * n_seg
    tc = 1 + 3 * n_seg
    for i in range(n_seg):
        j = (i + 1) % n_seg
        f.append([0, hr + i, hr + j])  # cone side
        f.append([hr + i, sl + i, sl + j])  # cone base ring -> shaft base (annulus)
        f.append([hr + i, sl + j, hr + j])
        f.append([sl + i, sh + i, sh + j])  # shaft side
        f.append([sl + i, sh + j, sl + j])
        f.append([tc, sh + j, sh + i])  # top cap
    return V, np.asarray(f, dtype=np.int64)


def _rodrigues_from_z(direction: np.ndarray) -> np.ndarray:
    """Rotation matrices (M,3,3) mapping +Z to each unit direction (M,3)."""
    z = np.array([0.0, 0.0, 1.0])
    d = direction / np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-30)
    v = np.cross(np.broadcast_to(z, d.shape), d)
    c = d[:, 2]
    s = np.linalg.norm(v, axis=1)
    R = np.zeros((len(d), 3, 3))
    eye = np.eye(3)
    for i in range(len(d)):  # M <= 200, loop is fine
        if s[i] < 1e-12:
            R[i] = eye if c[i] > 0 else np.diag([1.0, -1.0, -1.0])
            continue
        k = v[i] / s[i]
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R[i] = eye + s[i] * K + (1 - c[i]) * (K @ K)
    return R


def make_pressure_arrows(
    nodes: np.ndarray,
    upper_faces: np.ndarray,
    case_id: str = "00",
    max_arrows: int = 200,
    length_scale: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(vertices, faces) of merged arrow glyphs above sampled upper faces."""
    # seed from the case id (reference seeds from the hex hash, fem.py:663-667;
    # tpufem ids may be sequential "001" or names, so hash the string instead)
    seed = int(hashlib.sha256(case_id.encode()).hexdigest()[:8], 16) if case_id else 0
    rng = np.random.default_rng(seed)
    n_faces = len(upper_faces)
    sel = (
        rng.choice(n_faces, size=max_arrows, replace=False)
        if n_faces > max_arrows
        else np.arange(n_faces)
    )
    faces = upper_faces[sel]
    v = nodes[faces]
    centroids = v.mean(axis=1)
    normal = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-30)

    if length_scale is None:
        extent = nodes.max(axis=0) - nodes.min(axis=0)
        length_scale = 0.06 * float(np.linalg.norm(extent))

    tv, tf = _arrow_template()
    # template points -Z with tip at origin; rotating +Z onto +n maps the
    # template's -Z axis onto -n, i.e. the arrow points inward at the skin
    R = _rodrigues_from_z(normal)
    placed = np.einsum("mij,vj->mvi", R, tv * length_scale) + centroids[:, None, :]
    # offset: arrows sit above the surface along +n
    placed += (0.02 * length_scale) * normal[:, None, :]

    nv = len(tv)
    all_v = placed.reshape(-1, 3)
    all_f = (tf[None, :, :] + (np.arange(len(sel)) * nv)[:, None, None]).reshape(-1, 3)
    return all_v, all_f
