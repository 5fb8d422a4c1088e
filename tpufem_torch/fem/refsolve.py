"""Independent host-side direct solve (scipy) — the correctness anchor; port
of ``tpufem/fem/refsolve.py`` (numpy and scipy, unchanged).

CalculiX is unavailable in the build environment (SURVEY.md §7), so the
BASELINE <1e-6-vs-CalculiX criterion is interpreted as <1e-6 vs an independent
direct factorization of the same discrete system: explicit sparse K assembled
from the closed-form tet4 stiffness K_{ai,bj} = V*(lam*g_ai*g_bj + mu*g_aj*g_bi
+ mu*delta_ij*g_a.g_b), Dirichlet elimination, scipy spsolve in float64.
Used by the tests and by the tet10 modal mass (lumped_mass10).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesh_types import Mesh
from tpufem_torch.sets import BoundarySets


def tet4_setup_np(nodes: np.ndarray, tets: np.ndarray):
    x = nodes[tets]
    e = x[:, 1:] - x[:, :1]
    det = np.linalg.det(e)
    vols = det / 6.0
    inv = np.linalg.inv(e)
    g123 = np.swapaxes(inv, 1, 2)
    g0 = -g123.sum(axis=1, keepdims=True)
    grads = np.concatenate([g0, g123], axis=1)
    return grads, vols


def assemble_K(nodes: np.ndarray, tets: np.ndarray, mat: Material) -> sp.csr_matrix:
    lam, mu = lame_params(mat)
    grads, vols = tet4_setup_np(nodes, tets)
    T = len(tets)
    # K_e blocks: (T, 4,3, 4,3)
    gg = np.einsum("tai,tbj->taibj", grads, grads)  # g_ai g_bj
    gdot = np.einsum("tak,tbk->tab", grads, grads)  # g_a . g_b
    eye = np.eye(3)
    Ke = lam * gg + mu * np.einsum("taibj->tbiaj", gg) + mu * np.einsum(
        "tab,ij->taibj", gdot, eye
    )
    Ke = Ke * vols[:, None, None, None, None]
    dof = (3 * tets[:, :, None] + np.arange(3)[None, None, :]).reshape(T, 12)
    rows = np.repeat(dof, 12, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 12)).reshape(-1)
    K = sp.coo_matrix(
        (Ke.reshape(T, 12, 12).reshape(-1), (rows, cols)),
        shape=(3 * len(nodes), 3 * len(nodes)),
    ).tocsr()
    return K


def pressure_loads_np(nodes: np.ndarray, faces: np.ndarray, pressure: float) -> np.ndarray:
    v = nodes[faces]
    area_vec = 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    f_vert = (-pressure / 3.0) * area_vec
    f = np.zeros_like(nodes)
    for k in range(3):
        np.add.at(f, faces[:, k], f_vert)
    return f


def direct_solve(
    mesh: Mesh,
    sets: BoundarySets,
    pressure: float = 5e3,
    mat: Material = Material(),
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (u (N,3), stress6 (N,6), vm (N,)) in float64."""
    nodes = mesh.nodes.astype(np.float64)
    K = assemble_K(nodes, mesh.tets, mat)
    f = pressure_loads_np(nodes, mesh.surf_faces[sets.surf_upper_faces], pressure)
    free = np.ones(len(nodes) * 3, dtype=bool)
    free[(3 * sets.nroot_nodes[:, None] + np.arange(3)).reshape(-1)] = False
    b = f.reshape(-1)
    u = np.zeros(len(nodes) * 3)
    Kff = K[free][:, free]
    u[free] = spla.spsolve(Kff.tocsc(), b[free])
    u = u.reshape(-1, 3)

    # stress recovery identical in spirit to the device path (tensor average)
    lam, mu = lame_params(mat)
    grads, vols = tet4_setup_np(nodes, mesh.tets)
    ue = u[mesh.tets]
    H = np.einsum("tai,taj->tij", grads, ue)
    eps = 0.5 * (H + np.swapaxes(H, 1, 2))
    tr = np.trace(eps, axis1=1, axis2=2)
    sig = 2 * mu * eps
    sig[:, 0, 0] += lam * tr
    sig[:, 1, 1] += lam * tr
    sig[:, 2, 2] += lam * tr
    voigt = np.stack(
        [sig[:, 0, 0], sig[:, 1, 1], sig[:, 2, 2], sig[:, 0, 1], sig[:, 1, 2], sig[:, 2, 0]],
        axis=1,
    )
    num = np.zeros((len(nodes), 6))
    den = np.zeros(len(nodes))
    for k in range(4):
        np.add.at(num, mesh.tets[:, k], vols[:, None] * voigt)
        np.add.at(den, mesh.tets[:, k], vols)
    s6 = num / np.maximum(den, 1e-300)[:, None]
    sxx, syy, szz, sxy, syz, szx = s6.T
    vm = np.sqrt(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3 * (sxy**2 + syz**2 + szx**2)
    )
    return u, s6, vm


# ---- tet10 (quadratic) independent assembly ---------------------------------
# 4-point Gauss rule on the tetrahedron, exact for degree-2 integrands; the
# straight-edge tet10 stiffness integrand (products of linear-in-L shape
# gradients) is exactly degree 2, so this assembly is EXACT — an independent
# anchor for the tet10 operators (tpufem_torch.fem.tet10 / tet10_stencil).
_Q_A, _Q_B = 0.5854101966249685, 0.13819660112501053
_QPTS = np.array(
    [
        [_Q_A, _Q_B, _Q_B, _Q_B],
        [_Q_B, _Q_A, _Q_B, _Q_B],
        [_Q_B, _Q_B, _Q_A, _Q_B],
        [_Q_B, _Q_B, _Q_B, _Q_A],
    ]
)
# midpoint m holds the edge (corner pair) in tet10 column order 4..9
_T10_EDGES = np.array([(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)])


def _tet10_shape_grads(grads: np.ndarray) -> np.ndarray:
    """dN/dx at the 4 quadrature points: (T, 4q, 10, 3) from tet4 corner
    gradients grads (T,4,3). Corners N_a = L_a(2L_a-1); midpoints 4 L_i L_j."""
    T = grads.shape[0]
    G = np.zeros((T, 4, 10, 3))
    for q, L in enumerate(_QPTS):
        for a in range(4):
            G[:, q, a] = (4.0 * L[a] - 1.0) * grads[:, a]
        for m, (i, j) in enumerate(_T10_EDGES):
            G[:, q, 4 + m] = 4.0 * (L[i] * grads[:, j] + L[j] * grads[:, i])
    return G


def assemble_K10(nodes10: np.ndarray, tet10: np.ndarray, mat: Material) -> sp.csr_matrix:
    """Sparse tet10 stiffness via exact quadrature (straight edges).

    nodes10 (N10,3) with corners first then midpoints; tet10 (T,10) in
    tpufem_torch.fem.tet10 ordering (4 corners + 6 edge midpoints, _EDGES order).
    """
    lam, mu = lame_params(mat)
    grads, vols = tet4_setup_np(nodes10, tet10[:, :4])
    G = _tet10_shape_grads(grads)  # (T,4,10,3)
    w = np.abs(vols) / 4.0  # equal weights
    gg = np.einsum("tqai,tqbj->tqaibj", G, G)
    gdot = np.einsum("tqad,tqbd->tqab", G, G)
    eye = np.eye(3)
    Ke = (
        lam * gg
        + mu * np.einsum("tqaibj->tqbiaj", gg)
        + mu * np.einsum("tqab,ij->tqaibj", gdot, eye)
    )
    Ke = (Ke * w[:, None, None, None, None, None]).sum(axis=1)  # (T,10,3,10,3)
    T = len(tet10)
    dof = (3 * tet10[:, :, None].astype(np.int64) + np.arange(3)[None, None, :]).reshape(T, 30)
    rows = np.repeat(dof, 30, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 30)).reshape(-1)
    n = 3 * len(nodes10)
    return sp.coo_matrix(
        (Ke.reshape(T, 30, 30).reshape(-1), (rows, cols)), shape=(n, n)
    ).tocsr()


def lumped_mass10(nodes10: np.ndarray, tet10: np.ndarray, rho: float) -> np.ndarray:
    """HRZ (diagonal-scaled) lumped tet10 mass per node (N10,), kg.

    Row-sum lumping of the consistent tet10 mass yields non-positive corner
    masses; HRZ scales the consistent diagonal to the exact element mass
    instead. For the straight-edge tet10 the closed forms are
    corner rho*V/36, midpoint 4*rho*V/27 (sum = rho*V exactly)."""
    x = nodes10[tet10[:, :4]]
    e = x[:, 1:] - x[:, :1]
    vols = np.abs(np.linalg.det(e)) / 6.0
    m = np.zeros(len(nodes10))
    for a in range(4):
        np.add.at(m, tet10[:, a], rho * vols / 36.0)
    for b in range(4, 10):
        np.add.at(m, tet10[:, b], 4.0 * rho * vols / 27.0)
    return m
