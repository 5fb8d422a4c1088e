"""Extended-precision (host) residual evaluation for solver certification —
port of ``tpufem/fem/xprec.py`` (numpy, unchanged).

At thin-wing conditioning the computed f64 residual saturates at element
cancellation noise: per-element force magnitudes exceed the assembled
residual by ~kappa_elem, so f64 rounding floors the one-shot metric (tpufem
measured ~2e-6 relative on a 16x16x4 mesh and ~7e-6 at the 2.5M-DOF
flagship), however good the solution is.

This module evaluates r = b - K x on the host in numpy.longdouble (80-bit
x87 extended on x86-64: eps ~ 5.4e-20), pushing the evaluation floor ~3-4
orders below f64. The inputs (Jinv, vols, b, x, lam, mu) are CAST from their
f64 values, not recomputed, so the residual measured is that of the exact
system the device solved.
"""

from __future__ import annotations

import warnings

import numpy as np

from tpufem_torch.fem.tet10 import DNDXI, GAUSS_WEIGHT


def tet10_residual_xprec(
    Jinv,
    vols,
    conn,
    b,
    x,
    free,
    lam: float,
    mu: float,
    elem_chunk: int = 32768,
) -> tuple[float, float]:
    """TRUE relative residual of the tet10 system in extended precision.

    All array inputs are numpy (exact casts from f64); the element loop
    mirrors tpufem_torch.fem.tet10._tet10_fe / tet10_force term for term.
    `elem_chunk` bounds the host temporaries.

    Returns (rel_residual, abs_residual_norm) as Python floats.
    """
    ld = np.longdouble
    # np.longdouble is only 80-bit extended on x86-64; on aarch64/Windows it
    # aliases f64 (eps ~2.2e-16) and "certification" would silently degrade
    # to the f64 evaluation floor. Surface that instead of hiding it.
    if np.finfo(ld).eps >= 1e-18:
        warnings.warn(
            "numpy.longdouble is not extended precision on this platform "
            f"(eps={float(np.finfo(ld).eps):.2e}); xprec residuals are "
            "limited to the f64 evaluation floor",
            RuntimeWarning,
            stacklevel=2,
        )
    Jinv = np.asarray(Jinv).astype(ld)  # (T,3,3)
    vols = np.asarray(vols).astype(ld)  # (T,)
    conn = np.asarray(conn)  # (T,10)
    b = np.asarray(b).astype(ld)  # (N,3)
    free = np.asarray(free).astype(ld)  # (N,3)
    x = np.asarray(x).astype(ld)  # (N,3)
    lam = ld(lam)
    mu = ld(mu)
    table = DNDXI.astype(ld)  # (Q,10,3)

    N = b.shape[0]
    T = conn.shape[0]
    u = x * free
    y = np.zeros((N, 3), dtype=ld)
    eye = np.eye(3, dtype=ld)
    for s in range(0, T, elem_chunk):
        e = min(T, s + elem_chunk)
        Jc, vc, cc = Jinv[s:e], vols[s:e], conn[s:e]
        # g[t,q,a,i] = sum_j table[q,a,j] * Jinv[t,i,j]
        g = np.einsum("qaj,tij->tqai", table, Jc)
        ue = u[cc]  # (C,10,3)
        # H[t,q,i,j] = sum_a g[t,q,a,i] * ue[t,a,j]
        H = np.einsum("tqai,taj->tqij", g, ue)
        eps = 0.5 * (H + H.transpose(0, 1, 3, 2))
        tr = eps[..., 0, 0] + eps[..., 1, 1] + eps[..., 2, 2]
        sigma = 2.0 * mu * eps + lam * tr[..., None, None] * eye
        sw = sigma * (ld(GAUSS_WEIGHT) * vc)[:, None, None, None]
        # fe[t,a,i] = sum_q sum_j sw[t,q,i,j] * g[t,q,a,j]
        fe = np.einsum("tqij,tqaj->tai", sw, g)
        np.add.at(y, cc.reshape(-1), fe.reshape(-1, 3))
    y = y * free + x * (1.0 - free)
    r = b - y
    rn = ld(np.sqrt(np.sum(r * r)))
    bn = ld(np.sqrt(np.sum(b * b)))
    rel = float(rn / bn) if bn > 0 else float(rn)
    return rel, float(rn)
