"""Preconditioned conjugate gradients on device tensors — port of
``tpufem/fem/solver.py``.

tpufem ran the loop as ``lax.while_loop`` inside jit. The port runs it as a
Python loop over device tensors with the same stopping rule
(torch.dot(r,r) > (tol*||b||)^2 and k < maxiter): the test reads one scalar per
iteration back to the host, which synchronizes with the device once per
iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_residual: torch.Tensor  # ||r|| / ||b||, 0-d
    converged: bool


def pcg(
    A: Callable,
    b: torch.Tensor,
    diag: torch.Tensor | None = None,
    tol: float = 1e-8,
    maxiter: int = 2000,
    M: Callable | None = None,
) -> PCGResult:
    """Solve A x = b for SPD A, preconditioned by `diag` (Jacobi,
    M = diag^-1) or an explicit SPD apply `M(r) -> z`."""
    if M is None:
        inv_diag = 1.0 / diag
        M = lambda r: inv_diag * r  # noqa: E731
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    b_norm = torch.sqrt(torch.dot(b, b))
    b_norm = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))
    tol_abs2 = float((tol * b_norm) ** 2)
    k = 0
    # a NaN residual fails the test too, so a diverged solve stops at once
    while k < maxiter and float(torch.dot(r, r)) > tol_abs2:
        Ap = A(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    rel = torch.sqrt(torch.dot(r, r)) / b_norm
    return PCGResult(x=x, iters=k, rel_residual=rel, converged=bool(rel <= tol))


def pcg_fixed(A: Callable, b: torch.Tensor, diag=None, n_iters: int = 100, M=None):
    """Fixed-iteration PCG: deterministic work, no host synchronization;
    returns (x, ||r||/||b||)."""
    if M is None:
        inv_diag = 1.0 / diag
        M = lambda r: inv_diag * r  # noqa: E731
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(n_iters):
        Ap = A(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, torch.sqrt(torch.dot(r, r)) / torch.sqrt(torch.dot(b, b))
