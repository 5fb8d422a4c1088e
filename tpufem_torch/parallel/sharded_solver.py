"""Node-sharded Jacobi PCG (the f64 cross-check path) — port of
``tpufem/parallel/sharded_solver.py``.

tpufem wrote the wing solve with global semantics and NamedSharding
annotations and let XLA's SPMD partitioner insert the collectives around
its gather / scatter. Here they are explicit. Each rank owns a padded range
of the tets and of the nodes (the counts rounded up to a multiple of the
world size; padded tets are left out, padded nodes are constrained), and
each CG iteration's operator apply is:

    x_full = all_gather(x_own)                  # every rank's node range
    y_part = K x_full over the rank's tets      # kernel D
    y      = all_reduce_sum(y_part)             # gloo has no reduce_scatter
    y_own  = y[own range], masked

The Jacobi diagonal (assembly.stiffness_diagonal's element terms) and the
loads are the same sums over the rank's tets and faces (kernel E),
all-reduced. It is f64 only, as tpufem's (f32 Jacobi CG
diverges on wing meshes), and raises TypeError otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.assembly import build_incidence, stiffness_apply
from tpufem_torch.fem.elements import tet4_setup
from tpufem_torch.fem.loads import pressure_loads
from tpufem_torch.fem.stencil_mg import _cg_grid_init, _cg_grid_run
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum
from tpufem_torch.parallel.comm import all_gather, all_reduce_sum
from tpufem_torch.parallel.meshes import DeviceGroup


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def sharded_pcg_solve(
    group: DeviceGroup,
    nodes,
    tets,
    upper_faces,
    free_mask,
    pressure: float,
    lam: float,
    mu: float,
    tol: float = 1e-6,
    maxiter: int = 10000,
    axis: str = "mesh",
):
    """Solve the wing system with the nodes and tets range-sharded over the
    ranks of `group` (every rank calls it with the same global host arrays:
    nodes (N,3) f64, tets (T,4), upper_faces (F,3), free_mask (N*3,)).
    Returns (u (N,3) numpy, iters, rel_residual), the same on every rank."""
    del axis
    nodes = np.asarray(nodes)
    if nodes.dtype != np.float64:
        raise TypeError(
            "sharded_pcg_solve is a Jacobi-preconditioned f64 cross-check path; "
            "f32 Jacobi CG diverges on wing meshes (fem/precond.py). "
            "Use tpufem_torch.parallel.halo_pcg for production sharded solves.")
    W, d, dev = group.world, group.rank, group.device
    N, T, F = nodes.shape[0], len(tets), len(upper_faces)
    Np, Tp, Fp = _round_up(N, W), _round_up(T, W), _round_up(F, W)
    n_own, t_own, f_own = Np // W, Tp // W, Fp // W
    own = slice(d * n_own, (d + 1) * n_own)
    my_tets = np.asarray(tets, np.int32)[d * t_own: min((d + 1) * t_own, T)]  # no padding
    my_faces = np.asarray(upper_faces, np.int64)[d * f_own: min((d + 1) * f_own, F)]

    nodes_p = np.zeros((Np, 3))
    nodes_p[:N] = nodes
    free_p = np.zeros((Np, 3))
    free_p[:N] = np.asarray(free_mask).reshape(N, 3)  # padded nodes constrained
    X = torch.as_tensor(nodes_p, device=dev)
    free = torch.as_tensor(free_p, device=dev)
    tets_d = torch.as_tensor(my_tets, device=dev).contiguous()
    grads, vols = tet4_setup(X, tets_d.long())
    plan = build_incidence(my_tets, Np, dev)

    b = all_reduce_sum(group, pressure_loads(X, torch.as_tensor(my_faces, device=dev),
                                             float(pressure), csr_plan(my_faces, Np, dev)))
    b = (b * free)[own]
    # diag(K) over the rank's tets (stiffness_diagonal's element terms, summed
    # by kernel E), all-reduced; unit on constrained and untouched dofs
    g2 = grads**2
    dl = vols[:, None, None] * ((lam + mu) * g2 + mu * g2.sum(dim=2, keepdim=True))
    diag = all_reduce_sum(group, csr_segment_sum(dl.reshape(-1, 3), plan))
    diag = torch.where((free > 0) & (diag > 0), diag, torch.ones_like(diag))[own]
    free_own = free[own]

    def A(x):
        x_full = torch.cat(all_gather(group, x), dim=0)
        y = all_reduce_sum(group, stiffness_apply(grads, vols, tets_d, x_full * free, lam, mu,
                                                  plan))
        return y[own] * free_own + x * (1.0 - free_own)

    def dot(u_, v_):
        return all_reduce_sum(group, (u_ * v_).sum())

    cg = _cg_grid_init(A, lambda r: r / diag, dot, b, torch.zeros_like(b))
    cg, iters, rel, _ = _cg_grid_run(A, lambda r: r / diag, dot, cg, tol, maxiter)
    u = torch.cat(all_gather(group, cg[0] * free_own), dim=0)[:N]
    return u.cpu().numpy(), int(iters), float(rel)


def node_sharded_solve(group: DeviceGroup, res, params4, pressure: float = 200.0,
                       tol: float = 1e-10, maxiter: int = 20000) -> dict:
    """One rank's part of sharded_pcg_solve on the wing (params4) at `res`,
    as run_ranks runs it: u, iters and rel."""
    from tpufem_torch.fem.bc import dirichlet_mask
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.mesher import structured_wing_mesh
    from tpufem_torch.sets import build_boundary_sets

    wing = structured_wing_mesh(*params4, res)
    bs = build_boundary_sets(wing)
    free = dirichlet_mask(wing.num_nodes, bs.nroot_nodes, dtype=torch.float64).numpy()
    lam, mu = lame_params(Material())
    u, iters, rel = sharded_pcg_solve(group, wing.nodes.astype(np.float64), wing.tets,
                                      wing.surf_faces[bs.surf_upper_faces], free, pressure,
                                      lam, mu, tol=tol, maxiter=maxiter)
    return {"u": u, "iters": iters, "rel": rel}
