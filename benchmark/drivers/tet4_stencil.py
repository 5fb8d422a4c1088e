"""The system under test for a tet4 stencil configuration: the port's
batched wing solve as dataset generation runs it,
`WingStencilT(res, dtype=float32).solve(p4, pressure, material, tol,
maxiter, outer_f64=True)`: the f64-operator CG with the f32 V-cycle as
preconditioner, certified on the TRUE f64 residual, and the f64 stress
recovery (`generate_fem_dataset --batched --engine stencil`).
"""

from __future__ import annotations

import torch

from benchmark import yardstick as ys


class Driver:
    def __init__(self, cfg: dict, device):
        from tpufem_torch.fem.material import Material
        from tpufem_torch.fem.stencil_mg import WingStencilT
        from tpufem_torch.mesher import WingMeshResolution

        self.cfg = cfg
        self.material = Material(E=cfg["youngs_pa"], nu=cfg["poisson"])
        self.solver = WingStencilT(WingMeshResolution(**cfg["mesh"]), device=device,
                                   dtype=torch.float32)

    def warm_up(self, p4) -> None:
        """The window's every shape and kernel, once: the solve of a batch of
        the window's size, stopped after `warmup_iters` CG iterations."""
        self.solve(p4, self.cfg["solve"]["warmup_iters"])

    def solve(self, p4, maxiter: int | None = None, outer_f64: bool = True) -> dict:
        """One batch p4 (B, 4): the program's u (N, 3, B) f64, vm (N, B), its
        lane flags, CG iterations and the wall-clock split of the call."""
        s = self.cfg["solve"]
        out = self.solver.solve(p4, pressure=self.cfg["pressure_pa"], material=self.material,
                                tol=s["tol"], maxiter=maxiter or s["maxiter"],
                                outer_f64=outer_f64)
        return {"u": out.u, "vm": out.vm, "converged": out.converged, "iters": out.iters,
                "rel": out.rel_residual, "timing": dict(self.solver.last_timing)}

    def solve_control(self, p4) -> dict:
        """The program's own lower-precision path on the same batch: the CG in
        float32 alone, judged on its recurred residual (outer_f64=False)."""
        return self.solve(p4, outer_f64=False)


def hierarchy(mesh: dict) -> list:
    """The V-cycle's (nc, nt, ns) cell grids: chord and span halved while both
    are even and keep >= 3 cells, the thickness halved while even."""
    out = [(mesh["n_chord"], mesh["n_thick"], mesh["n_span"])]
    while True:
        nc, nt, ns = out[-1]
        if nc % 2 or ns % 2 or nc // 2 < 3 or ns // 2 < 3:
            return out
        out.append((nc // 2, nt // 2 if nt % 2 == 0 and nt >= 2 else nt, ns // 2))


def grid_dofs(nc: int, nt: int, ns: int, lanes: int) -> int:
    return 3 * (nc + 1) * (nt + 1) * (ns + 1) * lanes


def vcycle_cost(levels: list, lanes: int, sharp_te: bool, dtype: str) -> ys.Cost:
    """One tet4 V-cycle: on each smoothed level 4 operator applies (the two
    degree-2 Chebyshev smoothers' and the two residuals') and 4 line solves,
    the transfers to the next level and back (each vector read once and
    written once); the coarsest level's dense inverse (B, n, n) read once."""
    c = ys.Cost()
    for (nc, nt, ns), nxt in zip(levels[:-1], levels[1:]):
        c += 4 * ys.b_apply(nc, nt, ns, lanes, dtype)
        c += 4 * ys.line_solve((nc + 1) * (ns + 1), 3 * (nt + 1), lanes, dtype)
        c += ys.vectors(grid_dofs(nc, nt, ns, lanes) + grid_dofs(*nxt, lanes), 2, dtype)
    nc, nt, ns = levels[-1]
    n = 3 * ((nc + 1) * (nt + 1) - nt * (2 if sharp_te else 1)) * (ns + 1)
    return c + ys.Cost(lanes * (n * n + 2 * n) * ys.ITEMSIZE[dtype],
                       {dtype: 2.0 * n * n * lanes})


def step_cost(cfg: dict, lanes: int) -> ys.Cost:
    """One CG iteration of the outer_f64 solve: the f64 operator apply, the
    CG vectors (x, r, p, Ap, z read, x, r, p written, f64), the V-cycle's f64
    input read and output written, and the f32 V-cycle."""
    levels = hierarchy(cfg["mesh"])
    n = grid_dofs(*levels[0], lanes)
    return (ys.b_apply(*levels[0], lanes, "float64") + ys.vectors(n, 10, "float64")
            + vcycle_cost(levels, lanes, cfg["mesh"]["te_floor_frac"] == 0.0, "float32"))
