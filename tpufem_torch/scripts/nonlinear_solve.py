"""Large-deflection static CLI — port of ``scripts/nonlinear_solve.py``: the
total-Lagrangian StVK Newton-Krylov solve of one wing.

Ramps the pressure load, Newton-iterates the geometrically nonlinear
equilibrium with exact tangents (kernel I on the card) and the linear
stencil-MG V-cycle as preconditioner (tpufem_torch.fem.nonlinear), and
reports nonlinear-vs-linear tip deflection and the max Cauchy von Mises
stress: the membrane-stiffening correction the linear model overpredicts.
The report has tpufem's keys. --device is the port's (default cuda; raises
without one; --cpu means --device cpu).

Example:
    python -m tpufem_torch.scripts.nonlinear_solve --n_steps 4 --glb \
        --out results/nonlinear_demo
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpufem_torch.scripts import device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--span", type=float, default=1.6)
    ap.add_argument("--chord", type=float, default=0.3)
    ap.add_argument("--sweep", type=float, default=0.0)
    ap.add_argument("--thickness", type=float, default=0.08)
    ap.add_argument("--pressure", type=float, default=1.5e5,
                    help="applied pressure (Pa); the slender-wing default gives "
                         "~15%% span deflection at the 16x24x4 default mesh")
    ap.add_argument("--n_chord", type=int, default=16)
    ap.add_argument("--n_span", type=int, default=24)
    ap.add_argument("--n_thick", type=int, default=4)
    ap.add_argument("--n_steps", type=int, default=4)
    ap.add_argument("--newton_tol", type=float, default=1e-8)
    ap.add_argument("--max_newton", type=int, default=16)
    ap.add_argument("--inner_tol", type=float, default=1e-10)
    ap.add_argument("--inner_maxiter", type=int, default=800)
    ap.add_argument("--chunk_iters", type=int, default=200)
    ap.add_argument("--glb", action="store_true",
                    help="write deformed-wing GLBs (nonlinear + linear)")
    ap.add_argument("--out", default="results/nonlinear")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg("cpu" if args.cpu else args.device)

    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.nonlinear import WingNonlinear, stvk_cauchy_stress
    from tpufem_torch.fem.stencil import to_grid
    from tpufem_torch.mesher import WingMeshResolution

    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick, 0.006, "le")
    p4 = (args.span, args.chord, args.sweep, args.thickness)
    solver = WingNonlinear(
        res, p4, pressure=args.pressure,
        inner_tol=args.inner_tol, inner_maxiter=args.inner_maxiter,
        chunk_iters=args.chunk_iters, device=device,
    )
    t0 = time.perf_counter()
    out = solver.solve(
        n_steps=args.n_steps, newton_tol=args.newton_tol,
        max_newton=args.max_newton,
    )
    wall = time.perf_counter() - t0

    mag_nl = float(np.linalg.norm(out.u, axis=1).max())
    mag_lin = float(np.linalg.norm(out.u_linear, axis=1).max())

    # per-element nonlinear Cauchy vs linear von Mises (max over elements)
    lam, mu = lame_params(Material())
    ug = to_grid(res, torch.as_tensor(out.u[:, :, None], dtype=torch.float64, device=device))
    sig = stvk_cauchy_stress(res, solver._geo64, ug, solver._free64, lam, mu).cpu().numpy()
    # sig: (6,3,3,B,nc,nt,ns) -> voigt-free von Mises straight from the tensor
    s = sig[:, :, :, 0]
    dev = s - (np.trace(s, axis1=1, axis2=2) / 3.0)[:, None, None]
    vm_nl = float(np.sqrt(1.5 * (dev * dev).sum(axis=(1, 2))).max())

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    record = {
        "params": {"span_m": args.span, "chord_m": args.chord,
                   "sweep_deg": args.sweep, "thickness_ratio": args.thickness},
        "pressure_pa": args.pressure,
        "resolution": [args.n_chord, args.n_span, args.n_thick],
        "n_dof": 3 * solver.num_nodes,
        "converged": out.converged,
        "rel_residual": out.rel_residual,
        "newton_iters": out.newton_iters,
        "cg_iters": out.cg_iters,
        "load_steps": out.history,
        "tip_deflection_m": {"nonlinear": mag_nl, "linear": mag_lin,
                             "stiffening_pct": round(100 * (1 - mag_nl / mag_lin), 3)
                             if mag_lin > 0 else 0.0},
        "max_von_mises_pa": {"nonlinear_cauchy": vm_nl},
        "wall_s": round(wall, 3),
        "solver": "TL-StVK Newton-Krylov, exact tangent (kernel I on the card), linear "
                  "stencil-MG V-cycle preconditioner (tpufem_torch.fem.nonlinear)",
    }
    (outdir / "nonlinear_report.json").write_text(json.dumps(record, indent=2))
    print(json.dumps(record, indent=2))

    if args.glb:
        from tpufem_torch.viz.colormaps import normalize_range, viridis
        from tpufem_torch.viz.glb import GLBMesh, write_glb

        mesh = solver.mesh
        for name, u in (("nonlinear", out.u), ("linear", out.u_linear)):
            amp = np.linalg.norm(u, axis=1)
            peak = float(amp.max()) or 1.0
            verts = (mesh.nodes + u).astype(np.float32)
            rgb = viridis(normalize_range(amp, 0.0, peak))
            rgba = np.concatenate([rgb, np.ones((len(rgb), 1))], axis=1)
            write_glb(
                outdir / f"wing_{name}_deformed.glb",
                GLBMesh(vertices=verts, faces=mesh.surf_faces, colors=rgba, name=name),
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
