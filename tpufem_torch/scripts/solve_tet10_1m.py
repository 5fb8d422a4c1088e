"""Solve the flagship tet10 wing on one card — port of
``scripts/solve_tet10_1m.py``.

Runs a p-multigrid MG-PCG solver on the DOF1M_TET10 structured wing
(96x128x8 cells, 2.51M DOF) at the spec material and pressure: the
doubled-grid engine (tpufem_torch.fem.tet10_stencil.Tet10StencilT, kernel L;
the default) or with --engine gather the incidence-gather engine
(tpufem_torch.fem.tet10_mg.Tet10MGSolver, kernel N), judging
convergence on the TRUE f64 residual (mixed-precision refinement by
default), then certifies the solution on the host in 80-bit extended
precision (tpufem_torch.fem.xprec). Prints one JSON line with tpufem's keys:
DOF count, iterations, relative residual and wall time.

--device is the port's (default cuda; raises without one). --chunk and
--elem_chunk are accepted for tpufem's flag set: they bounded a TPU
dispatch's length and HBM temporaries.

Example:
    python -m tpufem_torch.scripts.solve_tet10_1m --refine 8 [--engine gather]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from tpufem_torch.mesher import DOF1M_TET10
from tpufem_torch.scripts import device_arg

RESOLUTION = DOF1M_TET10  # the wing the CLI solves
P4 = (1.6, 0.4, 20.0, 0.10)  # span, chord, sweep, thickness ratio


def main(argv=None) -> int:
    rec, _ = run(argv)
    print(json.dumps(rec), flush=True)
    return 0


def run(argv=None):
    """The CLI's work: (the JSON record, {"out": the solve's result (one
    wing: u (N10,3), vm (N10,)), "solver", "mesh", "sets"})."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the TRUE f64 residual evaluation itself floors around 7e-6 relative at
    # this mesh's conditioning (tpufem measured it): tol 1e-5 is the bar f64
    # arithmetic can certify at the flagship scale
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=600)
    ap.add_argument("--chunk", type=int, default=50,
                    help="accepted for tpufem's flag set (it bounded a TPU dispatch)")
    ap.add_argument("--pressure", type=float, default=5e3)
    ap.add_argument("--f32_outer", action="store_true",
                    help="recurred-f32 residual instead of true f64")
    ap.add_argument("--refine", type=int, default=6,
                    help="mixed-precision refinement rounds (f64 true residual "
                         "+ f32 correction solves); 0 = full f64 outer CG")
    ap.add_argument("--inner_tol", type=float, default=1e-4)
    ap.add_argument("--elem_chunk", type=int, default=73344,
                    help="accepted for tpufem's flag set (it bounded TPU HBM temporaries)")
    ap.add_argument("--no_xprec", action="store_true",
                    help="skip the host 80-bit extended-precision residual "
                         "certification of the final solution")
    ap.add_argument("--engine", choices=("stencil", "gather"), default="stencil",
                    help="'stencil' (default): the doubled-grid tet10 operator "
                         "(kernel L); 'gather': the incidence-gather p-MG (kernel N)")
    ap.add_argument("--repeat", action="store_true",
                    help="solve twice and report the second wall as the headline; "
                         "first-run wall in detail")
    ap.add_argument("--smooth_degree", type=int, default=2,
                    help="Chebyshev smoother degree (stencil engine)")
    ap.add_argument("--smooth_alpha", type=float, default=0.25,
                    help="Chebyshev lmin/lmax ratio (stencil engine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg(args.device)

    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.tet10 import (
        pressure_loads_t6,
        tet10_root_nodes,
        tet10_setup,
        tet10_upper_t6,
    )
    from tpufem_torch.fem.xprec import tet10_residual_xprec
    from tpufem_torch.mesher import structured_wing_mesh
    from tpufem_torch.sets import build_boundary_sets

    res = RESOLUTION
    t_mesh = time.perf_counter()
    mesh = structured_wing_mesh(*P4, res)
    bs = build_boundary_sets(mesh)
    if args.engine == "stencil":
        from tpufem_torch.fem.tet10_stencil import Tet10StencilT

        solver = Tet10StencilT(res, dtype=torch.float32, smooth_degree=args.smooth_degree,
                               smooth_alpha=args.smooth_alpha, device=device)
        t10 = solver.t10
    else:
        from tpufem_torch.fem.tet10 import tet10_from_tet4
        from tpufem_torch.fem.tet10_mg import Tet10MGSolver

        t10 = tet10_from_tet4(mesh)
        solver = Tet10MGSolver(res, t10, dtype=torch.float32, elem_chunk=args.elem_chunk or None,
                               device=device)
    mesh_s = time.perf_counter() - t_mesh
    dof = 3 * t10.num_nodes
    print(f"mesh: {t10.num_nodes} tet10 nodes, {len(t10.tet10)} tets, "
          f"{dof} DOF ({mesh_s:.1f} s host)", flush=True)
    free = np.ones((t10.num_nodes, 3), np.float64)
    free[tet10_root_nodes(t10)] = 0.0

    def run_once():
        kw = dict(pressure=args.pressure, tol=args.tol, maxiter=args.maxiter,
                  chunk_iters=args.chunk, outer_f64=(args.refine == 0 and not args.f32_outer),
                  refine_steps=0 if args.f32_outer else args.refine,
                  inner_tol=args.inner_tol, progress=True)
        if args.engine == "stencil":
            b = solver.solve(np.array([P4]), bs.surf_upper_faces, **kw)
            out = SimpleNamespace(u=b.u[:, :, 0], vm=b.vm[:, 0], iters=int(b.iters),
                                  rel_residual=float(np.max(b.rel_residual)),
                                  converged=bool(np.all(b.converged)))
        else:
            out = solver.solve(P4, bs.surf_upper_faces, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = run_once()
    wall = time.perf_counter() - t0
    cold_wall = wall
    if args.repeat:
        t0 = time.perf_counter()
        out = run_once()
        wall = time.perf_counter() - t0
        print(f"rerun: {wall:.1f} s (first run: {cold_wall:.1f} s)", flush=True)
    timing = dict(solver.last_timing)
    u, vm = out.u, out.vm

    xprec_rel = None
    if not args.no_xprec and not args.f32_outer:
        # certify the solution on the host in 80-bit extended precision, below
        # the reach of f64 CG recurrence drift and of f64 residual evaluation
        t_x = time.perf_counter()
        lam, mu = lame_params(Material())
        nodes64 = torch.as_tensor(t10.nodes10(mesh.nodes), dtype=torch.float64)
        conn = torch.as_tensor(t10.tet10)
        Jinv64, vols64 = tet10_setup(nodes64, conn)
        ut6 = tet10_upper_t6(t10, bs.surf_upper_faces)
        b64 = pressure_loads_t6(nodes64, ut6, args.pressure, t10.num_nodes).numpy() * free
        xprec_rel, _ = tet10_residual_xprec(
            Jinv64.numpy(), vols64.numpy(), t10.tet10, b64, u, free, float(lam), float(mu),
        )
        timing["xprec_s"] = time.perf_counter() - t_x
        print(f"xprec (80-bit host) TRUE rel: {xprec_rel:.3e} "
              f"({timing['xprec_s']:.1f} s)", flush=True)

    rec = {
        "metric": "fem_tet10_1mdof_mg_pcg_single_chip",
        "value": round(wall, 3),
        "unit": "s",
        "detail": {
            "dof": int(dof),
            "num_tet10": int(len(t10.tet10)),
            "iters": int(out.iters),
            "rel_residual": float(out.rel_residual),
            "converged": bool(out.converged),
            "tol": args.tol,
            "residual_metric": ("recurred f32" if args.f32_outer
                                else "true f64 residual"),
            "xprec_rel_residual": xprec_rel,
            "mode": ("f32" if args.f32_outer
                     else f"refine x{args.refine}" if args.refine else "f64 outer"),
            "engine": args.engine,
            "first_run_incl_compile_s": round(cold_wall, 3),
            "max_vm_mpa": round(float(np.max(vm)) / 1e6, 3),
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device)),
            "timing_s": timing,
            "peak_device_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                         if device.type == "cuda" else None),
        },
    }
    return rec, {"out": out, "solver": solver, "mesh": mesh, "sets": bs}


if __name__ == "__main__":
    sys.exit(main())
