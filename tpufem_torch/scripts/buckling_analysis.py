"""Linearized buckling CLI — port of ``scripts/buckling_analysis.py``:
critical load factors + mode GLBs for one wing.

Static pre-solve at the reference pressure -> per-element stress (kernel F
on the card) -> subspace iteration on the (K, -K_G) pencil
(tpufem_torch.fem.buckling; kernel G applies K_G). The reported load_factor
is the multiple of the applied pressure at which the linearized structure
loses stability. The report has tpufem's keys. --device is the port's
(default cuda; raises without one; --cpu means --device cpu).

Example:
    python -m tpufem_torch.scripts.buckling_analysis --pressure 5e3 \
        --n_modes 4 --glb --out results/buckling_demo
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from tpufem_torch.scripts import device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--span", type=float, default=1.2)
    ap.add_argument("--chord", type=float, default=0.35)
    ap.add_argument("--sweep", type=float, default=10.0)
    ap.add_argument("--thickness", type=float, default=0.10)
    ap.add_argument("--pressure", type=float, default=5e3)
    ap.add_argument("--n_chord", type=int, default=32)
    ap.add_argument("--n_span", type=int, default=40)
    ap.add_argument("--n_thick", type=int, default=4)
    ap.add_argument("--n_modes", type=int, default=4)
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--inner_tol", type=float, default=1e-8)
    ap.add_argument("--inner_maxiter", type=int, default=400)
    ap.add_argument("--chunk_iters", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-5,
                    help="load-factor relative-change stop (engineering precision;\n the clustered K_G pencil converges slowly below this)")
    ap.add_argument("--max_sweeps", type=int, default=60)
    ap.add_argument("--glb", action="store_true", help="write per-mode GLBs")
    ap.add_argument("--out", default="results/buckling")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg("cpu" if args.cpu else args.device)

    from tpufem_torch.fem.buckling import WingBuckling
    from tpufem_torch.mesher import WingMeshResolution

    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick, 0.006, "le")
    p4 = (args.span, args.chord, args.sweep, args.thickness)
    wb = WingBuckling(
        res, p4, pressure=args.pressure,
        inner_tol=args.inner_tol, inner_maxiter=args.inner_maxiter,
        chunk_iters=args.chunk_iters, device=device,
    )
    t0 = time.perf_counter()
    out = wb.solve(
        n_modes=args.n_modes, block=args.block, tol=args.tol,
        max_sweeps=args.max_sweeps,
    )
    wall = time.perf_counter() - t0

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    record = {
        "params": {"span_m": args.span, "chord_m": args.chord,
                   "sweep_deg": args.sweep, "thickness_ratio": args.thickness},
        "pressure_pa": args.pressure,
        "resolution": [args.n_chord, args.n_span, args.n_thick],
        "n_dof": 3 * wb.num_nodes,
        "load_factor": out.load_factor,
        "factors": [None if not np.isfinite(v) else v for v in out.factors],
        "sweeps": out.sweeps,
        "converged": out.converged,
        "wall_s": round(wall, 3),
    }
    (outdir / "buckling_report.json").write_text(json.dumps(record, indent=2))

    if args.glb:
        from tpufem_torch.viz.colormaps import normalize_range, viridis
        from tpufem_torch.viz.glb import GLBMesh, write_glb

        mesh = wb.mesh
        for i in range(args.n_modes):
            if not np.isfinite(out.factors[i]):
                continue
            phi = out.modes[:, :, i]
            amp = np.linalg.norm(phi, axis=1)
            peak = float(amp.max()) or 1.0
            scale = 0.15 * args.span / peak
            verts = (mesh.nodes + scale * phi).astype(np.float32)
            rgb = viridis(normalize_range(amp, 0.0, peak))
            rgba = np.concatenate([rgb, np.ones((len(rgb), 1))], axis=1)
            write_glb(
                outdir / f"buckling_mode_{i + 1:02d}_x{out.factors[i]:.0f}.glb",
                GLBMesh(vertices=verts, faces=mesh.surf_faces, colors=rgba,
                        name=f"buckling{i + 1}"),
            )

    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
