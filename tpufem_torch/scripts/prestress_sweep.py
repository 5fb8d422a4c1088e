"""Frequency-vs-load sweep CLI — port of ``scripts/prestress_sweep.py``:
stress-stiffened modal spectra up to buckling.

One static pre-solve gives sigma0, WingBuckling gives the critical factor
lambda_cr, then WingPrestressedModal sweeps the (K + p K_G, M) pencil over
load factors p — the classic frequency-collapse curve (f1 -> 0 as
p -> lambda_cr) used to read buckling margins from vibration tests. Each
point warm-starts from the previous subspace. The report has tpufem's keys.
--device is the port's (default cuda; raises without one; --cpu means
--device cpu).

Example:
    python -m tpufem_torch.scripts.prestress_sweep --pressure 5e3 \
        --n_modes 4 --n_points 8 --out results/prestress_sweep
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
    ap.add_argument("--n_points", type=int, default=8,
                    help="sweep points from 0 to max_frac*lambda_cr")
    ap.add_argument("--max_frac", type=float, default=0.95,
                    help="top of the sweep as a fraction of lambda_cr (the "
                         "pencil is singular AT lambda_cr; CG slows as the "
                         "lowest mode softens)")
    ap.add_argument("--load_factors", type=float, nargs="*", default=None,
                    help="explicit load factors (skips the buckling pre-solve)")
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--inner_tol", type=float, default=1e-8)
    ap.add_argument("--inner_maxiter", type=int, default=800)
    ap.add_argument("--chunk_iters", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="eigenvalue relative-change stop per sweep point")
    ap.add_argument("--max_sweeps", type=int, default=40)
    ap.add_argument("--buckling_tol", type=float, default=1e-5)
    ap.add_argument("--out", default="results/prestress_sweep")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg("cpu" if args.cpu else args.device)

    from tpufem_torch.fem.buckling import WingBuckling, WingPrestressedModal
    from tpufem_torch.mesher import WingMeshResolution

    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick, 0.006, "le")
    p4 = (args.span, args.chord, args.sweep, args.thickness)
    kw = dict(
        pressure=args.pressure, inner_tol=args.inner_tol,
        inner_maxiter=args.inner_maxiter, chunk_iters=args.chunk_iters,
        device=device,
    )

    t0 = time.perf_counter()
    lam_cr = None
    if args.load_factors is not None:
        factors = list(args.load_factors)
    else:
        wb = WingBuckling(res, p4, **kw)
        bout = wb.solve(n_modes=1, tol=args.buckling_tol)
        lam_cr = bout.load_factor
        factors = list(np.linspace(0.0, args.max_frac * lam_cr, args.n_points))
        print(f"[prestress] lambda_cr = {lam_cr:.1f} "
              f"({bout.sweeps} sweeps, converged={bout.converged})", flush=True)

    wpm = WingPrestressedModal(res, p4, **kw)
    outs = wpm.frequency_sweep(
        factors, n_modes=args.n_modes, block=args.block, tol=args.tol,
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
        "n_dof": 3 * wpm.num_nodes,
        "lambda_cr": lam_cr,
        "load_factors": factors,
        "freqs_hz": [o.freqs_hz.tolist() for o in outs],
        "sweeps": [o.sweeps for o in outs],
        "converged": [bool(o.converged) for o in outs],
        "max_eig_residual": [float(o.eig_residual.max()) for o in outs],
        "wall_s": round(wall, 3),
    }
    (outdir / "prestress_sweep.json").write_text(json.dumps(record, indent=2))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
