"""Verify WingStencilT's certified branches — port of
``scripts/verify_stencil_solver.py``.

Drives both certified branches, refine (refine_steps=6, inner_tol=1e-3) and
outer_f64, on a small wing mesh (24x32x4, LE spacing, two wings), checks
that both converged, that they agree on the solution (1e-5 of the largest
displacement), that each case is within 1e-6 of an independent scipy direct
factorization of the same discrete system (fem.refsolve.direct_solve), and
the spec physics judgments (tip sag, root vM > 3x tip vM). Raises on any
miss; prints "VERIFY s3 OK" at the end.

    python -m tpufem_torch.scripts.verify_stencil_solver [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpufem_torch.scripts import device_arg

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]], np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg(args.device)

    from tpufem_torch.fem.refsolve import direct_solve
    from tpufem_torch.fem.stencil_mg import WingStencilT
    from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh
    from tpufem_torch.sets import build_boundary_sets

    res = WingMeshResolution(24, 32, 4, te_floor_frac=0.006, spacing="le")
    st = WingStencilT(res, device=device, dtype=torch.float32)

    t0 = time.time()
    out = st.solve(P4, pressure=5e3, tol=1e-6, maxiter=2000, chunk_iters=200,
                   refine_steps=6, inner_tol=1e-3)
    rel_r = out.rel_residual.cpu().numpy()
    print(f"refine: iters={out.iters} rel={rel_r} conv={out.converged.cpu().numpy()}"
          f" ({time.time() - t0:.1f}s)", flush=True)
    assert bool(out.converged.all()), rel_r
    assert out.u.dtype == torch.float64

    t0 = time.time()
    o64 = st.solve(P4, pressure=5e3, tol=1e-6, maxiter=2000, chunk_iters=200, outer_f64=True)
    rel64 = o64.rel_residual.cpu().numpy()
    print(f"outer64: iters={o64.iters} rel={rel64} conv={o64.converged.cpu().numpy()}"
          f" ({time.time() - t0:.1f}s)", flush=True)
    assert bool(o64.converged.all()), rel64

    # the two certified paths must agree on the solution
    u_r, u64 = out.u.cpu().numpy(), o64.u.cpu().numpy()
    du = np.abs(u_r - u64).max()
    su = np.abs(u64).max()
    print(f"refine-vs-outer64 solution agreement: {du / su:.3e}", flush=True)
    assert du / su < 1e-5

    # independent anchor: scipy direct factorization of the same system
    vm64 = o64.vm.cpu().numpy()
    for b in range(P4.shape[0]):
        mesh = structured_wing_mesh(*P4[b], res)
        sets = build_boundary_sets(mesh)
        u_ref, _, _ = direct_solve(mesh, sets, pressure=5e3)
        u = u64[:, :, b]
        err = np.abs(u - u_ref).max() / np.abs(u_ref).max()
        print(f"case {b}: vs scipy direct rel err {err:.3e}", flush=True)
        assert err < 1e-6, err

        # physics judgments (reference spec.md:309-353 analog)
        vm = vm64[:, b]
        y = mesh.nodes[:, 1]
        span = y.max() - y.min()
        tip = y > y.max() - 0.15 * span
        root = y < y.min() + 0.15 * span
        tip_uz = u[tip, 2].mean()
        ratio = vm[root].mean() / max(vm[tip].mean(), 1e-12)
        print(f"case {b}: tip mean u_z {tip_uz:.3e}  root/tip vM {ratio:.1f}", flush=True)
        assert tip_uz < 0, "wing must sag under upper-surface pressure"
        assert ratio > 3.0, "root stress must dominate tip"

    print("VERIFY s3 OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
