"""Gradient-based wing sizing with adjoint FEM derivatives — port of
``scripts/optimize_wing.py``.

Minimizes structural mass (wing volume) subject to a stress constraint,
using exact design gradients from tpufem_torch.fem.adjoint: each optimizer
step differentiates through the full MG-PCG solve (the adjoint method; the
backward is one more solve). A batch of B designs with different fixed
(span, sweep) optimizes in parallel in the solver's trailing batch lanes.

    L(p) = V(p)/V_ref + w * softplus(smax_vM(p)/sigma_allow - 1)^2

Free variables: chord and thickness_ratio (bounded to the PRD box via a
sigmoid reparameterization); span and sweep stay at their per-lane values.
The optimizer is torch.optim.Adam with optax.adam's defaults (betas 0.9,
0.999, eps 1e-8), the same update. The output JSON has tpufem's keys;
"device" names the card. --device is the port's (default cuda; raises
without one).
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

FIXED_SPAN_SWEEP = np.array([[1.0, 5.0], [1.4, 15.0], [1.8, 25.0], [2.2, 35.0]], np.float64)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, log(1 + exp(x)) = logaddexp(x, 0), with no threshold
    (torch's softplus returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n_chord", type=int, default=32)
    ap.add_argument("--n_span", type=int, default=40)
    ap.add_argument("--n_thick", type=int, default=4)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--pressure", type=float, default=5e3)
    ap.add_argument("--sigma_allow", type=float, default=4e7,
                    help="allowable smooth-max von Mises [Pa]")
    ap.add_argument("--penalty", type=float, default=25.0)
    ap.add_argument("--refresh_every", type=int, default=20,
                    help="rebuild the frozen V-cycle at the current designs "
                         "every K steps (0 = never)")
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--out", default="results/wing_optimization.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg(args.device)

    from tpufem_torch.fem.adjoint import DifferentiableWingFEM
    from tpufem_torch.mesher import WingMeshResolution
    from tpufem_torch.pipeline.types import PRD_RANGES

    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick, 0.006, "le")
    # four design points: (span, sweep) fixed per lane, chord+thickness free
    fixed = torch.as_tensor(FIXED_SPAN_SWEEP, device=device)
    B = fixed.shape[0]
    c_lo, c_hi = PRD_RANGES["chord_m"]
    t_lo, t_hi = PRD_RANGES["thickness_ratio"]

    def assemble_p4(theta):
        """theta (B,2) unconstrained -> p4 (B,4) inside the PRD box."""
        c = c_lo + (c_hi - c_lo) * torch.sigmoid(theta[:, 0])
        t = t_lo + (t_hi - t_lo) * torch.sigmoid(theta[:, 1])
        return torch.stack([fixed[:, 0], c, fixed[:, 1], t], dim=1)

    # start mid-box
    theta = torch.zeros((B, 2), dtype=torch.float64, device=device, requires_grad=True)
    with torch.no_grad():
        p0 = assemble_p4(theta).cpu().numpy()
    fem = DifferentiableWingFEM(res, p0, pressure=args.pressure, tol=args.tol, maxiter=3000,
                                device=device)
    with torch.no_grad():
        v_ref = fem.volume(p0)

    def loss(theta):
        p4 = assemble_p4(theta)
        u = fem.solve(p4)
        v = fem.volume(p4) / v_ref
        smax = fem.smooth_max_vm(p4, u)
        viol = softplus((smax / args.sigma_allow - 1.0) * 20.0) / 20.0
        lanes = v + args.penalty * viol**2
        return lanes.sum(), (v, smax)

    opt = torch.optim.Adam([theta], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    hist = []
    t0 = time.time()
    for k in range(args.steps):
        opt.zero_grad()
        val, (v, smax) = loss(theta)
        val.backward()
        opt.step()
        if args.refresh_every and (k + 1) % args.refresh_every == 0:
            with torch.no_grad():
                fem.refresh(assemble_p4(theta).cpu().numpy())
        rec = {
            "step": k,
            "loss": float(val.detach()),
            "volume_ratio": [round(float(x), 4) for x in v.detach().cpu().numpy()],
            "smax_MPa": [round(float(x) / 1e6, 2) for x in smax.detach().cpu().numpy()],
        }
        hist.append(rec)
        if k % 5 == 0 or k == args.steps - 1:
            print(json.dumps(rec), flush=True)

    with torch.no_grad():
        p_fin = assemble_p4(theta).cpu().numpy()
    out = {
        "resolution": [args.n_chord, args.n_span, args.n_thick],
        "dof": int(fem.st.num_nodes * 3),
        "sigma_allow_MPa": args.sigma_allow / 1e6,
        "fixed_span_sweep": FIXED_SPAN_SWEEP.tolist(),
        "final_params": p_fin.tolist(),
        "final_volume_ratio": hist[-1]["volume_ratio"],
        "final_smax_MPa": hist[-1]["smax_MPa"],
        "initial_volume_m3": [float(x) for x in v_ref.cpu().numpy()],
        "steps": args.steps,
        "wall_s": round(time.time() - t0, 1),
        "history": hist,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}: final volume ratios {hist[-1]['volume_ratio']} "
          f"smax {hist[-1]['smax_MPa']} MPa (allow {args.sigma_allow / 1e6:.0f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
