"""Modal analysis CLI — port of ``scripts/modal_analysis.py``: natural
frequencies + mode-shape GLBs for one wing.

Computes the smallest natural frequencies of the root-clamped wing with the
subspace iteration eigensolver (tpufem_torch.fem.modal) — block MG-PCG solves
on the trailing batch axis, host Rayleigh-Ritz — and writes a JSON record
(tpufem's keys) plus an exaggerated-deflection, |u|-colored GLB per mode for
the dashboard. --device is the port's (default cuda; raises without one;
--cpu is kept from tpufem and means --device cpu). --element tet10 runs
WingModal10, the doubled-grid p-multigrid on the quadratic element family.
--chunk_iters is accepted for tpufem's flag set; a block solve is one CG run
of up to --inner_maxiter steps.

Example:
    python -m tpufem_torch.scripts.modal_analysis --span 1.2 --chord 0.35 \
        --sweep 10 --thickness 0.10 --n_modes 6 --glb --out results/modal_demo
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from tpufem_torch.scripts import device_arg


def pressure_loads_np(nodes: np.ndarray, faces: np.ndarray, pressure: float) -> np.ndarray:
    """Nodal loads (N,3) of uniform pressure on outward faces (F,3), numpy
    (tpufem's refsolve.pressure_loads_np)."""
    v = nodes[faces]
    area_vec = 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    f_vert = (-pressure / 3.0) * area_vec
    f = np.zeros_like(nodes)
    for k in range(3):
        np.add.at(f, faces[:, k], f_vert)
    return f


def main(argv=None) -> int:
    record, _, _ = run(argv)
    print(json.dumps(record))
    return 0


def run(argv=None):
    """The CLI's work: (the report record, the ModalResult, the solver)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--span", type=float, default=1.2)
    ap.add_argument("--chord", type=float, default=0.35)
    ap.add_argument("--sweep", type=float, default=10.0)
    ap.add_argument("--thickness", type=float, default=0.10)
    ap.add_argument("--n_chord", type=int, default=32)
    ap.add_argument("--n_span", type=int, default=40)
    ap.add_argument("--n_thick", type=int, default=4)
    ap.add_argument("--n_modes", type=int, default=6)
    ap.add_argument("--element", choices=("tet4", "tet10"), default="tet4",
                    help="element family: tet4 (grid stencil MG) or tet10 "
                         "(doubled-grid p-MG, the flagship family)")
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--inner_tol", type=float, default=1e-8)
    ap.add_argument("--inner_maxiter", type=int, default=400)
    ap.add_argument("--chunk_iters", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-9,
                    help="eigenvalue relative-change stop")
    ap.add_argument("--max_sweeps", type=int, default=40)
    ap.add_argument("--smooth_degree", type=int, default=2)
    ap.add_argument("--smooth_alpha", type=float, default=0.25)
    ap.add_argument("--gust", action="store_true",
                    help="write the transient tip response to a 1-cosine "
                         "gust (duration 1.5/f1, modal superposition) to "
                         "gust_response.json")
    ap.add_argument("--frf", action="store_true",
                    help="write the tip frequency-response function (pressure "
                         "load, modal superposition, 2%% damping) to frf.json")
    ap.add_argument("--psd", action="store_true",
                    help="write the stationary von-Karman-gust random "
                         "response (RMS displacement field + modal RMS) to "
                         "psd_response.json")
    ap.add_argument("--gust_sigma_ms", type=float, default=2.0,
                    help="RMS vertical gust velocity sigma_w (m/s)")
    ap.add_argument("--turb_scale_m", type=float, default=50.0,
                    help="von Karman turbulence length scale L (m)")
    ap.add_argument("--airspeed_ms", type=float, default=30.0,
                    help="flight speed V; quasi-steady gust factor g = "
                         "gust_gain * w_g / V scales the pressure pattern")
    ap.add_argument("--gust_gain", type=float, default=1.0,
                    help="pressure sensitivity d(P/P0)/d(alpha) in 1/rad")
    ap.add_argument("--glb", action="store_true", help="write per-mode GLBs")
    ap.add_argument("--glb_scale", type=float, default=None,
                    help="mode deflection exaggeration (default: 15%% of span)")
    ap.add_argument("--out", default="results/modal")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg("cpu" if args.cpu else args.device)

    from tpufem_torch.fem.modal import WingModal, WingModal10
    from tpufem_torch.mesher import WingMeshResolution

    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick, 0.006, "le")
    p4 = (args.span, args.chord, args.sweep, args.thickness)
    cls = WingModal10 if args.element == "tet10" else WingModal
    wm = cls(
        res, p4,
        inner_tol=args.inner_tol, inner_maxiter=args.inner_maxiter,
        chunk_iters=args.chunk_iters,
        smooth_degree=args.smooth_degree, smooth_alpha=args.smooth_alpha,
        device=device,
    )
    t0 = time.perf_counter()
    out = wm.solve(
        n_modes=args.n_modes, block=args.block, tol=args.tol,
        max_sweeps=args.max_sweeps,
    )
    wall = time.perf_counter() - t0

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    record = {
        "params": {"span_m": args.span, "chord_m": args.chord,
                   "sweep_deg": args.sweep, "thickness_ratio": args.thickness},
        "resolution": [args.n_chord, args.n_span, args.n_thick],
        "element": args.element,
        "num_nodes": wm.num_nodes,
        "n_dof": 3 * wm.num_nodes,
        "freqs_hz": out.freqs_hz.tolist(),
        "eig_residual": out.eig_residual.tolist(),
        "sweeps": out.sweeps,
        "converged": out.converged,
        "wall_s": round(wall, 3),
    }
    (outdir / "modal_report.json").write_text(json.dumps(record, indent=2))

    def _pressure_force():
        if args.element == "tet10":
            import torch

            from tpufem_torch.fem.tet10 import pressure_loads_t6, tet10_upper_t6

            upper_t6 = tet10_upper_t6(wm.t10, wm.sets.surf_upper_faces)
            force = pressure_loads_t6(torch.as_tensor(wm.nodes10), upper_t6, 5e3,
                                      wm.num_nodes).numpy()
            y = wm.nodes10[:, 1]
        else:
            mesh = wm.mesh
            force = pressure_loads_np(
                mesh.nodes.astype(np.float64),
                mesh.surf_faces[wm.sets.surf_upper_faces], 5e3,
            )
            y = mesh.nodes[:, 1]
        tip = y > y.min() + 0.95 * (y.max() - y.min())
        return force, tip

    if args.frf:
        from tpufem_torch.fem.modal import harmonic_response

        force, tip = _pressure_force()
        fmax = 1.2 * out.freqs_hz[-1]
        fgrid = np.linspace(1.0, fmax, 400)
        u = harmonic_response(out, wm.mass, force, fgrid, zeta=0.02)
        amp = np.abs(u[:, tip, 2]).mean(axis=1)
        (outdir / "frf.json").write_text(json.dumps({
            "freqs_hz": fgrid.tolist(),
            "tip_uz_amplitude_m": amp.tolist(),
            "zeta": 0.02,
            "pressure_pa": 5e3,
        }))

    if args.gust:
        from tpufem_torch.fem.modal import transient_response

        force, tip = _pressure_force()
        f1 = out.freqs_hz[0]
        t_g = 1.5 / f1  # gust duration: 1.5 fundamental periods
        t = np.linspace(0.0, 6.0 / f1, 1200)
        g = np.where(t < t_g, 0.5 * (1 - np.cos(2 * np.pi * t / t_g)), 0.0)
        u = transient_response(out, force, g, t, zeta=0.02)
        tip_uz = u[:, tip, 2].mean(axis=1)
        (outdir / "gust_response.json").write_text(json.dumps({
            "t_s": t.tolist(),
            "gust_factor": g.tolist(),
            "tip_uz_m": tip_uz.tolist(),
            "gust_duration_s": t_g,
            "zeta": 0.02,
            "pressure_pa": 5e3,
        }))

    if args.psd:
        from tpufem_torch.fem.modal import random_response, von_karman_psd

        force, tip = _pressure_force()
        zeta = 0.02
        f1 = out.freqs_hz[0]
        fmax = 1.5 * out.freqs_hz[-1]
        df = min(zeta * f1 / 4.0, fmax / 2000.0)
        # log-spaced low-frequency segment: gust spectra are low-f heavy
        # (von Karman: most variance below V / (2 pi 1.339 L), typically
        # well under df) — a linear grid starting at df drops real variance
        flow = np.geomspace(df * 1e-3, df, 64, endpoint=False)
        fgrid = np.concatenate([flow, np.arange(1, int(fmax / df) + 1) * df])
        s_w = von_karman_psd(
            fgrid, args.gust_sigma_ms, args.turb_scale_m, args.airspeed_ms
        )
        s_g = (args.gust_gain / args.airspeed_ms) ** 2 * s_w
        rms_u, sig_q = random_response(out, wm.mass, force, fgrid, s_g,
                                       zeta=zeta)
        tip_rms = float(rms_u[tip, 2].mean())
        (outdir / "psd_response.json").write_text(json.dumps({
            "sigma_w_ms": args.gust_sigma_ms,
            "turb_scale_m": args.turb_scale_m,
            "airspeed_ms": args.airspeed_ms,
            "gust_gain": args.gust_gain,
            "zeta": zeta,
            "pressure_pa": 5e3,
            "freq_grid": [float(fgrid[0]), float(fgrid[-1]), len(fgrid)],
            "tip_rms_uz_m": tip_rms,
            "max_rms_u_m": float(rms_u.max()),
            "modal_rms": sig_q.tolist(),
            "freqs_hz": out.freqs_hz.tolist(),
        }, indent=2))

    if args.glb:
        from tpufem_torch.viz.colormaps import normalize_range, viridis
        from tpufem_torch.viz.glb import GLBMesh, write_glb

        if args.element == "tet10":
            base_nodes = wm.nodes10
            faces = wm.t10.surf_t6[:, :3]  # corner triangles of the T6 faces
        else:
            base_nodes = wm.mesh.nodes
            faces = wm.mesh.surf_faces
        scale0 = args.glb_scale
        for i in range(args.n_modes):
            phi = out.modes[:, :, i]
            amp = np.linalg.norm(phi, axis=1)
            peak = float(amp.max()) or 1.0
            scale = (0.15 * args.span / peak) if scale0 is None else scale0
            verts = (base_nodes + scale * phi).astype(np.float32)
            rgb = viridis(normalize_range(amp, 0.0, peak))
            rgba = np.concatenate([rgb, np.ones((len(rgb), 1))], axis=1)
            write_glb(
                outdir / f"mode_{i + 1:02d}_{out.freqs_hz[i]:.1f}hz.glb",
                GLBMesh(vertices=verts, faces=faces, colors=rgba,
                        name=f"mode{i + 1}"),
            )

    return record, out, wm


if __name__ == "__main__":
    sys.exit(main())
