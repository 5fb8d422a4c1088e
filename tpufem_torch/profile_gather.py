"""Where the time of a gather-path CG iteration goes, on one CUDA card.

Solves the first wing of chip_smoke.py's seeded batch on the DOF100K mesh
through solve_wing_case (kernel D once per iteration: one launch per
operator apply) with a fixed number of CG iterations (tol 0), in the two
configurations the FEM stage runs: f32 with the thickness-line
preconditioner alone (the stage's "primary" rung on a mesh.npz, which keeps
no span-station count) and f64 with line + RBM (its "float64" rung on a
structured mesh). Each runs once unprofiled for the wall time, then once
under torch.profiler; prints device busy time, device activities per
iteration, the launches and device time per launch of kernels D
(stiffness_apply) and E (csr_segment_sum), and device time by op; the full
tables go to --out. Last, the cost of pcg's host sync per iteration (its
stopping test): the f32 line system through pcg and through pcg_fixed, which
runs the same iterations without reading anything back.

Usage: python -m tpufem_torch.profile_gather [--iters 500] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tpufem_torch.fem.bc import dirichlet_mask
from tpufem_torch.fem.driver import WingSolveConfig, _system, mesh_plans, solve_wing_case
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import line_blocks, make_line_preconditioner
from tpufem_torch.fem.solver import pcg, pcg_fixed
from tpufem_torch.mesher import DOF100K, structured_wing_mesh
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.sets import build_boundary_sets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--out", default=None, help="file for the full by-op tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gather: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    mesh = structured_wing_mesh(*map(float, seeded_batch(8)[0]), DOF100K)
    bs = build_boundary_sets(mesh)
    tables = []
    for label, dtype, two_level in (("f32 line", torch.float32, False),
                                    ("f64 line+RBM", torch.float64, True)):
        cfg = WingSolveConfig(dtype=dtype, two_level=two_level, tol=0.0, maxiter=args.iters)
        setup = WingSolveConfig(dtype=dtype, two_level=two_level, tol=0.0, maxiter=0)
        walls = {}
        for name, c in (("setup", setup), ("setup", setup), ("solve", cfg)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solve_wing_case(mesh, bs, c, device=dev)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        cg_s = walls["solve"] - walls["setup"]
        print(f"[{label}] {sol.iters} CG iterations: wall {walls['solve']:.3f} s, setup + "
              f"recovery {walls['setup']:.3f} s (maxiter=0), {cg_s / sol.iters * 1e3:.4f} ms "
              f"per iteration")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sol = solve_wing_case(mesh, bs, cfg, device=dev)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.time_range.elapsed_us() for e in dev_events) / 1e6
        print(f"[{label}] profiled: device busy {busy_s:.3f} s in {len(dev_events)} device "
              f"activities ({len(dev_events) / sol.iters:.0f} per iteration incl. setup); "
              f"{busy_s / walls['solve']:.1%} of the unprofiled wall")
        for kernel, name in (("D", "stiffness_apply"), ("E", "csr_segment_sum")):
            us = [e.time_range.elapsed_us() for e in dev_events if name in e.name]
            if us:
                print(f"[{label}] kernel {kernel} ({name}): {len(us)} launches, "
                      f"{sum(us) / len(us):.2f} us each, {sum(us) / 1e6 / busy_s:.1%} of the "
                      f"device busy time")
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
        tables.append(f"== {label}, {sol.iters} iterations ==\n{table}")
        print("\n".join(table.splitlines()[:20]))
    sync_cost(mesh, bs, dev, args.iters)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(tables))
    return 0


def sync_cost(mesh, bs, dev, iters: int) -> None:
    """ms per iteration of pcg (one host sync per iteration) against
    pcg_fixed (none) on the f32 line-preconditioned system, median of 3."""
    lam, mu = lame_params(Material())
    plans = mesh_plans(mesh, bs, dev, two_level=False)
    nodes = torch.as_tensor(mesh.nodes, dtype=torch.float32, device=dev)
    tets = torch.as_tensor(mesh.tets, dtype=torch.int32, device=dev)
    upper = torch.as_tensor(mesh.surf_faces[bs.surf_upper_faces], device=dev)
    free = dirichlet_mask(mesh.num_nodes, bs.nroot_nodes, dtype=torch.float32, device=dev)
    grads, vols, b, A = _system(nodes, tets, upper, free, plans, 5e3, lam, mu)
    M = make_line_preconditioner(plans["line"], line_blocks(plans["line"], grads, vols, lam,
                                                            mu, free))
    runs = {"pcg": lambda: pcg(A, b, M=M, tol=0.0, maxiter=iters),
            "pcg_fixed": lambda: pcg_fixed(A, b, n_iters=iters, M=M)}
    ms = {}
    for name, fn in list(runs.items()) * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t0) / iters * 1e3)
    med = {k: sorted(v)[1] for k, v in ms.items()}
    print(f"[f32 line] host sync of the stopping test: pcg {med['pcg']:.4f} ms per iteration, "
          f"pcg_fixed {med['pcg_fixed']:.4f} ms ({iters} iterations, median of 3): "
          f"{med['pcg'] - med['pcg_fixed']:.4f} ms per iteration")


if __name__ == "__main__":
    sys.exit(main())
