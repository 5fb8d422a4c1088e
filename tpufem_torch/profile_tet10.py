"""Kernels L (``fem.tet10_stencil.strain_apply10``) and M (``prolong_p`` /
``restrict_p``) on one CUDA card, and where the flagship tet10 CG
iteration's device time goes.

measure_L(): kernel L against strain_apply10_plain on a seeded displacement
(1e-3 x a normal field) at a wing's doubled grid, f64 and f32: the error over
the plain result's largest entry (bars 1e-12 in f64, 1e-5 in f32), the same
bits twice, one launch per call, then the median of 7 event timings of
kernel and plain version, and from torch.profiler windows
(utils/profiling.py::device_time) the device time per launch, repeated and
with the L2 flushed, and the device activities per call. The bound is the
larger of the bytes a call must move (u, the three gradients g[:, 1:] it
reads, vol and free2 once, y once) over the card's memory rate and
l_flops_per_tet() per Kuhn tet over the dtype's rate (tpufem_torch/device.py):
the flops of tpufem's formulation with the exact-zero DNDXI entries skipped.
No single PyTorch call computes the function.

measure_M(): kernel M's two entries on the same shapes, against their plain
versions (bars 1e-14 in f64, 1e-6 in f32 of the largest entry: the weld
rows' column sums run in another order), with the same times and a byte
bound; the library time is one torch.sparse.mm of the transfer's CSR matrix
(transfer_matrices) on the same field laid out as (nodes, 3 B).

iteration_profile(): the flagship CLI's f32 CG (Tet10StencilT at
DOF1M_TET10, one wing), `iters` iterations after a warm-up: ms per
iteration (CUDA events), then under torch.profiler the device busy time and
activities per iteration and the device time of L, M and B by kernel name;
line_apply10 and the tet4 V-cycle's line solves, whose GEMMs have no name of
their own, by their per-call device time (measured alone) times their
calls per iteration.

Usage: python -m tpufem_torch.profile_tet10 [--out PATH] [--iters N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from tpufem_torch.fem import stencil as st
from tpufem_torch.fem import tet10_stencil as ts
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.tet10 import DNDXI
from tpufem_torch.mesher import DOF1M_TET10, WingMeshResolution, structured_wing_mesh
from tpufem_torch.utils.profiling import device_time, median_event_ms

LAM, MU = lame_params(Material())
FLAGSHIP_P4 = (1.6, 0.4, 20.0, 0.10)  # scripts/solve_tet10_1m.py's wing
MODAL_RES = WingMeshResolution(32, 40, 4, 0.006, "le")  # modal_analysis's default grid
MODAL_P4 = (1.2, 0.35, 10.0, 0.10)
SHARP_RES = WingMeshResolution(16, 24, 4, 0.0, "le")
# label -> (grid, wings): the shapes chip_smoke.py's phase 9 launches L and M with
SHAPES = {
    "DOF1M_TET10 B=1": (DOF1M_TET10, [FLAGSHIP_P4]),
    "32x40x4 q=12": (MODAL_RES, [MODAL_P4] * 12),
    "16x24x4 sharp TE B=2": (SHARP_RES, [FLAGSHIP_P4, MODAL_P4]),
}
SOURCES = {"strain_apply10": "tpufem_torch/csrc/strain_apply10.cu",
           "prolong_p": "tpufem_torch/csrc/p_transfer.cu",
           "restrict_p": "tpufem_torch/csrc/p_transfer.cu"}
REPLACES = {"strain_apply10": "tpufem/fem/tet10_stencil.py:233",
            "prolong_p": "tpufem/fem/tet10_stencil.py:301",
            "restrict_p": "tpufem/fem/tet10_stencil.py:316"}
DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32"}
# kernel M against its plain version, of the largest entry: the weld rows'
# column sums run in another order
M_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
KERNEL_NAMES = {"strain_apply10": "strain_apply10_kernel", "prolong_p": "prolong_p_kernel",
                "restrict_p": "restrict_p_kernel"}
LETTERS = {"strain_apply10": "L", "prolong_p": "M", "restrict_p": "M"}
DESIGNS = {
    "strain_apply10": "a block per tile of own_j x own_i tet4 node columns at full thickness "
                      "(halo cells recomputed), a thread per cell walking its 6 tets with the "
                      "10 node forces in registers, shares in shared memory, a fixed-order "
                      "per-position sum with the welds: no atomics",
    "prolong_p": "a thread per doubled position: copy or edge mean of the weld-spread tet4 "
                 "field, times dup2 and free2",
    "restrict_p": "a thread per tet4 node gathering its position and the 14 incident edge "
                  "midpoints, then the weld reduce and free4: no atomics",
}


def l_flops_per_tet() -> int:
    """Flops of one Kuhn tet in tpufem's strain_apply10, the exact-zero DNDXI
    entries skipped: per Gauss point, v (3 components x the nonzero entries,
    an FMA each), H (27 FMA), sigma and its weighting (33), s (27 FMA) and
    the node forces (3 x the nonzero entries, an FMA each)."""
    nnz = int((np.abs(DNDXI) >= 1e-14).sum())  # over the 4 Gauss points
    return 2 * 3 * nnz + 4 * (2 * 27 + 33 + 2 * 27) + 2 * 3 * nnz


def l_inputs(res: WingMeshResolution, p4s, dtype, device, seed=0):
    """(geo, u, free2) of the wings p4s on res's doubled grid."""
    X2 = ts.nodes_grid2(res, torch.as_tensor(np.asarray(p4s), device=device), dtype)
    geo = ts.cell_geometry2(res, X2)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(X2.shape, generator=gen, device=device, dtype=dtype) * 1e-3
    return geo, u, ts.free_mask2(res, dtype, device)


def bound(nbytes: int, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_and_time(name, label, fn, plain, tol, nbytes_, flops, dtype, timed=True,
                   library=None) -> dict:
    """One kernel entry's checks (raises on a miss: one launch per call, the
    same bits twice, within tol of the plain result's largest entry) and,
    with `timed`, its times and bound."""
    counter = {"strain_apply10": ts.strain_apply10, "prolong_p": ts.prolong_p,
               "restrict_p": ts.restrict_p}[name]
    before = counter.launches
    y = fn()
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise RuntimeError(f"{name} {label}: {counter.launches - before} launches per call")
    if not torch.equal(y, fn()):
        raise RuntimeError(f"{name} {label}: two calls differ")
    ref = plain()
    scale = ref.abs().max().item()
    err = (y - ref).abs().max().item()
    if not err <= tol * scale:
        raise RuntimeError(f"{name} {label} {dtype}: max|err| {err:.3e} > {tol} x {scale:.3e}")
    rec = {"kernel": name, "case": label, "dtype": DTYPE_NAMES[dtype],
           "max_abs_err": err, "scale": scale, "rel_err": err / scale}
    if timed:
        bound_us, bound_by = bound(nbytes_, flops, dtype)
        r = device_time(fn, KERNEL_NAMES[name], cold=True)
        if r["launches"] != 1 or r["activities"] != 1:
            raise RuntimeError(f"{name} {label}: {r['launches']} launches and "
                               f"{r['activities']} device activities per call, not 1")
        rec.update(ms=median_event_ms(fn, 7), plain_ms=median_event_ms(plain, 7),
                   bound_us=bound_us, bound_by=bound_by, bytes=nbytes_, flops=flops,
                   device_us=r["device_us"], device_us_cold=r["device_us_cold"],
                   activities=r["activities"], share=bound_us / r["device_us_cold"],
                   share_repeated=bound_us / r["device_us"],
                   library_ms=median_event_ms(library, 7) if library else None)
    return rec


def measure_L(label, res, p4s, device, timed=True) -> dict:
    """Kernel L at `res` on the wings p4s, f64 and f32: {dtype: record}."""
    out = {}
    n_tets = 6 * res.n_chord * res.n_thick * res.n_span * len(p4s)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        geo, u, free2 = l_inputs(res, p4s, dtype, device)
        g, vol = geo
        moved = nbytes(u, g[:, 1:], vol, free2) + nbytes(u)  # y written once
        out[DTYPE_NAMES[dtype]] = {
            **check_and_time("strain_apply10", label,
                             lambda: ts.strain_apply10(res, geo, u, free2, LAM, MU),
                             lambda: ts.strain_apply10_plain(res, geo, u, free2, LAM, MU),
                             tol, moved, l_flops_per_tet() * n_tets, dtype, timed),
            "grid": list(res.key), "B": len(p4s)}
    return out


def weld_k(I, K, res: WingMeshResolution):
    """The layer a tet4 field is read from at node column I (the weld spread S)."""
    weld = (I == 0) | ((I == res.n_chord) & (res.te_floor_frac == 0.0))
    return np.where(weld, 0, K)


def transfer_matrices(res: WingMeshResolution, dtype, device):
    """(P, R): CSR matrices of prolong_p (doubled positions x tet4 nodes,
    rows masked by dup2 and free2) and restrict_p (its transpose before the
    row mask, rows masked by free4), for one lane."""
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    NI2, NK2, NJ2 = 2 * NI - 1, 2 * NK - 1, 2 * NJ - 1
    i2, k2, j2 = (a.reshape(-1) for a in np.meshgrid(np.arange(NI2), np.arange(NK2),
                                                      np.arange(NJ2), indexing="ij"))
    I, K, J = i2 // 2, k2 // 2, j2 // 2
    oi, ok, oj = i2 % 2, k2 % 2, j2 % 2
    corner = (oi | ok | oj) == 0
    col_a = (I * NK + weld_k(I, K, res)) * NJ + J
    col_b = ((I + oi) * NK + weld_k(I + oi, K + ok, res)) * NJ + J + oj
    row = np.arange(NI2 * NK2 * NJ2)
    rows = np.concatenate([row[corner], row[~corner], row[~corner]])
    cols = np.concatenate([col_a[corner], col_a[~corner], col_b[~corner]])
    vals = np.concatenate([np.ones(corner.sum()), np.full(2 * (~corner).sum(), 0.5)])
    m2 = (ts.dup_mask2(res, torch.float64) * ts.free_mask2(res, torch.float64)).reshape(-1)
    free4 = (np.arange(NI * NK * NJ) % NJ != 0).astype(np.float64)
    es = torch.sparse_coo_tensor(np.stack([rows, cols]), vals, (len(row), NI * NK * NJ))
    P = torch.sparse_coo_tensor(np.stack([rows, cols]), vals * m2.numpy()[rows], es.shape)
    R = torch.sparse_coo_tensor(np.stack([cols, rows]), vals * free4[cols], es.shape[::-1])
    return tuple(m.coalesce().to_sparse_csr().to(dtype=dtype, device=device) for m in (P, R))


def measure_M(label, res, B, device, timed=True) -> dict:
    """Kernel M's two entries at `res` with B lanes, f64 and f32:
    {"prolong_p f64": record, ...}."""
    out = {}
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=device).manual_seed(1)
        x4 = torch.randn((3, B, NI, NK, NJ), generator=gen, device=device, dtype=dtype)
        r2 = torch.randn((3, B, *ts._doubled(res)), generator=gen, device=device, dtype=dtype)
        dup2, free2 = ts.dup_mask2(res, dtype, device), ts.free_mask2(res, dtype, device)
        free4 = torch.ones((1, 1, 1, 1, NJ), dtype=dtype, device=device)
        free4[..., 0] = 0.0
        P, R = transfer_matrices(res, dtype, device)
        X = x4.reshape(3 * B, -1).t().contiguous()
        Y = r2.reshape(3 * B, -1).t().contiguous()
        # the library form computes the same maps (checked once here)
        lib_p = (P @ X).t().reshape(r2.shape)
        lib_r = (R @ Y).t().reshape(x4.shape)
        tol = M_TOL[dtype]
        for got, want in ((lib_p, ts.prolong_p_plain(res, x4, dup2, free2)),
                          (lib_r, ts.restrict_p_plain(res, r2, free4))):
            if not (got - want).abs().max().item() <= tol * want.abs().max().item():
                raise RuntimeError(f"{label}: the transfer matrices do not match kernel M's maps")
        d = DTYPE_NAMES[dtype]
        out[f"prolong_p {d}"] = {**check_and_time(
            "prolong_p", label, lambda: ts.prolong_p(res, x4, dup2, free2),
            lambda: ts.prolong_p_plain(res, x4, dup2, free2), tol,
            nbytes(x4, dup2, free2) + nbytes(r2), 0, dtype, timed,
            library=lambda: torch.sparse.mm(P, X)), "grid": list(res.key), "B": B}
        out[f"restrict_p {d}"] = {**check_and_time(
            "restrict_p", label, lambda: ts.restrict_p(res, r2, free4),
            lambda: ts.restrict_p_plain(res, r2, free4), tol,
            nbytes(r2, free4) + nbytes(x4), 0, dtype, timed,
            library=lambda: torch.sparse.mm(R, Y)), "grid": list(res.key), "B": B}
    return out


def line(rec) -> str:
    s = (f"[kernel {LETTERS[rec['kernel']]}] {rec['kernel']} {rec['case']} {rec['grid']} "
         f"B={rec['B']} {rec['dtype']}: max|err| {rec['max_abs_err']:.3e} (rel "
         f"{rec['rel_err']:.2e}), bitwise repeatable")
    if "ms" in rec:
        lib = (f"; library (torch.sparse.mm) {rec['library_ms']:.4f} ms"
               if rec["library_ms"] is not None else "; no one-call PyTorch equivalent")
        s += (f"; {rec['activities']:.0f} device activity per call; event {rec['ms']:.4f} ms vs "
              f"plain {rec['plain_ms']:.4f} ms (median of 7); device {rec['device_us']:.2f} us "
              f"repeated, {rec['device_us_cold']:.2f} us L2 flushed; bound "
              f"{rec['bound_us']:.2f} us ({rec['bound_by']}, {rec['bytes'] / 1e6:.1f} MB, "
              f"{rec['flops'] / 1e9:.3f} GFLOP): {rec['share']:.1%} flushed{lib}")
    return s


def flagship_solver(device):
    """(Tet10StencilT at DOF1M_TET10, the flagship wing's upper T6 faces)."""
    from tpufem_torch.fem.tet10 import tet10_upper_t6
    from tpufem_torch.sets import build_boundary_sets

    solver = ts.Tet10StencilT(DOF1M_TET10, device=device)
    bs = build_boundary_sets(structured_wing_mesh(*FLAGSHIP_P4, DOF1M_TET10))
    return solver, tet10_upper_t6(solver.t10, bs.surf_upper_faces)


def iteration_profile(device, iters: int = 40) -> dict:
    """Where the flagship f32 CG iteration's device time goes (module docstring)."""
    from tpufem_torch.fem.stencil_mg import _cg_grid_init, _cg_grid_run

    solver, ut6 = flagship_solver(device)
    lam, mu = (float(torch.tensor(v, dtype=torch.float32)) for v in (LAM, MU))
    p4 = np.array([FLAGSHIP_P4], np.float32)
    geo, Binv, bg, lmax, smg_state = solver.setup(p4, 5e3, ut6, lam, mu)
    A, M, dot = solver.ops(geo, Binv, lmax, smg_state, lam, mu)
    cg = _cg_grid_init(A, M, dot, bg, torch.zeros_like(bg))
    run = lambda: _cg_grid_run(A, M, dot, cg, 0.0, iters)  # noqa: E731  (tol 0: never stops)
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    counters = {"L": ts.strain_apply10, "M prolong": ts.prolong_p, "M restrict": ts.restrict_p,
                "B": st.strain_apply}
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: (c.launches - before[k]) / iters for k, c in counters.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev) / iters
    named = {"L strain_apply10": "strain_apply10_kernel", "M prolong_p": "prolong_p_kernel",
             "M restrict_p": "restrict_p_kernel", "B strain_apply": "strain_apply_kernel"}
    shares = {k: sum(e.time_range.elapsed_us() for e in dev if n in e.name) / iters
              for k, n in named.items()}
    # the GEMMs of the line solves, by their per-call device time alone
    shares["line_apply10"] = 4 * device_time(
        lambda: ts.line_apply10(solver.res, Binv, bg, solver.dup2, solver.free2),
        "")["all_device_us"]
    smg = solver.smg
    r4 = ts.restrict_p(solver.res, bg, smg.free_masks[0]) * smg.active_masks[0]
    tet4_lines = 0.0
    rl = r4
    for li in range(smg.n_levels - 1):
        st_l = smg_state[li]
        tet4_lines += 4 * device_time(lambda: smg._line_apply(li, st_l["Binv"], rl),
                                      "")["all_device_us"]
        rl = smg._restrict(li, rl)
    shares["tet4 line solves"] = tet4_lines
    return {"case": "flagship f32 CG iteration", "grid": list(DOF1M_TET10.key), "B": 1,
            "iters": iters, "ms_per_iter": start.elapsed_time(end) / iters,
            "wall_ms_per_iter": wall / iters * 1e3, "busy_us_per_iter": busy_us,
            "busy_share_of_wall": busy_us / (wall / iters * 1e6),
            "activities_per_iter": len(dev) / iters, "launches_per_iter": launches,
            "device_us_per_iter": shares,
            "share_of_busy": {k: v / busy_us for k, v in shares.items()}}


def iteration_line(r) -> str:
    parts = "; ".join(f"{k} {v:.1f} us ({r['share_of_busy'][k]:.1%})"
                      for k, v in r["device_us_per_iter"].items())
    return (f"[tet10 CG] {r['grid']} B=1 f32, {r['iters']} iterations: {r['ms_per_iter']:.3f} ms "
            f"per iteration (events), device busy {r['busy_us_per_iter']:.1f} us "
            f"({r['busy_share_of_wall']:.1%} of the wall), {r['activities_per_iter']:.0f} "
            f"device activities and launches {r['launches_per_iter']} per iteration; {parts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--iters", type=int, default=40, help="CG iterations profiled")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tet10: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []
    for label, (res, p4s) in SHAPES.items():
        for rec in (*measure_L(label, res, p4s, dev).values(),
                    *measure_M(label, res, len(p4s), dev).values()):
            print(line(rec), flush=True)
            rows.append(rec)
    r = iteration_profile(dev, args.iters)
    print(iteration_line(r), flush=True)
    rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
