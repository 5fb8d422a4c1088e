"""Kernels L (``fem.tet10_stencil.strain_apply10``), M (``prolong_p`` /
``restrict_p``) and N (``fem.tet10.tet10_force``) on one CUDA card, and
where the flagship tet10 CG iteration's device time goes.

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
(transfer_matrices) on the same field laid out as (nodes, 3 B), by event
time and by device time (every device activity of the call, repeated).

measure_N(): kernel N against tet10_force_plain at N_SHAPES (the flagship,
32x40x4, a sharp-TE 16x24x4; one wing, a seeded displacement), f64 and f32,
masked and unmasked: f64 within 1e-12 of the largest plain entry, f32
against the f64 result no worse than 2x the plain f32 version, the same
bits twice, one count and two launches and device activities per call (its
tiles, then its halo nodes), event / device (repeated, flushed: both
launches, and each alone) / plain times, the bound (Jinv, vols, the int32
connectivity, x and free read once, y written once; l_flops_per_tet() per
tet, each tet counted once), the plan's blocks, rows, shared memory and
halo share, and the library time: torch.sparse.mm of the masked operator as
one CSR matrix, assembled on the card from the same geometry
(library_matrix; at the flagship ~0.5G element-matrix entries, summed in
seconds).

gather_iteration_profile(): the same for the gather engine's f32 CG
(Tet10MGSolver, --engine gather): kernels N, E and B by name, the line
solves by their per-call time; and the host's share of N: the seconds
force_plan takes at the flagship, and the host time of one masked f32 apply
(200 applies queued without a synchronize, the device behind).

iteration_profile(): the flagship CLI's f32 CG (Tet10StencilT at
DOF1M_TET10, one wing), `iters` iterations after a warm-up: ms per
iteration (CUDA events), then under torch.profiler the device busy time and
activities per iteration and the device time of L, M and B by kernel name;
line_apply10 and the tet4 V-cycle's line solves, whose GEMMs have no name of
their own, by their per-call device time (measured alone) times their
calls per iteration.

--compare LABEL=DIR ...: kernels L and M as built from another csrc/ (the
parent commit's, unpacked with `git archive <rev> tpufem_torch/csrc | tar -x
-C build/parent`, or an edited copy of the port's) are timed the same way at
every SHAPES entry, in turns: the compared builds, the port's own, the
compared builds again, each build a library of its own
(ops/kernels.py::compare_libraries). Each is held to the plain version (a
measuring variant that drops work is timed all the same, its line marked
OUTSIDE the tolerance) and to its own bits on repeat, and its output is
compared with the port's bit for bit (its largest difference from the
port's printed, and from the first compared build's). A build whose sources
predate the tiled entry points (tpufem_strain_apply10_tiled_*,
tpufem_restrict_p_tiled_*, tpufem_tet10_force_tiled_*) is called through its
own; kernel N is timed in the builds that have it (a build with N's first
design, the incidence walk tpufem_tet10_force_*, over the connectivity's
IncidencePlan). Each library's ptxas registers and spills for L, M and N
are printed.

Usage: python -m tpufem_torch.profile_tet10 [--out PATH] [--iters N] [--n_only]
       [--compare LABEL=DIR ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from tpufem_torch.fem import stencil as st
from tpufem_torch.fem import tet10 as tt10
from tpufem_torch.fem import tet10_stencil as ts
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.tet10 import DNDXI
from tpufem_torch.mesher import DOF1M_TET10, WingMeshResolution, structured_wing_mesh
from tpufem_torch.ops.kernels import (
    build_info,
    check,
    compare_libraries,
    load_kernels,
    parse_compare_specs,
    ptxas_report,
)
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
           "restrict_p": "tpufem_torch/csrc/p_transfer.cu",
           "tet10_force": "tpufem_torch/csrc/tet10_force.cu"}
REPLACES = {"strain_apply10": "tpufem/fem/tet10_stencil.py:233",
            "prolong_p": "tpufem/fem/tet10_stencil.py:301",
            "restrict_p": "tpufem/fem/tet10_stencil.py:316",
            "tet10_force": "tpufem/fem/tet10.py:167"}
DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32"}
# kernel M against its plain version, of the largest entry: the weld rows'
# column sums run in another order
M_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
# the device kernels of each entry, by a part of their names (N: its tiles and halo kernels,
# or its first design's one)
KERNEL_NAMES = {"strain_apply10": "strain_apply10_kernel", "prolong_p": "prolong_p_kernel",
                "restrict_p": "restrict_p_kernel", "tet10_force": "tet10_force",
                "strain_apply": "strain_apply_kernel", "stiffness_apply": "stiffness_apply_kernel",
                "csr_segment_sum": "csr_segment_sum"}
LETTERS = {"strain_apply10": "L", "prolong_p": "M", "restrict_p": "M", "tet10_force": "N"}
DESIGNS = {
    "strain_apply10": "cell-owning tiles of TI x TJ cells at full thickness (l_plan), two "
                      "threads per cell (tets 0-2, 3-5) with DNDXI folded at compile time, "
                      "node forces into per-thread shared slots, a fixed-order per-position "
                      "sum; the faces shared between tiles summed from per-tile partials by the "
                      "block that takes a tile's last ticket: no atomics on values",
    "prolong_p": "a thread per doubled position: copy or edge mean of the weld-spread tet4 "
                 "field, times dup2 and free2",
    "restrict_p": "a block per tile of node rows x 16 node columns at full thickness and one "
                  "component (m_plan): the doubled rows staged in shared memory with 16-byte "
                  "loads, a thread per node, weld columns summed in k order after a barrier: "
                  "no atomics",
    "tet10_force": "each tet evaluated once: blocks of neighbouring tets (force_plan: tiles "
                   "of 3 x 3 cells at full thickness at the flagship, a thread per tet), the "
                   "masked displacements of a block's nodes staged in shared memory, kernel L's "
                   "tet10 body (DNDXI folded at compile time, nodes in groups of 3/3/2/2, the "
                   "first design's contractions); the forces on a block's interior nodes into "
                   "shared memory (up to the 227 KB opt-in), summed per node in order after a "
                   "barrier; those on halo nodes to a scratch at their rows, summed in order by "
                   "a second launch, a thread per halo node component: no atomics, the first "
                   "design's bits",
}
# the shapes kernel N runs at in chip_smoke.py's phase 9: the flagship, the
# modal CLI's grid and a sharp-TE one (one wing each)
N_SHAPES = {
    "DOF1M_TET10": (DOF1M_TET10, FLAGSHIP_P4),
    "32x40x4": (MODAL_RES, MODAL_P4),
    "16x24x4 sharp TE": (SHARP_RES, FLAGSHIP_P4),
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
                   library=None, per_call: int = 1) -> dict:
    """One kernel entry's checks (raises on a miss: one count per call, the
    same bits twice, within tol of the plain result's largest entry) and,
    with `timed`, its times (device: the `per_call` launches of each call,
    which are its only device activities) and bound."""
    from tpufem_torch.fem import assembly
    from tpufem_torch.ops import csr_segment_sum as cs

    counter = {"strain_apply10": ts.strain_apply10, "prolong_p": ts.prolong_p,
               "restrict_p": ts.restrict_p, "tet10_force": tt10.tet10_force,
               "strain_apply": st.strain_apply, "stiffness_apply": assembly.stiffness_apply,
               "csr_segment_sum": cs.csr_segment_sum}[name]
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
        if r["launches"] != per_call or r["activities"] != per_call:
            raise RuntimeError(f"{name} {label}: {r['launches']} launches and "
                               f"{r['activities']} device activities per call, not {per_call}")
        dev_us, dev_cold = r["device_us"] * per_call, r["device_us_cold"] * per_call
        rec.update(ms=median_event_ms(fn, 7), plain_ms=median_event_ms(plain, 7),
                   bound_us=bound_us, bound_by=bound_by, bytes=nbytes_, flops=flops,
                   device_us=dev_us, device_us_cold=dev_cold, launches=r["launches"],
                   activities=r["activities"], share=bound_us / dev_cold,
                   share_repeated=bound_us / dev_us,
                   library_ms=median_event_ms(library, 7) if library else None,
                   library_device_us=(device_time(library, "")["all_device_us"] if library
                                      else None))
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


def n_inputs(res: WingMeshResolution, p4, device, seed=2):
    """(Jinv64, vols64, conn, x64, free64, plan, t10) of the wing p4 at res:
    the f64 geometry, a seeded displacement (1e-3 x a normal field), the root
    mask and kernel N's plan of the mesh (force_plan)."""
    t10 = tt10.tet10_from_tet4(structured_wing_mesh(*p4, res))
    conn = torch.as_tensor(t10.tet10, dtype=torch.int32, device=device)
    n10 = torch.as_tensor(t10.nodes10(t10.mesh4.nodes), dtype=torch.float64, device=device)
    Jinv, vols = tt10.tet10_setup(n10, conn)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((t10.num_nodes, 3), generator=gen, device=device, dtype=torch.float64) * 1e-3
    free = torch.ones_like(x)
    free[torch.as_tensor(tt10.tet10_root_nodes(t10), device=device).long()] = 0.0
    return Jinv, vols, conn, x, free, tt10.force_plan(t10, device), t10


def library_matrix(Jinv, vols, conn, free, lam: float, mu: float,
                   chunk: int = 1 << 16) -> torch.Tensor:
    """The masked operator A = F K F + (I - F) (F = diag(free)) as one f64
    CSR matrix on the inputs' device, so that torch.sparse.mm(A, x.reshape(-1,
    1)) computes kernel N's masked function. Assembled from kernel N's own
    inputs (Jinv (T,3,3), vols, conn (T,10), free (N,3)) by
    profile_library.assembled_csr, the gradients g_q = DNDXI[q] Jinv^T at the
    4 Gauss points, each of weight vol / 4."""
    from tpufem_torch.profile_library import assembled_csr

    dn = torch.as_tensor(DNDXI, dtype=torch.float64, device=Jinv.device)

    def grads_of(t0, t1):
        g = torch.einsum("qmj,tdj->tqmd", dn, Jinv[t0:t1].to(torch.float64))  # (t,4,10,3)
        return g, (0.25 * vols[t0:t1].to(torch.float64))[:, None].expand(-1, 4)

    return assembled_csr(conn, free.shape[0], free, lam, mu, grads_of, chunk)


def measure_N(label, res, p4, device, timed=True) -> dict:
    """Kernel N at `res` on the wing p4, f64 and f32, masked (the engine's
    operator) and unmasked: {"f64 masked": record, ...}. The f64 error is held
    to 1e-12 of the largest entry of the plain f64 result, the f32 error
    against that f64 result to 2x the plain f32 version's; each record also
    holds the plan's numbers (plan_numbers), and with `timed` (masked only)
    the device time of each of N's two launches alone and torch.sparse.mm of
    the assembled matrix (library_matrix) on the same x."""
    Jinv64, vols64, conn, x64, free64, plan, _ = n_inputs(res, p4, device)
    T, N = conn.shape[0], x64.shape[0]
    A64 = library_matrix(Jinv64, vols64, conn, free64, LAM, MU) if timed else None
    out = {}
    for masked in (True, False):
        ref64 = tt10.tet10_force_plain(Jinv64, vols64, conn, x64, LAM, MU, plan,
                                       free64 if masked else None)
        for dtype in (torch.float64, torch.float32):
            J, v, x = Jinv64.to(dtype), vols64.to(dtype), x64.to(dtype)
            free = free64.to(dtype) if masked else None
            fn = lambda J=J, v=v, x=x, free=free: tt10.tet10_force(  # noqa: E731
                J, v, conn, x, LAM, MU, N, plan=plan, free=free)
            plain = lambda J=J, v=v, x=x, free=free: tt10.tet10_force_plain(  # noqa: E731
                J, v, conn, x, LAM, MU, plan, free)
            lib = None
            if A64 is not None and masked:
                A = torch.sparse_csr_tensor(A64.crow_indices(), A64.col_indices(),
                                            A64.values().to(dtype), A64.shape)
                xf = x.reshape(-1, 1)
                y_lib = torch.sparse.mm(A, xf).reshape(N, 3)
                if not ((y_lib.double() - ref64).abs().max().item()
                        <= (1e-10 if dtype == torch.float64 else 1e-4) * ref64.abs().max().item()):
                    raise RuntimeError(f"{label}: the assembled matrix is not kernel N's map")
                lib = lambda A=A, xf=xf: torch.sparse.mm(A, xf)  # noqa: E731
            moved = nbytes(J, v, conn, x) + (nbytes(free) if masked else 0) + nbytes(x)
            d = f"{DTYPE_NAMES[dtype]} {'masked' if masked else 'unmasked'}"
            rec = check_and_time("tet10_force", label, fn, plain,
                                 1e-12 if dtype == torch.float64 else 1e-5, moved,
                                 l_flops_per_tet() * T, dtype, timed, library=lib,
                                 per_call=1 + (plan.hnode.numel() > 0))
            if timed and masked:
                for part in ("tiles", "halo"):
                    r = device_time(fn, f"tet10_force_{part}", cold=True)
                    rec[f"{part}_us"], rec[f"{part}_us_cold"] = r["device_us"], r["device_us_cold"]
            if dtype == torch.float32:
                err = (fn().double() - ref64).abs().max().item()
                err_plain = (plain().double() - ref64).abs().max().item()
                if not err <= 2 * err_plain:
                    raise RuntimeError(f"tet10_force {label} {d}: f32 error {err:.3e} against "
                                       f"f64, more than 2x the plain version's {err_plain:.3e}")
                rec.update(err_vs_f64=err, plain_err_vs_f64=err_plain)
            out[d] = {**rec, "dtype": d, "grid": list(res.key), "B": 1, "T": T, "N": N,
                      **plan_numbers(plan, dtype)}
    return out


def plan_numbers(plan, dtype) -> dict:
    """Kernel N's plan at a glance: evaluations per tet, blocks, the most
    interior rows of a block and its shared memory in `dtype`, halo nodes,
    rows and their share of the entries."""
    return {"overlap": plan.overlap, "blocks": plan.tstart.numel() - 1, "rows": plan.rows,
            "closure": plan.closure,
            "smem_bytes": (plan.rows + plan.closure) * 3 * torch.finfo(dtype).bits // 8,
            "halo_nodes": plan.hnode.numel(), "halo_rows": plan.halo_rows,
            "halo_share": plan.halo_share}


def line(rec) -> str:
    s = (f"[kernel {LETTERS[rec['kernel']]}] {rec['kernel']} {rec['case']} {rec['grid']} "
         f"B={rec['B']} {rec['dtype']}: max|err| {rec['max_abs_err']:.3e} (rel "
         f"{rec['rel_err']:.2e}), bitwise repeatable")
    if "overlap" in rec:
        s += (f"; T={rec['T']} N={rec['N']}, {rec['blocks']} blocks of at most {rec['rows']} "
              f"interior rows and {rec['closure']} staged nodes ({rec['smem_bytes']} B of shared "
              f"memory), each tet evaluated "
              f"{rec['overlap']:.3f} times, {rec['halo_nodes']} halo nodes with "
              f"{rec['halo_rows']} rows (halo share {rec['halo_share']:.2%})")
    if "err_vs_f64" in rec:
        s += (f"; f32 err vs f64 {rec['err_vs_f64']:.3e} (plain f32 "
              f"{rec['plain_err_vs_f64']:.3e}, bar 2x)")
    if "ms" in rec:
        lib = (f"; library (torch.sparse.mm) {rec['library_ms']:.4f} ms, device "
               f"{rec['library_device_us']:.2f} us (every activity, repeated)"
               if rec["library_ms"] is not None else "; no one-call PyTorch equivalent")
        s += (f"; {rec['activities']:.0f} device activity per call; event {rec['ms']:.4f} ms vs "
              f"plain {rec['plain_ms']:.4f} ms (median of 7); device {rec['device_us']:.2f} us "
              f"repeated, {rec['device_us_cold']:.2f} us L2 flushed; bound "
              f"{rec['bound_us']:.2f} us ({rec['bound_by']}, {rec['bytes'] / 1e6:.1f} MB, "
              f"{rec['flops'] / 1e9:.3f} GFLOP): {rec['share']:.1%} flushed{lib}")
    if "tiles_us" in rec:
        s += (f"; alone: tiles {rec['tiles_us']:.2f} us repeated, {rec['tiles_us_cold']:.2f} "
              f"flushed, halo {rec['halo_us']:.2f} / {rec['halo_us_cold']:.2f}")
    return s


def library_call(lib, name, res, ins):
    """Kernel L or one of M's entries through another build of the kernels
    (--compare): the wrapper's launch without its checks and launch counter,
    through the tiled entry points where the build has them (the tile from
    l_plan / m_plan, L's partials and tickets of its own), else through the
    entry points they replaced. Returns the call; each call overwrites its
    output."""
    weld_te = int(res.te_floor_frac == 0.0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    d = "f64" if ins[-1].dtype == torch.float64 else "f32"
    P = ctypes.c_void_p
    if name == "strain_apply10":
        (g, vol), u, free2 = ins
        out = torch.empty_like(u)
        _, B, NI2, NK2, NJ2 = u.shape
        fn = getattr(lib, f"tpufem_strain_apply10_tiled_{d}", None)
        if fn is not None:
            plan = ts.l_plan(res, u.element_size())
            tiles = B * plan.tiles_i * plan.tiles_j
            partial = torch.empty(tiles * plan.rim * 3 * NK2, dtype=u.dtype, device=u.device)
            ticket = torch.zeros(tiles, dtype=torch.int32, device=u.device)
            ptrs = (g, vol, u, free2, out, partial, ticket)
            args = (B, NI2, NK2, NJ2, weld_te, plan.TI, plan.TJ, float(LAM), float(MU))
        else:
            fn = getattr(lib, f"tpufem_strain_apply10_{d}")
            fn.argtypes = [P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_double] * 2 + [P]
            fn.restype = ctypes.c_int
            ptrs = (g, vol, u, free2, out)
            args = (B, NI2, NK2, NJ2, weld_te, float(LAM), float(MU))
    elif name == "restrict_p":
        r2, free4, x4 = ins
        out = torch.empty_like(x4)
        _, B, NI, NK, NJ = x4.shape
        fn = getattr(lib, f"tpufem_restrict_p_tiled_{d}", None)
        if fn is not None:
            plan = ts.m_plan(res, r2.element_size())
            args = (B, NI, NK, NJ, weld_te, plan.TIr, plan.TJr)
        else:
            fn = getattr(lib, f"tpufem_restrict_p_{d}")
            fn.argtypes = [P] * 3 + [ctypes.c_int] * 5 + [P]
            fn.restype = ctypes.c_int
            args = (B, NI, NK, NJ, weld_te)
        ptrs = (r2, free4, out)
    else:
        x4, dup2, free2, r2 = ins
        out = torch.empty_like(r2)
        fn = getattr(lib, f"tpufem_prolong_p_{d}")
        ptrs = (x4, dup2, free2, out)
        args = (*x4.shape[1:], weld_te)

    def call():  # reads ptrs, which keeps L's partials and tickets alive with the call
        check(fn(*(t.data_ptr() for t in ptrs), *args, stream()), name)
        return out

    return call


def compare_inputs(label, res, p4s, device) -> dict:
    """{(kernel, dtype name): (inputs, port's call, plain call, tol, bytes, flops)}
    at one SHAPES entry: measure_L's and measure_M's inputs."""
    out = {}
    B = len(p4s)
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    n_tets = 6 * res.n_chord * res.n_thick * res.n_span * B
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        d = DTYPE_NAMES[dtype]
        geo, u, free2 = l_inputs(res, p4s, dtype, device)
        out["strain_apply10", d] = (
            (geo, u, free2), lambda geo=geo, u=u, free2=free2: ts.strain_apply10(
                res, geo, u, free2, LAM, MU),
            lambda geo=geo, u=u, free2=free2: ts.strain_apply10_plain(res, geo, u, free2, LAM, MU),
            tol, nbytes(u, geo[0][:, 1:], geo[1], free2) + nbytes(u), l_flops_per_tet() * n_tets)
        gen = torch.Generator(device=device).manual_seed(1)
        x4 = torch.randn((3, B, NI, NK, NJ), generator=gen, device=device, dtype=dtype)
        r2 = torch.randn((3, B, *ts._doubled(res)), generator=gen, device=device, dtype=dtype)
        dup2, free2 = ts.dup_mask2(res, dtype, device), ts.free_mask2(res, dtype, device)
        free4 = torch.ones((1, 1, 1, 1, NJ), dtype=dtype, device=device)
        free4[..., 0] = 0.0
        out["prolong_p", d] = (
            (x4, dup2, free2, r2), lambda x4=x4, dup2=dup2, free2=free2: ts.prolong_p(
                res, x4, dup2, free2),
            lambda x4=x4, dup2=dup2, free2=free2: ts.prolong_p_plain(res, x4, dup2, free2),
            M_TOL[dtype], nbytes(x4, dup2, free2) + nbytes(r2), 0)
        out["restrict_p", d] = (
            (r2, free4, x4), lambda r2=r2, free4=free4: ts.restrict_p(res, r2, free4),
            lambda r2=r2, free4=free4: ts.restrict_p_plain(res, r2, free4),
            M_TOL[dtype], nbytes(r2, free4) + nbytes(x4), 0)
    return out


def library_record(name, label, lib_label, fn, port, plain, tol, nbytes_, flops, dtype,
                   first=None) -> dict:
    """One kernel entry of another build on one shape: its error against the
    plain version (`within_tol`: a measuring variant may drop work), the same
    bits twice, whether it gives
    the port's bits (and its largest difference from them; with `first`,
    the first compared build's output, from that too), device time per call
    (all its launches) repeated and with the L2 flushed, launches and
    activities per call, and the share of the same bound."""
    y = fn().clone()
    again = fn()
    ref, mine = plain(), port()
    vs_first = {} if first is None else {"max_diff_first": (y - first).abs().max().item()}
    scale = ref.abs().max().item()
    err = (y - ref).abs().max().item()
    r = device_time(fn, KERNEL_NAMES[name], cold=True)
    dev_us, dev_cold = r["device_us"] * r["launches"], r["device_us_cold"] * r["launches"]
    bound_us, bound_by = bound(nbytes_, flops, dtype)
    return {"kernel": name, "library": lib_label, "case": label, "dtype": DTYPE_NAMES[dtype],
            "max_abs_err": err, "rel_err": err / scale, "within_tol": err <= tol * scale,
            "bitwise_repeat": torch.equal(y, again),
            "equals_port": torch.equal(y, mine), "max_diff_port": (y - mine).abs().max().item(),
            "rel_diff_port": (y - mine).abs().max().item() / scale, **vs_first,
            "device_us": dev_us, "device_us_cold": dev_cold,
            "launches": r["launches"], "activities": r["activities"], "bound_us": bound_us,
            "bound_by": bound_by, "share": bound_us / dev_cold,
            "share_repeated": bound_us / dev_us}


def measure_library(label, lib_label, lib, res, p4s, device, firsts: dict) -> list:
    """Kernels L and M of library `lib` at one SHAPES entry (library_record);
    `firsts` keeps the first compared build's outputs, by kernel and dtype,
    and each later build is held to them too."""
    recs = []
    for (name, d), (ins, port, plain, tol, nb, fl) in compare_inputs(label, res, p4s,
                                                                      device).items():
        call = library_call(lib, name, res, ins)
        first = firsts.get((name, d))
        if first is None:
            firsts[(name, d)] = call().clone()
        rec = library_record(name, label, lib_label, call, port, plain, tol, nb, fl,
                             ins[-1].dtype, first)
        recs.append({**rec, "grid": list(res.key), "B": len(p4s)})
    return recs


def walk_call(lib, d, ins, conn, plan):
    """Kernel N's first design (the incidence walk, tpufem_tet10_force_{d})
    of another build on (J, v, x, free) over its IncidencePlan."""
    P = ctypes.c_void_p
    fn = getattr(lib, f"tpufem_tet10_force_{d}")
    fn.argtypes = [P] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, P]
    fn.restype = ctypes.c_int
    J, v, x, free = ins
    y = torch.empty_like(x)
    ptrs = (J, v, conn, plan.pos, plan.btet, plan.bt_start, plan.bnode, plan.starts, x, free, y)

    def call():
        check(fn(*(t.data_ptr() for t in ptrs), plan.bnode.numel() - 1, plan.slots, float(LAM),
                 float(MU), torch.cuda.current_stream().cuda_stream), "tet10_force")
        return y

    return call


def measure_library_N(label, lib_label, lib, res, p4, device, firsts: dict) -> list:
    """Kernel N of library `lib` at one N_SHAPES entry, masked, f64 and f32
    (library_record): through the tile plan's entry points where the build
    has them, else through the first design's walk over the connectivity's
    IncidencePlan."""
    from tpufem_torch.fem.assembly import build_incidence

    Jinv64, vols64, conn, x64, free64, plan, t10 = n_inputs(res, p4, device)
    T, N = conn.shape[0], x64.shape[0]
    tiled = hasattr(lib, "tpufem_tet10_force_tiled_f64")
    walk = None if tiled else build_incidence(t10.tet10, N, device)
    recs = []
    for dtype in (torch.float64, torch.float32):
        d = DTYPE_NAMES[dtype]
        ins = tuple(t.to(dtype) for t in (Jinv64, vols64, x64, free64))
        J, v, x, free = ins
        if tiled:
            fn = getattr(lib, f"tpufem_tet10_force_tiled_{d}")
            y = torch.empty_like(x)
            halo = torch.empty(3 * plan.halo_rows, dtype=dtype, device=device)

            def call(fn=fn, J=J, v=v, x=x, free=free, y=y, halo=halo):
                check(fn(J.data_ptr(), v.data_ptr(), *plan.args[:12], x.data_ptr(),
                         free.data_ptr(), y.data_ptr(), halo.data_ptr(), *plan.args[12:],
                         float(LAM), float(MU), torch.cuda.current_stream().cuda_stream),
                      "tet10_force")
                return y

            numbers = plan_numbers(plan, dtype)
        else:
            call = walk_call(lib, d, ins, conn, walk)
            numbers = {"overlap": walk.overlap, "blocks": walk.bnode.numel() - 1}
        key = ("tet10_force", d)
        if key not in firsts:
            firsts[key] = call().clone()
        rec = library_record(
            "tet10_force", label, lib_label, call,
            lambda J=J, v=v, x=x, free=free: tt10.tet10_force(J, v, conn, x, LAM, MU, N,
                                                              plan=plan, free=free),
            lambda J=J, v=v, x=x, free=free: tt10.tet10_force_plain(J, v, conn, x, LAM, MU,
                                                                    plan, free),
            1e-12 if dtype == torch.float64 else 1e-5, nbytes(J, v, conn, x, free, x),
            l_flops_per_tet() * T, dtype, firsts[key])
        recs.append({**rec, "grid": list(res.key), "B": 1, **numbers})
    return recs


def library_line(rec) -> str:
    first = (f", from the first compared build's {rec['max_diff_first']:.3e}"
             if "max_diff_first" in rec else "")
    held = "" if rec["within_tol"] else " OUTSIDE the tolerance"
    plan = (f"; {rec['blocks']} blocks, each tet evaluated {rec['overlap']:.3f} times"
            if "overlap" in rec else "")
    return (f"[compare {rec['library']}] {rec['kernel']} {rec['case']} {rec['dtype']}: rel err "
            f"{rec['rel_err']:.2e}{held}, bitwise repeat {rec['bitwise_repeat']}, the port's bits "
            f"{rec['equals_port']} (largest difference {rec['max_diff_port']:.3e}, rel "
            f"{rec['rel_diff_port']:.2e}{first}); device {rec['device_us']:.2f} us repeated, "
            f"{rec['device_us_cold']:.2f} us L2 flushed, {rec['launches']:.0f} launch and "
            f"{rec['activities']:.0f} activity per call; bound {rec['bound_us']:.2f} us: "
            f"{rec['share']:.1%} flushed{plan}")


def ptxas_line(label, log) -> str:
    """The registers and spills ptxas reported for kernels L, M and N of one build."""
    rep = {k: v for k, v in ptxas_report(log).items()
           if any(n in k for n in KERNEL_NAMES.values())}
    return (f"[ptxas {label}] " + "; ".join(f"{k}: {r} registers, {ss} / {sl} B spilled"
                                            for k, (r, ss, sl) in sorted(rep.items())))


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


def gather_iteration_profile(device, iters: int = 40) -> dict:
    """Where the flagship f32 CG iteration of the gather engine's device
    time goes (Tet10MGSolver at DOF1M_TET10, --engine gather's solver): its
    setup's seconds and peak device memory (the tet10 line blocks among
    them), ms per iteration, device busy time and activities per iteration, the
    device time of kernels N, E and B by name, and the line solves (gather,
    bmm, scatter: no name of their own) by their per-call device time times
    their 4 calls per iteration."""
    from tpufem_torch.fem import tet10_mg as tm
    from tpufem_torch.fem.stencil_mg import _cg_grid_init, _cg_grid_run
    from tpufem_torch.fem.tet10 import tet10_from_tet4
    from tpufem_torch.ops import csr_segment_sum as cs
    from tpufem_torch.sets import build_boundary_sets

    mesh = structured_wing_mesh(*FLAGSHIP_P4, DOF1M_TET10)
    t10 = tet10_from_tet4(mesh)
    solver = tm.Tet10MGSolver(DOF1M_TET10, t10, device=device)
    t0 = time.perf_counter()
    tt10.force_plan(t10, device)  # what the solver built: its seconds alone
    plan_s = time.perf_counter() - t0
    ut6 = tt10.tet10_upper_t6(t10, build_boundary_sets(mesh).surf_upper_faces)
    lam, mu = (float(torch.tensor(v, dtype=torch.float32)) for v in (LAM, MU))
    n10 = torch.as_tensor(t10.nodes10(mesh.nodes), dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    Jinv, vols, Binv, lmax, smg_state = solver._setup(n10, np.asarray(FLAGSHIP_P4), lam, mu)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(device) - base
    b = tt10.pressure_loads_t6(n10, ut6, 5e3, t10.num_nodes) * solver.free
    A, M = solver._ops(Jinv, vols, Binv, lmax, smg_state, lam, mu)
    cg = _cg_grid_init(A, M, tm._dot64, b, torch.zeros_like(b))
    run = lambda: _cg_grid_run(A, M, tm._dot64, cg, 0.0, iters)  # noqa: E731  (tol 0: never stops)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):  # 400 launches: within the launch queue, so the host never waits
        A(b)
    apply_host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    counters = {"N": tt10.tet10_force, "E": cs.csr_segment_sum, "B": st.strain_apply}
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
    named = {"N tet10_force": "tet10_force", "E csr_segment_sum": "csr_segment_sum",
             "B strain_apply": "strain_apply_kernel"}
    shares = {k: sum(e.time_range.elapsed_us() for e in dev if n in e.name) / iters
              for k, n in named.items()}
    shares["line solves"] = 4 * device_time(lambda: solver._line_apply(Binv, b),
                                            "")["all_device_us"]
    return {"case": "gather flagship f32 CG iteration", "grid": list(DOF1M_TET10.key), "B": 1,
            "plan_s": plan_s, "apply_host_us": apply_host_us, "setup_s": setup_s,
            "setup_peak_bytes": setup_peak, "iters": iters,
            "ms_per_iter": start.elapsed_time(end) / iters,
            "wall_ms_per_iter": wall / iters * 1e3, "busy_us_per_iter": busy_us,
            "busy_share_of_wall": busy_us / (wall / iters * 1e6),
            "activities_per_iter": len(dev) / iters, "launches_per_iter": launches,
            "device_us_per_iter": shares,
            "share_of_busy": {k: v / busy_us for k, v in shares.items()}}


def iteration_line(r) -> str:
    parts = "; ".join(f"{k} {v:.1f} us ({r['share_of_busy'][k]:.1%})"
                      for k, v in r["device_us_per_iter"].items())
    setup = (f"force_plan {r['plan_s']:.3f} s, N's host time {r['apply_host_us']:.1f} us an "
             f"apply; setup {r['setup_s']:.3f} s, peak device memory {r['setup_peak_bytes']} B "
             f"above the solver's own; " if "setup_s" in r else "")
    return (f"[tet10 CG] {r['case']} {r['grid']} B=1, {setup}{r['iters']} iterations: "
            f"{r['ms_per_iter']:.3f} ms "
            f"per iteration (events), device busy {r['busy_us_per_iter']:.1f} us "
            f"({r['busy_share_of_wall']:.1%} of the wall), {r['activities_per_iter']:.0f} "
            f"device activities and launches {r['launches_per_iter']} per iteration; {parts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--iters", type=int, default=40, help="CG iterations profiled")
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time kernels L, M and N as built from each csrc/ DIR (another "
                         "commit's, or an edited copy), before and after the port's own, at "
                         "every shape")
    ap.add_argument("--n_only", action="store_true",
                    help="kernel N alone: its shapes and the gather CG's profile")
    args = ap.parse_args(argv)
    parse_compare_specs(args.compare)  # a malformed spec raises before anything is built
    if not torch.cuda.is_available():
        print("profile_tet10: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    load_kernels()
    libs = compare_libraries(args.compare)
    print(ptxas_line("port", build_info.get("log", "")), flush=True)
    for lab, lib in libs.items():
        print(ptxas_line(lab, lib.build_info.get("log", "")), flush=True)
    rows = []
    for label, (res, p4s) in ({} if args.n_only else SHAPES).items():
        firsts = {}
        # in turns: the compared builds, the port's kernels, the compared builds again
        for turn, order in ((0, list(libs.items())), (1, list(reversed(libs.items())))):
            if turn:
                for rec in (*measure_L(label, res, p4s, dev).values(),
                            *measure_M(label, res, len(p4s), dev).values()):
                    print(line(rec), flush=True)
                    rows.append(rec)
            for lab, lib in order:
                for rec in measure_library(label, lab, lib, res, p4s, dev, firsts):
                    print(library_line(rec), flush=True)
                    rows.append({**rec, "turn": turn})
    for label, (res, p4) in N_SHAPES.items():
        firsts = {}
        has_n = [(lab, lib) for lab, lib in libs.items()
                 if any(hasattr(lib, f"tpufem_tet10_force{t}_f64") for t in ("", "_tiled"))]
        for turn, order in ((0, has_n), (1, list(reversed(has_n)))):
            if turn:
                for rec in measure_N(label, res, p4, dev).values():
                    print(line(rec), flush=True)
                    rows.append(rec)
            for lab, lib in order:
                for rec in measure_library_N(label, lab, lib, res, p4, dev, firsts):
                    print(library_line(rec), flush=True)
                    rows.append({**rec, "turn": turn})
    for profile_fn in (gather_iteration_profile,) if args.n_only else (
            iteration_profile, gather_iteration_profile):
        r = profile_fn(dev, args.iters)
        print(iteration_line(r), flush=True)
        rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
