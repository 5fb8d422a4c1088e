"""One PyTorch call for the function of each linear hand kernel, on one CUDA
card: ``torch.sparse.mm`` of the kernel's matrix, assembled on the card, as
the library yardstick of the kernels that no single PyTorch call computes
otherwise (B, D, F, G, I, K, O; N's is profile_tet10.library_matrix, whose
assembly lives here too).

Two assemblies, each checked against the kernel's plain version on a seeded
vector (f64, within 1e-12 of the largest entry) before it is timed:

  - ``grid_probe_csr``: a grid kernel, linear in its (3,B,NI,NK,NJ) input
    at fixed state (B: strain_apply; G: geom_apply at fixed sigma; I:
    stvk_tangent_apply in the direction x at fixed u; F: element_stress, the
    per-tet stress; K: strain_apply_geo_vjp in the cotangent w at fixed u),
    is probed through its plain version with unit vectors coloured by (i mod
    3, j mod 3, k, component): every output at node or cell (i, k, j) reads
    only nodes (i +- 1, j +- 1, any k) (the welds tie a node column along k),
    whose colours all differ, so each probe's output names its column;
  - ``assembled_csr``: a gather operator over a connectivity (D: tet4, one
    point; N: tet10, four Gauss points), the masked stiffness F K F + (I - F)
    summed from the element matrices of its own inputs; O's B lanes, each so
    assembled, as one block-diagonal matrix.

Per kernel, at the shape that heads its row of PERF.md section 6 (the
kernels line's shape in chip_smoke.py), f64: the kernel's device time and
the library call's (repeated and with the L2 flushed, every device activity,
torch.profiler), both event times, the matrix's nonzeros and the check; for
B, D, F, G and O the same again in f32, the f64 matrix cast to f32 and held
to the f32 plain version within 1e-5 of its largest entry.
H and J have no such call: they are nonlinear in u.

Usage: python -m tpufem_torch.profile_library [--out PATH] [--only B D F G I K O]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.utils.profiling import device_time, median_event_ms

LAM, MU = lame_params(Material())


def csr_from_triples(rows, cols, vals, shape) -> torch.Tensor:
    """CSR (int32 indices where they fit) of distinct (row, col, value) triples."""
    n_rows, n_cols = shape
    order = torch.argsort(rows * n_cols + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_rows), 0)
    idx = torch.int32 if vals.numel() < 2**31 and max(shape) < 2**31 else torch.int64
    return torch.sparse_csr_tensor(crow.to(idx), cols.to(idx), vals, shape)


def grid_probe_csr(fn, shape, cells, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """The matrix of fn, linear in x (3,B,NI,NK,NJ) -> a tuple of outputs whose
    last four axes are (B, i, k, j): node axes (NI, NK, NJ) where `cells[o]`
    is False, cell axes (NI-1, NK-1, NJ-1) where it is True. Rows: the
    outputs flattened and concatenated; columns: x flattened. Raises if an
    output reads a node outside the colouring's reach (module docstring)."""
    _, B, NI, NK, NJ = shape
    x = torch.zeros(shape, dtype=dtype, device=device)
    outs = fn(x)
    grids, offset = [], 0
    for o, cell in zip(outs, cells):
        lead = int(np.prod(o.shape[:-4]))
        b, i, k, j = torch.meshgrid(*(torch.arange(n, device=device) for n in o.shape[-4:]),
                                    indexing="ij")
        grids.append((offset, lead, b.reshape(-1), i.reshape(-1), j.reshape(-1), int(cell)))
        offset += o.numel()
    n_out, n_in = offset, x.numel()
    rows, cols, vals = [], [], []
    for ci in range(3):
        for cj in range(3):
            for ck in range(NK):
                for e in range(3):
                    x.zero_()
                    x[e, :, ci::3, ck, cj::3] = 1.0
                    for o, (off, lead, b, i, j, cell) in zip(fn(x), grids):
                        s = 1 - cell  # a node reads i - 1 .. i + 1, a cell i .. i + 1
                        ii, jj = i + (ci - i + s) % 3 - s, j + (cj - j + s) % 3 - s
                        inside = ((ii >= 0) & (ii < NI) & (jj >= 0) & (jj < NJ) & (ii - i <= 1)
                                  & (jj - j <= 1))
                        y = o.reshape(lead, -1)
                        hit = y != 0
                        if (hit & ~inside).any():
                            raise RuntimeError("grid_probe_csr: an output reads a node outside "
                                               "(i +- 1, j +- 1)")
                        lr, pos = hit.nonzero(as_tuple=True)
                        col = (((e * B + b[pos]) * NI + ii[pos]) * NK + ck) * NJ + jj[pos]
                        rows.append(off + lr * b.numel() + pos)
                        cols.append(col)
                        vals.append(y[lr, pos])
    return csr_from_triples(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n_out, n_in))


def assembled_csr(conn, N: int, free, lam: float, mu: float, grads_of,
                  chunk: int = 1 << 16) -> torch.Tensor:
    """The masked operator A = F K F + (I - F) (F = diag(free), free (N,3)) as
    one f64 CSR matrix on conn's device, rows and columns 3 n + d, so that
    torch.sparse.mm(A, x.reshape(-1, 1)) is the gather kernel's masked
    function. grads_of(t0, t1) gives tets [t0, t1)'s point gradients g
    (t,Q,nn,3) and weights wq (t,Q); per tet the nn x nn node blocks
    K_mn[d][e] = sum_q wq (lam g_md g_ne + mu g_me g_nd + mu (g_m . g_n)
    delta_de), summed per node pair (index_add_), then laid out as scalar CSR
    rows."""
    dev, f64 = conn.device, torch.float64
    T, nn = conn.shape
    c = conn.long()
    keys = (c[:, :, None] * N + c[:, None, :]).reshape(-1)  # (T*nn*nn,) node pairs (m, n)
    pairs, inv = torch.unique(keys, return_inverse=True)  # sorted: by row node, then column
    del keys
    blocks = torch.zeros((pairs.numel(), 3, 3), dtype=f64, device=dev)
    for t0 in range(0, T, chunk):
        g, wq = grads_of(t0, min(t0 + chunk, T))
        S = torch.einsum("tq,tqmd,tqne->tmnde", wq.to(f64), g.to(f64), g.to(f64))
        tr = S.diagonal(dim1=3, dim2=4).sum(-1)  # (t,nn,nn): sum_q w g_m . g_n
        Ke = lam * S + mu * S.transpose(3, 4) + (mu * tr)[..., None, None] * torch.eye(
            3, dtype=f64, device=dev)
        blocks.index_add_(0, inv[t0 * nn * nn:(t0 + chunk) * nn * nn], Ke.reshape(-1, 3, 3))
    del inv
    bi, bj = pairs // N, pairs % N
    fr = free.to(f64)
    blocks *= fr[bi][:, :, None] * fr[bj][:, None, :]
    diag = bi == bj
    blocks[diag] += torch.diag_embed(1.0 - fr[bi[diag]])
    # scalar CSR: row 3i+d holds, for each of node i's column nodes j in order,
    # the 3 entries (3j+e); the block k of row node i at place p = k - first(i)
    counts = torch.bincount(bi, minlength=N)
    first = torch.cumsum(counts, 0) - counts
    nnz = 9 * pairs.numel()
    idx = torch.int32 if nnz < 2**31 else torch.int64
    d3 = torch.arange(3, device=dev)
    crow = torch.empty(3 * N + 1, dtype=torch.int64, device=dev)
    crow[:-1] = (9 * first[:, None] + 3 * counts[:, None] * d3).reshape(-1)
    crow[-1] = nnz
    k = torch.arange(pairs.numel(), device=dev)
    at = (9 * first[bi] + 3 * (k - first[bi]))[:, None, None] + \
        (3 * counts[bi])[:, None, None] * d3[None, :, None] + d3[None, None, :]
    cols = torch.empty(nnz, dtype=torch.int64, device=dev)
    cols[at.reshape(-1)] = (3 * bj[:, None, None] + d3[None, None, :]).expand(-1, 3, 3).reshape(-1)
    vals = torch.empty(nnz, dtype=f64, device=dev)
    vals[at.reshape(-1)] = blocks.reshape(-1)
    return torch.sparse_csr_tensor(crow.to(idx), cols.to(idx), vals, (3 * N, 3 * N))


# ------------------------------------------------------- the kernels' cases


def _grid(res) -> str:
    return f"{res.n_chord}x{res.n_span}x{res.n_thick}"


def case_B(device, res=None, B: int = 8):
    """Kernel B, strain_apply, at DOF100K B = 8 (the seeded batch), f64."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.mesher import DOF100K
    from tpufem_torch.profile_operator import operator_inputs
    from tpufem_torch.profile_solve import seeded_batch

    res = res or DOF100K
    geo, u, free = operator_inputs(res, seeded_batch(B), torch.float64, device)

    def f32():
        geo32, _, free32 = operator_inputs(res, seeded_batch(B), torch.float32, device)
        return (lambda x: st.strain_apply(res, geo32, x, free32, LAM, MU),
                lambda x: (st.strain_apply_plain(res, geo32, x, free32, LAM, MU),))

    return {"kernel": lambda x: st.strain_apply(res, geo, x, free, LAM, MU),
            "plain": lambda x: (st.strain_apply_plain(res, geo, x, free, LAM, MU),),
            "x": u, "cells": (False,), "shape": f"{_grid(res)} B={B}", "f32": f32}


def case_G(device, res=None, q: int = 12):
    """Kernel G, geom_apply at fixed sigma, at 32x40x4 q = 12, f64."""
    from tpufem_torch.fem import buckling as bk
    from tpufem_torch.profile_geometric import CLI_RES, geometric_inputs

    res = res or CLI_RES
    geo, _, sig, x, free = geometric_inputs(res, q, device)

    def f32():
        geo32, sig32, free32 = tuple(t.float() for t in geo), sig.float(), free.float()
        return (lambda v: bk.geom_apply(res, geo32, sig32, v, free32),
                lambda v: (bk.geom_apply_plain(res, geo32, sig32, v, free32),))

    return {"kernel": lambda v: bk.geom_apply(res, geo, sig, v, free),
            "plain": lambda v: (bk.geom_apply_plain(res, geo, sig, v, free),),
            "x": x, "cells": (False,), "shape": f"{_grid(res)} q={q}", "f32": f32}


def case_F(device, res=None, q: int = 16):
    """Kernel F, element_stress (linear in u at fixed geometry), at 32x40x4
    q = 16, f64."""
    from tpufem_torch.fem import buckling as bk
    from tpufem_torch.profile_geometric import CLI_RES, geometric_inputs

    res = res or CLI_RES
    geo, u0, _, _, _ = geometric_inputs(res, q, device)

    def f32():
        geo32 = tuple(t.float() for t in geo)
        return (lambda v: bk.element_stress(res, geo32, v, LAM, MU),
                lambda v: (bk.element_stress_plain(res, geo32, v, LAM, MU),))

    return {"kernel": lambda v: bk.element_stress(res, geo, v, LAM, MU),
            "plain": lambda v: (bk.element_stress_plain(res, geo, v, LAM, MU),),
            "x": u0, "cells": (True,), "shape": f"{_grid(res)} q={q}", "f32": f32}


def case_I(device, res=None):
    """Kernel I, stvk_tangent_apply in the direction x at fixed u, at the
    nonlinear CLI's 16x24x4, f64."""
    from tpufem_torch.fem import nonlinear as nl
    from tpufem_torch.profile_nonlinear import NL_RES, nl_inputs

    res = res or NL_RES
    geo, u, x, free = nl_inputs(res, [1.2, 0.35, 10.0, 0.10], device)
    return {"kernel": lambda v: nl.stvk_tangent_apply(res, geo, u, v, free, LAM, MU),
            "plain": lambda v: (nl.stvk_tangent_apply_plain(res, geo, u, v, free, LAM, MU),),
            "x": x, "cells": (False,), "shape": f"{_grid(res)}"}


def case_K(device, res=None, B: int = 4):
    """Kernel K, strain_apply_geo_vjp in the cotangent w at fixed u, at the
    optimizer's 24x32x2 B = 4, f64: gbar and volbar."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.profile_nonlinear import OPT_RECORD_RES, opt_start_p4, vjp_inputs

    res = res or OPT_RECORD_RES
    geo, u, w, free = vjp_inputs(res, np.tile(opt_start_p4()[:1], (B, 1)), device)
    return {"kernel": lambda v: st.strain_apply_geo_vjp(res, geo, u, v, free, LAM, MU),
            "plain": lambda v: st.strain_apply_geo_vjp_plain(res, geo, u, v, free, LAM, MU),
            "x": w, "cells": (True, True), "shape": f"{_grid(res)} B={B}"}


def case_D(device, res=None):
    """Kernel D, stiffness_apply (masked), at DOF100K wing 0 of the seeded
    batch, f64."""
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.mesher import DOF100K, structured_wing_mesh
    from tpufem_torch.profile_gather_operator import operator_inputs
    from tpufem_torch.profile_solve import seeded_batch
    from tpufem_torch.sets import build_boundary_sets

    res = res or DOF100K
    mesh = structured_wing_mesh(*seeded_batch(8)[0], res)
    root = build_boundary_sets(mesh).nroot_nodes
    grads, vols, tets, x, free, plan = operator_inputs(mesh.nodes, mesh.tets, root,
                                                       torch.float64, device)

    def f32():
        g32, v32, _, _, free32, _ = operator_inputs(mesh.nodes, mesh.tets, root, torch.float32,
                                                    device)
        return (lambda v: asm.stiffness_apply(g32, v32, tets, v, LAM, MU, plan, free32),
                lambda v: (asm.stiffness_apply_plain(g32, v32, tets, v, LAM, MU, plan,
                                                     free32),))

    return {"kernel": lambda v: asm.stiffness_apply(grads, vols, tets, v, LAM, MU, plan, free),
            "plain": lambda v: (asm.stiffness_apply_plain(grads, vols, tets, v, LAM, MU, plan,
                                                          free),),
            "matrix": lambda: assembled_csr(
                tets, x.shape[0], free, LAM, MU,
                lambda t0, t1: (grads[t0:t1, None], vols[t0:t1, None])),
            "x": x, "shape": f"{_grid(res)} wing 0, masked", "f32": f32}


def case_O(device, res=None, B: int = 8):
    """Kernel O, stiffness_apply_t (masked), at DOF100K B = 8 (the seeded
    batch), f64: the B lanes' masked stiffness matrices as one block-diagonal
    matrix, rows and columns in x's (N,3,B) order, (3 n + d) B + b."""
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.mesher import DOF100K
    from tpufem_torch.profile_batched import operator_inputs_t
    from tpufem_torch.profile_solve import seeded_batch

    res = res or DOF100K
    grads, vols, tets, x, free, plan = operator_inputs_t(res, seeded_batch(B), torch.float64,
                                                         device)

    def matrix():
        N = x.shape[0]
        rows, cols, vals = [], [], []
        for b in range(B):
            lane = assembled_csr(tets, N, free, LAM, MU,
                                 lambda t0, t1, b=b: (grads[t0:t1, None, :, :, b],
                                                      vols[t0:t1, b, None])).to_sparse_coo()
            r, c = lane.indices()
            rows.append(r * B + b)
            cols.append(c * B + b)
            vals.append(lane.values())
        return csr_from_triples(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                                (3 * N * B, 3 * N * B))

    def f32():
        g32, v32, _, _, free32, plan32 = operator_inputs_t(res, seeded_batch(B), torch.float32,
                                                           device)
        return (lambda v: asm.stiffness_apply_t(g32, v32, tets, v, LAM, MU, plan32, free32),
                lambda v: (asm.stiffness_apply_t_plain(g32, v32, tets, v, LAM, MU, plan32,
                                                       free32),))

    return {"kernel": lambda v: asm.stiffness_apply_t(grads, vols, tets, v, LAM, MU, plan, free),
            "plain": lambda v: (asm.stiffness_apply_t_plain(grads, vols, tets, v, LAM, MU, plan,
                                                            free),),
            "matrix": matrix, "x": x, "shape": f"{_grid(res)} B={B}, masked", "f32": f32}


CASES = {"B": case_B, "D": case_D, "F": case_F, "G": case_G, "I": case_I, "K": case_K,
         "O": case_O}


def longest_kernel(fn) -> str:
    """The name of the longest device activity of one call of fn: the name
    device_time counts a call by (every activity of the call is timed; the
    L2 overwrite of a flushed window is another kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):  # now and then a window loses all of its device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):  # the tracer may lose a window's first device records
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return max(dev, key=lambda e: e.time_range.elapsed_us()).name
    raise RuntimeError("the profiler recorded no device activity in 4 windows")


def library_record(case: dict, timed: bool = True) -> dict:
    """Assemble the case's matrix, hold sparse.mm(A, x) to the plain version
    (raises beyond 1e-12 of its largest entry), then time the kernel and the
    library call on x (f64). A case with an "f32" variant is also run in
    f32: the same matrix cast, x cast, held to the f32 plain version (raises
    beyond 1e-5 of its largest entry), both timed the same way ("f32")."""
    x = case["x"].contiguous()
    if "matrix" in case:
        A = case["matrix"]()
    else:
        A = grid_probe_csr(case["plain"], tuple(x.shape), case["cells"], x.dtype, x.device)
    xcol = x.reshape(-1, 1)
    ref = torch.cat([o.reshape(-1) for o in case["plain"](x)])
    got = torch.sparse.mm(A, xcol).reshape(-1)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if not err <= 1e-12 * scale:
        raise RuntimeError(f"library matrix at {case['shape']}: {err:.3e} vs {scale:.3e}")
    rec = {"shape": case["shape"], "nnz": A.values().numel(), "rows": A.shape[0],
           "max_abs_err": err, "scale": scale}
    if timed:
        rec.update(_timed(lambda: torch.sparse.mm(A, xcol), lambda: case["kernel"](x)))
    if "f32" in case:
        kernel32, plain32 = case["f32"]()
        A32 = torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(), A.values().float(),
                                      A.shape)
        x32 = x.float()
        ref32 = torch.cat([o.reshape(-1) for o in plain32(x32)])
        got32 = torch.sparse.mm(A32, x32.reshape(-1, 1)).reshape(-1)
        err32, scale32 = (got32 - ref32).abs().max().item(), ref32.abs().max().item()
        if not err32 <= 1e-5 * scale32:
            raise RuntimeError(f"f32 library matrix at {case['shape']}: {err32:.3e} vs "
                               f"{scale32:.3e}")
        rec["f32"] = {"max_abs_err": err32, "scale": scale32}
        if timed:
            rec["f32"].update(_timed(lambda: torch.sparse.mm(A32, x32.reshape(-1, 1)),
                                     lambda: kernel32(x32)))
    return rec


def _timed(lib, kern) -> dict:
    """Event ms and device us (repeated, flushed) of the library call and the
    kernel."""
    dl, dk = (device_time(f, longest_kernel(f), cold=True) for f in (lib, kern))
    return {"library_ms": median_event_ms(lib), "library_device_us": dl["all_device_us"],
            "library_device_us_cold": dl["all_device_us_cold"],
            "library_activities": dl["activities"], "kernel_ms": median_event_ms(kern),
            "kernel_device_us": dk["all_device_us"],
            "kernel_device_us_cold": dk["all_device_us_cold"]}


def line(name: str, rec: dict) -> str:
    s = (f"[library {name}] {rec['shape']}: torch.sparse.mm of the assembled matrix "
         f"({rec['rows']:,} rows, {rec['nnz']:,} nonzeros), max |err| {rec['max_abs_err']:.3e} "
         f"against the plain "
         f"version (largest entry {rec['scale']:.3e})")
    for label, r in (("f64", rec), ("f32", rec.get("f32", {}))):
        if "library_ms" in r:
            s += (f"; {label}: library event {r['library_ms']:.4f} ms, device "
                  f"{r['library_device_us']:.2f} us repeated, {r['library_device_us_cold']:.2f} "
                  f"us flushed ({r['library_activities']:.0f} activities); kernel event "
                  f"{r['kernel_ms']:.4f} ms, device {r['kernel_device_us']:.2f} / "
                  f"{r['kernel_device_us_cold']:.2f} us: flushed, the library call takes "
                  f"{r['library_device_us_cold'] / r['kernel_device_us_cold']:.2f}x the kernel's "
                  f"time")
    if "f32" in rec:
        s += f" (f32 matrix max |err| {rec['f32']['max_abs_err']:.3e})"
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the records as JSON lines")
    ap.add_argument("--only", nargs="*", default=list(CASES), choices=list(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_library: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []
    for name in args.only:
        rec = library_record(CASES[name](dev))
        print(line(name, rec), flush=True)
        rows.append({"kernel": name, **rec})
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
