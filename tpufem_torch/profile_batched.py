"""Kernel O (``fem.assembly.stiffness_apply_t``, the trailing-batch tet4
operator of WingBatchT and WingMGT) on one CUDA card: device time per launch
and device activities per operator apply, against the byte bound.

At every level of DOF100K's multigrid hierarchy that applies the operator
(the coarsest is a dense inverse) on chip_smoke.py's seeded batch (B = 8)
and at COARSE with B = 3, in f64 and f32, with the root Dirichlet mask and
without: the kernel is first held to its plain version (f64 within 1e-12 of
the largest entry, f32 within 1e-5 of the plain f32 version's largest entry)
and to itself bit for bit, then measured in one torch.profiler window
(utils/profiling.py::device_time) of 20 repeated applies, which find in the
L2 cache what fits there, and 20 more with the L2 overwritten before each.
The bound is the function's own: the larger of the bytes of its operands
(grads, vols, tets, x and free read once, y written once) over the card's
memory rate and its arithmetic (FLOPS_PER_TET per tet and lane, each
evaluated once, and FLOPS_PER_ENTRY per summed row and lane) over the card's
rate outside the tensor cores (tpufem_torch/device.py). The plan's bytes and
how often a tet is evaluated (the plan's `overlap`) are the design's cost,
reported beside it.

With --cg N, it then times N iterations of WingBatchT's CG at DOF100K on the
seeded batch, f64, the multigrid (mg_levels=None) and the two-level
preconditioner (setup outside the window): ms per iteration unprofiled, then
under torch.profiler the device busy share, activities per iteration, kernel
O's launches and us per launch, and the device time of the largest ops.

Usage: python -m tpufem_torch.profile_batched [--out PATH] [--smem BYTES ...]
[--cg N] (--smem: the shared memory budget of kernel O's plan,
assembly.O_SMEM by default; several values time each cut in turn on the same
inputs; --smem with no value skips the kernel measurements)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.multigrid import grads_vols_t, nodes_t
from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
from tpufem_torch.mesher import COARSE, DOF100K, wing_topology
from tpufem_torch.ops.csr_segment_sum import csr_plan
from tpufem_torch.profile_gather_operator import FLOPS_PER_ENTRY, FLOPS_PER_TET, plan_bytes
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.utils.profiling import device_time, median_event_ms


def operator_inputs_t(res, p4, dtype, device, seed=4, smem=asm.O_SMEM):
    """(grads, vols, tets, x, free, plan) as WingBatchT / WingMGT hand them to
    kernel O at resolution `res` for the batch p4 (B,4): gradients and
    volumes built in f64 and cast, a seeded random x (N,3,B), the root mask
    (N,3), int32 tets and kernel O's plan (incidence_t, `smem` bytes a
    block)."""
    topo = wing_topology(res)
    tets = torch.as_tensor(topo.tets.astype(np.int32), device=device)
    basis = torch.as_tensor(topo.node_basis, dtype=torch.float64, device=device)
    nodes = nodes_t(basis, topo.te_floor, torch.as_tensor(np.asarray(p4), device=device),
                    torch.float64)
    grads, vols = grads_vols_t(nodes, tets.long())
    B = nodes.shape[-1]
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(topo.num_nodes, 3, B)),
                        device=device)
    free = torch.ones((topo.num_nodes, 3), dtype=dtype, device=device)
    free[torch.as_tensor(topo.station_id % (res.n_span + 1) == 0, device=device)] = 0.0
    plan = asm.incidence_t(topo.tets, topo.num_nodes, B, dtype, device, smem=smem)
    return grads.to(dtype), vols.to(dtype), tets, x.to(dtype), free, plan


def apply_bound_t(grads, vols, tets, x, free):
    """(bound in us, "bytes" or "operations") of one apply on these operands:
    every input read once, y (of x's size) written once, every tet evaluated
    once per lane."""
    read = [grads, vols, tets, x] + ([] if free is None else [free])
    nbytes = sum(t.numel() * t.element_size() for t in (*read, x))
    B = x.shape[-1]
    flops = (FLOPS_PER_TET * tets.shape[0] + FLOPS_PER_ENTRY * tets.numel()) * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[x.dtype]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def check_apply_t(grads, vols, tets, x, free, plan, lam, mu, ref64):
    """Kernel O on these inputs against `ref64`, the plain version on their
    f64 originals: (max |err| against ref64, the plain version's in this
    dtype, max |err| against the plain version in this dtype). Raises unless
    f64 is within 1e-12 of the largest reference entry, f32 within 1e-5 of
    the plain f32 version's largest entry, and two applies give the same
    bits."""
    y = asm.stiffness_apply_t(grads, vols, tets, x, lam, mu, plan, free)
    torch.cuda.synchronize()
    if not torch.equal(y, asm.stiffness_apply_t(grads, vols, tets, x, lam, mu, plan, free)):
        raise RuntimeError("kernel O: two applies differ")
    plain = asm.stiffness_apply_t_plain(grads, vols, tets, x, lam, mu, plan, free)
    err = (y.double() - ref64).abs().max().item()
    err_plain = (plain.double() - ref64).abs().max().item()
    err_same = (y - plain).abs().max().item()
    scale = ref64.abs().max().item()
    if x.dtype == torch.float64 and err > 1e-12 * scale:
        raise RuntimeError(f"kernel O f64 disagrees: {err:.3e} vs scale {scale:.3e}")
    if x.dtype == torch.float32 and err_same > 1e-5 * plain.abs().max().item():
        raise RuntimeError(f"kernel O f32 disagrees with the plain f32 version: {err_same:.3e}")
    return err, err_plain, err_same


def profile_apply_t(grads, vols, tets, x, free, plan, lam, mu):
    """Device us per kernel-O launch (repeated, and with the L2 flushed),
    launches and device activities per apply, the function's bound and the
    share of it (by the flushed time, and by the repeated time), and the
    plan's bytes read on top."""
    r = device_time(lambda: asm.stiffness_apply_t(grads, vols, tets, x, lam, mu, plan, free),
                    "stiffness_apply_t", cold=True)
    bound, by = apply_bound_t(grads, vols, tets, x, free)
    return {**r, "bound_us": bound, "bound_by": by, "share": bound / r["device_us_cold"],
            "share_repeated": bound / r["device_us"], "plan_bytes": plan_bytes(plan)}


def measure(label, res, p4, device, lam, mu, masks=(True, False), smem=asm.O_SMEM):
    """Check and profile kernel O at `res` on the batch p4: rows for f64 /
    f32, masked / unmasked."""
    rows = []
    g64, v64, tt, x64, f64, _ = operator_inputs_t(res, p4, torch.float64, device, smem=smem)
    for masked in masks:
        ref = asm.stiffness_apply_t_plain(g64, v64, tt, x64, lam, mu,
                                          csr_plan(tt.cpu(), x64.shape[0], device),
                                          f64 if masked else None)
        for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
            g, v, x, fr = g64.to(dtype), v64.to(dtype), x64.to(dtype), f64.to(dtype)
            plan = asm.incidence_t(tt.cpu(), x.shape[0], x.shape[-1], dtype, device, smem=smem)
            free = fr if masked else None
            err, err_plain, err_same = check_apply_t(g, v, tt, x, free, plan, lam, mu, ref)
            r = profile_apply_t(g, v, tt, x, free, plan, lam, mu)
            r["ms"] = median_event_ms(
                lambda: asm.stiffness_apply_t(g, v, tt, x, lam, mu, plan, free))
            r["plain_ms"] = median_event_ms(
                lambda: asm.stiffness_apply_t_plain(g, v, tt, x, lam, mu, plan, free))
            r.update(case=label, dtype=name, masked=masked, T=int(tt.shape[0]),
                     N=int(x.shape[0]), B=int(x.shape[-1]), max_abs_err=err,
                     plain_max_abs_err=err_plain, err_vs_plain=err_same,
                     scale=ref.abs().max().item(), overlap=plan.overlap,
                     blocks=plan.bnode.numel() - 1, slots=plan.slots, smem=smem)
            rows.append(r)
            print(line(r), flush=True)
    return rows


def line(r) -> str:
    return (f"[kernel O] {r['case']} B={r['B']} {r['dtype']} "
            f"{'masked' if r['masked'] else 'unmasked'} T={r['T']} N={r['N']}: "
            f"{r['device_us']:.2f} us per launch repeated, {r['device_us_cold']:.2f} us with the "
            f"L2 flushed; bound {r['bound_us']:.2f} us ({r['bound_by']}): {r['share']:.1%} of "
            f"the bound (flushed), {r['share_repeated']:.1%} repeated; {r['launches']:.0f} "
            f"launch, {r['activities']:.0f} device activity per apply; event {r['ms']:.4f} ms vs "
            f"plain {r['plain_ms']:.4f} ms; max|err| "
            f"{r['max_abs_err']:.3e} vs f64 plain (plain in this dtype {r['plain_max_abs_err']:.3e}"
            f", vs plain in this dtype {r['err_vs_plain']:.3e}; scale {r['scale']:.3e}); plan "
            f"{r['plan_bytes'] / 1e6:.2f} MB on top, {r['blocks']} blocks of <= {r['slots']} "
            f"rows ({r['smem'] // 1024} KB), each tet evaluated {r['overlap']:.3f} times")


def cases(p4):
    """(label, res, batch) of the shapes kernel O runs at: each level of
    DOF100K's V-cycle but the coarsest on the batch p4, and COARSE at B=3."""
    out = [(f"DOF100K level {i} {r.n_chord}x{r.n_span}x{r.n_thick}", r, p4)
           for i, r in enumerate(hierarchy_resolutions(DOF100K)[:-1])]
    return out + [("COARSE", COARSE, p4[:3])]


def profile_cg(dev, p4, iters: int, lam, mu) -> list:
    """ms per CG iteration of WingBatchT(DOF100K, float64) with each
    preconditioner on the batch p4, and where its device time goes."""
    from torch.profiler import ProfilerActivity, profile

    from tpufem_torch.fem.batched_t import WingBatchT

    rows = []
    for name, levels in (("multigrid", None), ("two-level", 0)):
        bt = WingBatchT(DOF100K, dtype=torch.float64, mg_levels=levels, device=dev)
        p4_t = torch.as_tensor(np.asarray(p4), dtype=torch.float64, device=dev)
        x0 = torch.zeros((bt.num_nodes, 3, len(p4)), dtype=torch.float64, device=dev)
        if levels is None:
            _, grads, vols, b, st = bt._setup_mg(p4_t, 5e3, lam, mu)
            st = bt.mg.finalize(st, p4_t.cpu().numpy(), lam, mu)
            run = lambda: bt._chunk_mg(grads, vols, b, st, x0, lam, mu, 0.0, iters)  # noqa: E731
        else:
            _, grads, vols, b, Binv, Ac_inv, dvec = bt._setup(p4_t, 5e3, lam, mu)
            run = lambda: bt._chunk(grads, vols, b, Binv, Ac_inv, dvec, x0, lam, mu,  # noqa: E731
                                    0.0, iters)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / iters * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev)
        by = {}
        for e in ev:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
        o_us = [e.time_range.elapsed_us() for e in ev if "stiffness_apply_t" in e.name]
        top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
        row = {"case": f"WingBatchT DOF100K f64 {name} CG", "iters": iters,
               "ms_per_iter": sorted(walls)[1], "ms_per_iter_runs": walls,
               "profiled_ms_per_iter": wall / iters * 1e3, "busy_share": busy / (wall * 1e6),
               "activities_per_iter": len(ev) / iters, "o_launches_per_iter": len(o_us) / iters,
               "o_us": sum(o_us) / max(len(o_us), 1), "o_share": sum(o_us) / busy,
               "top": [(k[:80], v / busy) for k, v in top]}
        rows.append(row)
        print(f"[{row['case']}] {iters} iterations: {row['ms_per_iter']:.3f} ms per iteration "
              f"(median of 3: {[f'{w:.3f}' for w in walls]}); profiled "
              f"{row['profiled_ms_per_iter']:.3f} ms, device busy {row['busy_share']:.1%}, "
              f"{row['activities_per_iter']:.0f} activities per iteration; kernel O "
              f"{row['o_launches_per_iter']:.0f} launches per iteration, {row['o_us']:.2f} us "
              f"each, {row['o_share']:.1%} of the busy time", flush=True)
        for k, v in row["top"]:
            print(f"    {v:6.1%}  {k}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--smem", type=int, nargs="*", default=[asm.O_SMEM],
                    help="kernel O plan budgets (bytes of shared memory a block) to time")
    ap.add_argument("--cg", type=int, default=0,
                    help="time this many WingBatchT CG iterations at DOF100K, f64")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_batched: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lam, mu = lame_params(Material())
    rows = []
    for label, res, p4 in cases(seeded_batch(8)) if args.smem else ():
        for smem in args.smem:
            rows += measure(label, res, p4, dev, lam, mu, smem=smem)
    if args.cg:
        rows += profile_cg(dev, seeded_batch(8), args.cg, lam, mu)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
