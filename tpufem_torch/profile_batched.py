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
rate outside the tensor cores (tpufem_torch/device.py). The plan's bytes,
its tiles and how often a tet is evaluated (the plan's `overlap`) are the
design's cost, reported beside it.

--cut KEY=VAL[,KEY=VAL] ... times other cuts of kernel O's plan
(assembly.force_plan_t's `tile` AxB and `stage` 0|1, the closure staged in
shared memory or not) after the port's, on the same inputs.

--compare LABEL=DIR ... times kernel O as built from another csrc/ (e.g.
the parent's, unpacked with `git archive`, or an edited copy) in turns with
the port's: the compared builds, the port's twice, the compared builds
again, at DOF100K, levels 1-3 and COARSE, all at B = 8, f64 and f32, masked
and unmasked, each flushed and repeated; it prints each build's largest difference from the
port's output and both builds' ptxas registers and spills. The compared
builds run over the port's plan through their tiled entry points
(tpufem_stiffness_apply_t_tiled_*).

With --cg N, it then times N iterations of WingBatchT's CG at DOF100K on the
seeded batch, f64, the multigrid (mg_levels=None) and the two-level
preconditioner (setup outside the window): ms per iteration unprofiled, then
under torch.profiler the device busy share, activities per iteration, kernel
O's launches and us per launch, and the device time of the largest ops.

Usage: python -m tpufem_torch.profile_batched [--out PATH] [--cut SPEC ...]
[--compare LABEL=DIR ...] [--only SUBSTR ...] [--no_levels] [--cg N]
(--no_levels skips the per-level measurements of the port's cut, --only
keeps the shapes whose label holds one of the SUBSTRs)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import time

import numpy as np
import torch

from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.multigrid import grads_vols_t, node_columns, nodes_t
from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
from tpufem_torch.mesher import COARSE, DOF100K, wing_topology
from tpufem_torch.ops.csr_segment_sum import csr_plan
from tpufem_torch.ops.kernels import (
    build_info,
    check,
    compare_libraries,
    load_kernels,
    parse_compare_specs,
    ptxas_report,
)
from tpufem_torch.profile_gather_operator import FLOPS_PER_ENTRY, FLOPS_PER_TET
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.utils.profiling import device_time, median_event_ms


def operator_inputs_t(res, p4, dtype, device, seed=4, cut=None):
    """(grads, vols, tets, x, free, plan) as WingBatchT / WingMGT hand them to
    kernel O at resolution `res` for the batch p4 (B,4): gradients and
    volumes built in f64 and cast, a seeded random x (N,3,B), the root mask
    (N,3), int32 tets and kernel O's plan (force_plan_t on the wing's station
    columns, with the `cut` options)."""
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
    plan = asm.force_plan_t(topo.tets, topo.num_nodes, B, dtype, device,
                            columns=node_columns(topo, res), **(cut or {}))
    return grads.to(dtype), vols.to(dtype), tets, x.to(dtype), free, plan


def plan_bytes_t(plan) -> int:
    """The bytes of the plan arrays one launch of kernel O reads on top of
    the function's operands: the design's overhead, not in the bound."""
    return sum(t.numel() * t.element_size()
               for t in (plan.ttet, plan.lnode if plan.closure else plan.lids, plan.dst,
                         plan.tstart, plan.qbase, plan.qseg, plan.segs, plan.onode, plan.ostart,
                         *((plan.cnode, plan.cstart) if plan.closure else ())))


def halo_share_t(plan, tets) -> float:
    """The share of the plan's staged corner rows (dst >= 0) whose node a
    tile other than the listing one owns: the rows that would have to leave
    their block. The plan stages a corner only on its own node's tile, so
    this is 0 on any plan force_plan_t makes; it is counted here from the
    plan's arrays."""
    tstart, ostart = plan.tstart.cpu().numpy(), plan.ostart.cpu().numpy()
    tile = np.repeat(np.arange(plan.tiles), np.diff(tstart))
    owner = np.empty(plan.num_segments, np.int64)
    owner[plan.onode.cpu().numpy()] = np.repeat(np.arange(plan.tiles), np.diff(ostart))
    corner = tets.cpu().numpy().astype(np.int64)[plan.ttet.cpu().numpy()]
    staged = plan.dst.cpu().numpy() >= 0
    return float((staged & (owner[corner] != tile[:, None])).sum() / max(staged.sum(), 1))


def plan_numbers(plan, tets) -> dict:
    """The cut a launch of kernel O runs over `tets`: its tiles, blocks,
    lane group, the tets evaluated again (overlap - 1 of T), the halo share
    (halo_share_t), shared memory and plan bytes. The kernel launches no
    thread-block cluster: a block reads no other block's shared memory."""
    return {"tile": list(plan.tile), "tiles": plan.tiles,
            "blocks": plan.tiles * (plan.lanes // plan.group),
            "group": plan.group, "overlap": plan.overlap,
            "ghost_share": 1.0 - 1.0 / plan.overlap, "halo_share": halo_share_t(plan, tets),
            "rows": plan.rows, "nodes": plan.nodes, "closure": plan.closure, "smem": plan.smem,
            "plan_bytes": plan_bytes_t(plan)}


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
            "share_repeated": bound / r["device_us"], **plan_numbers(plan, tets)}


def measure(label, res, p4, device, lam, mu, masks=(True, False), cut=None):
    """Check and profile kernel O at `res` on the batch p4: rows for f64 /
    f32, masked / unmasked, over the port's plan or the `cut` options. A
    `cut` that cannot be made is skipped (no rows); the port's plan raises."""
    rows = []
    g64, v64, tt, x64, f64, _ = operator_inputs_t(res, p4, torch.float64, device)
    cols = node_columns(wing_topology(res), res)
    for dtype in (torch.float64, torch.float32) if cut else ():
        try:
            asm.force_plan_t(tt.cpu(), x64.shape[0], x64.shape[-1], dtype, "cpu", columns=cols,
                             **cut)
        except ValueError as e:
            print(f"[kernel O] {label} cut {cut} {dtype}: {e}; skipped", flush=True)
            return rows
    for masked in masks:
        ref = asm.stiffness_apply_t_plain(g64, v64, tt, x64, lam, mu,
                                          csr_plan(tt.cpu(), x64.shape[0], device),
                                          f64 if masked else None)
        for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
            g, v, x, fr = g64.to(dtype), v64.to(dtype), x64.to(dtype), f64.to(dtype)
            plan = asm.force_plan_t(tt.cpu(), x.shape[0], x.shape[-1], dtype, device,
                                    columns=cols, **(cut or {}))
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
                     scale=ref.abs().max().item(), cut=cut or {})
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
            f", vs plain in this dtype {r['err_vs_plain']:.3e}; scale {r['scale']:.3e}); "
            + cut_line(r))


def cut_line(r) -> str:
    return (f"cut {r.get('cut') or 'port'}: {r['tiles']} tiles of {r['tile'][0]}x{r['tile'][1]} "
            f"columns, {r['blocks']} blocks of {r['group']} lanes, {r['smem']} B shared, "
            f"chunks of <= {r['rows']} rows, tiles of <= {r['nodes']} nodes; each tet evaluated "
            f"{r['overlap']:.3f} times (ghost share {r['ghost_share']:.1%}, halo share "
            f"{r['halo_share']:.1%}, no cluster); plan {r['plan_bytes'] / 1e6:.2f} MB on top")


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


def parse_cut(spec: str) -> dict:
    """force_plan_t options of a --cut KEY=VAL[,KEY=VAL] spec: tile AxB,
    stage 0|1; raises ValueError on anything else."""
    out = {}
    for item in spec.split(","):
        key, sep, val = item.partition("=")
        if not sep or key not in ("tile", "stage"):
            raise ValueError(f"--cut takes tile=AxB, stage=0|1, not {item!r}")
        out[key] = tuple(int(v) for v in val.split("x")) if key == "tile" else int(val)
    return out


def library_call_t(lib, ins, plan, lam, mu):
    """Kernel O of another build (--compare) on ins = (grads, vols, tets, x,
    free), through its tiled entry points over the port's plan: the
    wrapper's launch without its checks and launch counter; each call
    overwrites its output. Raises for a build without them."""
    grads, vols, tets, x, free = ins
    d = "f64" if x.dtype == torch.float64 else "f32"
    y = torch.empty_like(x)
    fp = None if free is None else free.data_ptr()
    tiled = getattr(lib, f"tpufem_stiffness_apply_t_tiled_{d}", None)
    if tiled is None:
        raise RuntimeError("--compare: the build has no tpufem_stiffness_apply_t_tiled_* entry "
                           "points (kernel O's tile plan)")

    def call():
        check(tiled(grads.data_ptr(), vols.data_ptr(), x.data_ptr(), fp, y.data_ptr(),
                    *(ctypes.addressof(a) for a in plan.args), float(lam), float(mu),
                    torch.cuda.current_stream().cuda_stream), "stiffness_apply_t")
        return y

    return call


def compare_cases(p4):
    """(label, res, batch) of --compare: each level of DOF100K's V-cycle but
    the coarsest and COARSE, all at the batch p4 (B = 8)."""
    return [(label, res, p4) for label, res, _ in cases(p4)]


def measure_compare(label, res, p4, device, lam, mu, libs: dict) -> list:
    """Kernel O of the port and of each compared build ({label: library}) at
    one shape, f64 / f32, masked / unmasked, in turns (the compared builds,
    the port's twice, the compared builds again): each held to the plain
    version (within_tol), to itself (bitwise repeat) and to the port's output
    (its largest difference), device us repeated and flushed, share of the
    bound."""
    rows = []
    g64, v64, tt, x64, f64, _ = operator_inputs_t(res, p4, torch.float64, device)
    cols = node_columns(wing_topology(res), res)
    for masked in (True, False):
        for dtype, name, tol in ((torch.float64, "f64", 1e-12), (torch.float32, "f32", 1e-5)):
            g, v, x, fr = g64.to(dtype), v64.to(dtype), x64.to(dtype), f64.to(dtype)
            free = fr if masked else None
            plan = asm.force_plan_t(tt.cpu(), x.shape[0], x.shape[-1], dtype, device,
                                    columns=cols)
            port = lambda: asm.stiffness_apply_t(g, v, tt, x, lam, mu, plan, free)  # noqa: E731
            y_port = port().clone()
            ref = asm.stiffness_apply_t_plain(g, v, tt, x, lam, mu, plan, free)
            scale = ref.abs().max().item()
            bound, by = apply_bound_t(g, v, tt, x, free)
            calls = {"port": port}
            calls.update({lab: library_call_t(lib, (g, v, tt, x, free), plan, lam, mu)
                          for lab, lib in libs.items()})
            order = [*libs, "port", "port", *reversed(list(libs))]
            for turn, lab in enumerate(order):
                fn = calls[lab]
                y = fn().clone()
                again = fn()
                r = device_time(fn, "stiffness_apply_t", cold=True)
                diff = (y - y_port).abs().max().item()
                rec = {"kernel": "O", "library": lab, "turn": turn,
                       "case": label, "dtype": name, "masked": masked, "B": int(x.shape[-1]),
                       "rel_err": (y - ref).abs().max().item() / scale,
                       "within_tol": (y - ref).abs().max().item() <= tol * scale,
                       "bitwise_repeat": torch.equal(y, again), "equals_port": diff == 0.0,
                       "max_diff_port": diff, "device_us": r["device_us"],
                       "device_us_cold": r["device_us_cold"], "launches": r["launches"],
                       "activities": r["activities"], "bound_us": bound, "bound_by": by,
                       "share": bound / r["device_us_cold"],
                       "share_repeated": bound / r["device_us"]}
                rows.append(rec)
                print(compare_line(rec), flush=True)
    return rows


def compare_line(r) -> str:
    held = "" if r["within_tol"] else " OUTSIDE the tolerance"
    return (f"[compare {r['library']}] kernel O {r['case']} B={r['B']} "
            f"{r['dtype']} {'masked' if r['masked'] else 'unmasked'}: rel err "
            f"{r['rel_err']:.2e}{held}, bitwise repeat {r['bitwise_repeat']}, the port's bits "
            f"{r['equals_port']} (largest difference {r['max_diff_port']:.3e}); device "
            f"{r['device_us']:.2f} us repeated, {r['device_us_cold']:.2f} us L2 flushed, "
            f"{r['launches']:.0f} launch and {r['activities']:.0f} activity per call; bound "
            f"{r['bound_us']:.2f} us: {r['share']:.1%} flushed")


def o_registers(log: str) -> dict:
    """{"dtype xL" (the kernel's template on its dtype and L lanes a block):
    (registers, spill store bytes, spill load bytes)} of kernel O in one
    build's ptxas report."""
    out = {}
    for k, v in ptxas_report(log).items():
        if "stiffness_apply_t_kernel" not in k:
            continue
        if m := re.search(r"5LanesI([df])Li(\d+)E", k.split("stiffness_apply_t_kernel")[1]):
            out[f"{'f64' if m.group(1) == 'd' else 'f32'} x{m.group(2)}"] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--cut", nargs="*", default=[], metavar="SPEC",
                    help="other cuts of kernel O's plan to time after the port's: "
                         "tile=AxB,stage=0|1")
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time kernel O as built from each csrc/ DIR, in turns with the "
                         "port's, at every level, B = 8")
    ap.add_argument("--no_levels", action="store_true",
                    help="skip the per-level measurements of the port's cut")
    ap.add_argument("--only", nargs="*", default=None, metavar="SUBSTR",
                    help="only the shapes whose label holds one of these")
    ap.add_argument("--cg", type=int, default=0,
                    help="time this many WingBatchT CG iterations at DOF100K, f64")
    args = ap.parse_args(argv)
    parse_compare_specs(args.compare)  # a malformed spec raises before anything is built
    cuts = [parse_cut(c) for c in args.cut]
    if not torch.cuda.is_available():
        print("profile_batched: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lam, mu = lame_params(Material())
    load_kernels()
    libs = compare_libraries(args.compare)
    for lab, log in (("port", build_info.get("log", "")),
                     *((k, v.build_info.get("log", "")) for k, v in libs.items())):
        print(f"[ptxas {lab}] kernel O (registers, spill stores, spill loads): "
              f"{o_registers(log)}", flush=True)
    rows = []
    p4 = seeded_batch(8)
    picked = [c for c in cases(p4) if args.only is None or any(o in c[0] for o in args.only)]
    for label, res, batch in picked:
        for cut in ([] if args.no_levels else [None]) + cuts:
            rows += measure(label, res, batch, dev, lam, mu, cut=cut)
    for label, res, batch in [c for c in compare_cases(p4)
                              if any(c[0] == p[0] for p in picked)] if libs else ():
        rows += measure_compare(label, res, batch, dev, lam, mu, libs)
    if args.cg:
        rows += profile_cg(dev, p4, args.cg, lam, mu)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
