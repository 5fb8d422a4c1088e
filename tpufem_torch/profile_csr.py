"""Kernel E (``ops.csr_segment_sum``, ``csrc/csr_segment_sum.cu``) at every
plan the port launches it at, on one CUDA card.

The plans (PLANS): the gather path's at DOF100K wing 0 of the seeded batch
(``fem.driver.mesh_plans``, two_level): the incidence at C = 3 (the Jacobi
diagonal), 6 and 1 (the nodal stress numerator and denominator), the loads
at C = 3, the line blocks' ``blk_plan`` at C = 9, the RBM ``group_plan`` at
C = 4 (setup) and 6 (once per f64 gather CG iteration) and the longest RBM
pair plan, ``pair_plans[0]``, at C = 36; the stencil engine's at DOF100K
B = 8 (``fem.batched_t.WingBatchT``): ``upper_plan`` at C = 3B and
``tet_plan`` at C = 6B and B; the tet10 flagship's at DOF1M_TET10: the T6
loads at C = 3 and the connectivity at C = 6 and 1 (the nodal stress).

At each plan and width, on seeded normal values, f64 and f32: the card's
output against ``csr_segment_sum_plain`` on CPU copies, bit for bit, and
the same bits twice; one launch per call; the device time per launch from
torch.profiler windows (``utils/profiling.py::device_time``), repeated and
with the L2 flushed; the byte bound (each value read once, ``order`` and
``starts`` once, each output written once, over the card's memory rate);
the library on equal work, ``torch.zeros`` then ``index_add_``, by every
device activity, repeated and flushed; and the launch plan the wrapper took
(ranges, staged rows, segments per range, shared memory).

--compare LABEL=DIR ...: kernel E as built from another csrc/ (the parent
commit's, unpacked with `git archive <rev> tpufem_torch/csrc | tar -x -C
build/parent`, or an edited copy of the port's), each a library of its own
(ops/kernels.py::compare_libraries), timed the same way in turns (the
compared builds, the port's, the compared builds again) and held to the
CPU's bits and the port's. A build with the ranged entry points is launched
on the port's launch plan; an older one through its own entry points.

--cut KEY=VALUE[,KEY=VALUE] ...: the port's kernel again on launch plans
cut with other budgets (csr_ranges' stage_bytes, min_ranges), in
the same turns: a measuring aid for the budgets the wrapper takes.

Usage: python -m tpufem_torch.profile_csr [--out PATH] [--only SUBSTR ...]
           [--compare LABEL=DIR ...] [--cut KEY=VALUE[,KEY=VALUE] ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from tpufem_torch.device import HBM_BYTES_PER_S
from tpufem_torch.ops import csr_segment_sum as cs
from tpufem_torch.ops.kernels import (
    build_info,
    check,
    compare_libraries,
    load_kernels,
    parse_compare_specs,
    ptxas_report,
)
from tpufem_torch.utils.profiling import device_time

KERNEL_NAME = "csr_segment_sum"  # the __global__ function's name holds it, in every build
DTYPES = {"f64": torch.float64, "f32": torch.float32}
STENCIL_B = 8


def gather_plans(device) -> list:
    """[(label, plan, widths)] of the gather path at DOF100K wing 0."""
    from tpufem_torch.fem.driver import mesh_plans
    from tpufem_torch.mesher import DOF100K, structured_wing_mesh
    from tpufem_torch.profile_solve import seeded_batch
    from tpufem_torch.sets import build_boundary_sets

    mesh = structured_wing_mesh(*map(float, seeded_batch(8)[0]), DOF100K)
    plans = mesh_plans(mesh, build_boundary_sets(mesh), device, two_level=True)
    return [("gather incidence", plans["incidence"], (3, 6, 1)),
            ("gather loads", plans["loads"], (3,)),
            ("gather line blk_plan", plans["line"]["blk_plan"], (9,)),
            ("gather RBM group_plan", plans["rbm"].group_plan, (4, 6)),
            ("gather RBM pair_plans[0]", plans["rbm"].pair_plans[0], (36,))]


def stencil_plans(device) -> list:
    """[(label, plan, widths)] of the stencil engine at DOF100K, B = 8."""
    from tpufem_torch.fem.batched_t import WingBatchT
    from tpufem_torch.mesher import DOF100K

    bt = WingBatchT(DOF100K, device=device)
    return [("stencil upper_plan", bt.upper_plan, (3 * STENCIL_B,)),
            ("stencil tet_plan", bt.tet_plan, (6 * STENCIL_B, STENCIL_B))]


def tet10_plans(device) -> list:
    """[(label, plan, widths)] of the tet10 flagship at DOF1M_TET10."""
    from tpufem_torch.profile_tet10 import flagship_solver

    solver, ut6 = flagship_solver(device)
    return [("tet10 T6 loads", solver._t6_plan(ut6), (3,)),
            ("tet10 connectivity", solver._conn()[1], (6, 1))]


PLANS = (gather_plans, stencil_plans, tet10_plans)


def plan_stats(plan) -> dict:
    counts = np.diff(plan.starts.cpu().numpy())
    return {"R": int(plan.order.shape[0]), "N": int(plan.num_segments),
            "nonempty": int((counts > 0).sum()), "longest": int(counts.max(initial=0)),
            "mean_nonempty": float(counts[counts > 0].mean()) if (counts > 0).any() else 0.0}


def byte_bound_us(vals, plan, N) -> float:
    nb = (vals.numel() * vals.element_size() + plan.order.numel() * 4
          + plan.starts.numel() * 4 + N * vals.shape[1] * vals.element_size())
    return nb / HBM_BYTES_PER_S * 1e6


def launch_info(plan, C, itemsize, **kw) -> dict:
    """The launch plan the wrapper takes at this width (kw: csr_ranges'
    budgets, for --cut)."""
    lp = cs.make_launch(plan, C, itemsize, **kw)
    return {"ranges": lp.n_ranges, "chunk_rows": lp.chunk_rows, "range_segs": lp.range_segs,
            "list_len": lp.list_len,
            "smem": cs.smem_bytes(C, itemsize, lp.chunk_rows, lp.range_segs, lp.list_len)}


def library_call(lib, vals, plan, **kw):
    """Kernel E through another build (--compare), or through the port's own
    library on another launch plan (kw: csr_ranges' budgets): the launch
    without the wrapper's checks and counter. Returns the call; each call
    writes a fresh output."""
    d = "f64" if vals.dtype == torch.float64 else "f32"
    C, N = vals.shape[1], plan.num_segments
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    fn = getattr(lib, f"tpufem_csr_segment_sum_ranges_{d}", None)
    if fn is not None:
        lp = cs.make_launch(plan, C, vals.element_size(), **kw)

        def call():
            out = torch.empty((N, C), dtype=vals.dtype, device=vals.device)
            check(fn(vals.data_ptr(), plan.order.data_ptr(), plan.starts.data_ptr(),
                     lp.tab.data_ptr(), out.data_ptr(), C, lp.n_ranges, lp.chunk_rows,
                     lp.range_segs, lp.list_len, stream()), "csr_segment_sum")
            return out
        return call
    fn = getattr(lib, f"tpufem_csr_segment_sum_{d}")  # the first design's entry points
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_longlong, ctypes.c_longlong, P]
    fn.restype = ctypes.c_int

    def call():
        out = torch.empty((N, C), dtype=vals.dtype, device=vals.device)
        check(fn(vals.data_ptr(), plan.order.data_ptr(), plan.starts.data_ptr(), out.data_ptr(),
                 N, C, stream()), "csr_segment_sum")
        return out
    return call


def measure(label, who, fn, vals, plan, cpu_ref, port_out=None, library=False) -> dict:
    """One build's record at one plan, width and dtype."""
    y = fn()
    torch.cuda.synchronize()
    y_cpu = y.cpu()
    rec = {"plan": label, "build": who, "C": vals.shape[1],
           "dtype": "f64" if vals.dtype == torch.float64 else "f32",
           "equals_cpu_plain": bool(torch.equal(y_cpu, cpu_ref)),
           "max_diff_cpu_plain": (y_cpu - cpu_ref).abs().max().item() if y.numel() else 0.0,
           "bitwise_repeat": bool(torch.equal(y, fn()))}
    if port_out is not None:
        rec["equals_port"] = bool(torch.equal(y, port_out))
    r = device_time(fn, KERNEL_NAME, cold=True)
    rec.update(device_us=r["device_us"], device_us_cold=r["device_us_cold"],
               launches=r["launches"], activities=r["activities"])
    bound = byte_bound_us(vals, plan, plan.num_segments)
    rec.update(bound_us=bound, share=bound / r["device_us_cold"],
               share_repeated=bound / r["device_us"])
    if library:
        ids = torch.empty_like(plan.seg)  # each row's segment id, in row order
        ids[plan.order.long()] = plan.seg
        filled = lambda: torch.zeros_like(y).index_add_(0, ids, vals)  # noqa: E731
        # the window is counted by the adds' kernel (its name holds "index",
        # the fills' does not), and timed by every activity
        lib = device_time(filled, "index", cold=True)
        rec.update(library_device_us=lib["all_device_us"],
                   library_device_us_cold=lib["all_device_us_cold"],
                   library_activities=lib["activities"])
    return rec


def line(rec) -> str:
    s = (f"[E {rec['build']}] {rec['plan']} C={rec['C']} {rec['dtype']}: the CPU's bits "
         f"{rec['equals_cpu_plain']} (largest difference {rec['max_diff_cpu_plain']:.3e}), "
         f"bitwise repeat {rec['bitwise_repeat']}")
    if "equals_port" in rec:
        s += f", the port's bits {rec['equals_port']}"
    s += (f"; {rec['launches']:.0f} launch, {rec['activities']:.0f} activity per call; device "
          f"{rec['device_us']:.2f} us repeated, {rec['device_us_cold']:.2f} us L2 flushed; bound "
          f"{rec['bound_us']:.2f} us: {rec['share']:.1%} flushed, {rec['share_repeated']:.1%} "
          f"repeated")
    if "library_device_us" in rec:
        s += (f"; zeros + index_add_ {rec['library_device_us']:.2f} us repeated, "
              f"{rec['library_device_us_cold']:.2f} us flushed (every activity, "
              f"{rec['library_activities']:.0f} per call)")
    if rec.get("launch"):
        s += f"; launch plan {rec['launch']}"
    return s


def ptxas_line(label, log) -> str:
    rep = {k: v for k, v in ptxas_report(log).items() if KERNEL_NAME in k}
    return (f"[ptxas {label}] " + "; ".join(f"{k}: {r} registers, {ss} / {sl} B spilled"
                                            for k, (r, ss, sl) in sorted(rep.items())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the records as JSON lines")
    ap.add_argument("--only", nargs="*", default=[], metavar="SUBSTR",
                    help="only the plans whose label holds one of these")
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time kernel E as built from each csrc/ DIR, in turns with the "
                         "port's")
    ap.add_argument("--cut", nargs="*", default=[], metavar="KEY=VALUE[,KEY=VALUE]",
                    help="also time the port's kernel on launch plans cut with these budgets "
                         "(csr_ranges' stage_bytes, min_ranges)")
    args = ap.parse_args(argv)
    cuts = {spec: {k: int(v) for k, v in (kv.split("=") for kv in spec.split(","))}
            for spec in args.cut}
    parse_compare_specs(args.compare)  # a malformed spec raises before anything is built
    if not torch.cuda.is_available():
        print("profile_csr: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    port_lib = load_kernels()
    libs = compare_libraries(args.compare)
    print(ptxas_line("port", build_info.get("log", "")), flush=True)
    for lab, lib in libs.items():
        print(ptxas_line(lab, lib.build_info.get("log", "")), flush=True)
    rows = []
    gen = torch.Generator(device=dev).manual_seed(14)
    for make in PLANS:
        for label, plan, widths in make(dev):
            if args.only and not any(s in label for s in args.only):
                continue
            stats = plan_stats(plan)
            print(f"[plan] {label}: {stats}", flush=True)
            pc = cs.plan_on(plan, "cpu")
            for C in widths:
                v64 = torch.randn((stats["R"], C), generator=gen, dtype=torch.float64,
                                  device=dev)
                for d, dtype in DTYPES.items():
                    vals = v64.to(dtype)
                    ref = cs.csr_segment_sum_plain(vals.cpu(), pc)
                    port = lambda vals=vals: cs.csr_segment_sum(vals, plan)  # noqa: E731
                    before = cs.csr_segment_sum.launches
                    port_out = port()
                    if cs.csr_segment_sum.launches != before + 1:
                        raise RuntimeError(f"{label}: {cs.csr_segment_sum.launches - before} "
                                           f"launches per call")
                    others = [(lab, library_call(lib, vals, plan)) for lab, lib in libs.items()]
                    others += [(f"cut {spec}", library_call(port_lib, vals, plan, **kw))
                               for spec, kw in cuts.items()]
                    for turn, order in ((0, others), (1, others[::-1])):
                        if turn:
                            rec = measure(label, "port", port, vals, plan, ref, library=True)
                            rec["launch"] = launch_info(plan, C, vals.element_size())
                            rec.update(stats)
                            print(line(rec), flush=True)
                            rows.append(rec)
                        for who, call in order:
                            rec = measure(label, who, call, vals, plan, ref, port_out)
                            if who.startswith("cut "):
                                rec["launch"] = launch_info(plan, C, vals.element_size(),
                                                            **cuts[who[4:]])
                            rec.update(stats, turn=turn)
                            print(line(rec), flush=True)
                            rows.append(rec)
                    del vals, ref, port_out
                del v64
            del plan, pc
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
