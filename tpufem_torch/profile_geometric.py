"""Kernels F (``fem.buckling.element_stress``) and G (``fem.buckling.geom_apply``)
on one CUDA card: against their plain versions, bitwise repeat, launches and
device activities per call, event and device times against the byte bound;
then G's share of a prestressed block-CG iteration, and the sweeps of
WingBuckling at the CLI defaults.

The kernels' inputs are the block eigensolvers': one wing tiled over q lanes
(wing 0 of the seeded batch chip_smoke.py solves, or the dynamics CLIs'
default wing), its f64 cell geometry, a seeded random displacement u0 for the
pre-stress (sigma = the plain f64 element_stress of u0, so it is symmetric as
the solvers' is) and a seeded random block x. The shapes are DOF100K and
MEDIUM (sharp TE) at q = 12, and the CLIs' grid 32x40x4 at the lane counts
the buckling (q = 16) and prestress (q = 12) CLIs launch F and G with. Per
kernel and dtype: the kernel's error against the plain f64 result over that
result's largest entry (bars 1e-12 in f64, 1e-5 in f32), the same bits
twice, the median of 7 event timings of kernel and plain version, and from
torch.profiler windows (utils/profiling.py::device_time) the kernel's device
time per launch, repeated and with the L2 flushed, and the device activities
per call. The bound is the larger of the bytes each call must move (each
operand read once, the output written once) over the card's memory rate and
FLOPS_PER_TET per Kuhn tet over its f64 or f32 rate (tpufem_torch/device.py);
the share is by the flushed time.

prestress_share: WingPrestressedModal at the CLI defaults (6 modes, q = 12,
tol 1e-9, inner_maxiter 400) at p = PRESTRESS_P, solved once to warm up, once
timed, once under torch.profiler: CG iterations, ms per iteration, the
device's busy time and kernel G's device time, per iteration and as shares
of the busy time and of the profiled wall.

buckling_history: WingBuckling at the CLI defaults (4 modes, q = 16) at each
--buckling_tols tolerance: the factors, the sweeps, and per sweep the inner
CG tolerance, its iterations and the factors' largest relative change.

--compare LABEL=DIR ...: kernel G as built from another csrc/ (the parent
commit's, unpacked with `git archive <rev> tpufem_torch/csrc | tar -x -C
build/parent`, or a variant's) is timed at every shape beside the port's
own, before and after it in turns, into a library of its own
(ops/kernels.py::compare_libraries), and its result is held to the port's
bit for bit; nothing else loads it.

Usage: python -m tpufem_torch.profile_geometric [--out PATH]
           [--buckling_tols 1e-5 1e-7] [--compare LABEL=DIR ...]
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
from tpufem_torch.fem import buckling as bk
from tpufem_torch.fem import stencil as st
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import DOF100K, MEDIUM, WingMeshResolution
from tpufem_torch.ops.kernels import check, compare_libraries
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.utils.profiling import device_time, median_event_ms

# per Kuhn tet: F forms H (72 flops), sym(H) and sigma (~25); G forms
# sigma g_b for 4 b (60), H (72), V H (9) and the 4 corner forces (60)
FLOPS_PER_TET = {"element_stress": 97, "geom_apply": 201}
Q = 12  # the block size of a 6-mode WingModal and of WingPrestressedModal
# the dynamics CLIs' defaults: grid, wing, and the lane counts they launch F
# and G with (buckling_analysis's 4 modes: q = 2k + 8; prestress_sweep's
# --n_modes 6: q = min(2k, k + 8))
CLI_RES = WingMeshResolution(32, 40, 4, 0.006, "le")
CLI_P4 = (1.2, 0.35, 10.0, 0.10)
CLI_SHAPES = {"32x40x4 buckling": 16, "32x40x4 prestress": 12}
PRESTRESS_P = 1283.74  # half of the CLI default wing's lambda_cr, 2567.48
SOURCES = {"element_stress": "tpufem_torch/csrc/element_stress.cu",
           "geom_apply": "tpufem_torch/csrc/geom_apply.cu"}
REPLACES = {"element_stress": "tpufem/fem/buckling.py:71",
            "geom_apply": "tpufem/fem/buckling.py:93"}
DESIGNS = {"element_stress": "a thread per lane and cell, the 6 tets in turn",
           "geom_apply": "cell-centric walk shared with kernel B (csrc/grid_walk.cuh): a block per "
                         "lane and 32 x 4 cell tile, 22 planes per (layer, tet) staged "
                         "through a cp.async ring, fixed-order node sums, no atomics"}


def geometric_inputs(res, q, device, p4=None, seed=0, symmetric=True):
    """(geo, u0, sig, x, free) in f64 on `device`: wing p4 (default wing 0 of
    the seeded batch) tiled over q lanes, as GridBlockSolver builds its
    geometry. With `symmetric` False, sig gets a seeded non-symmetric part of
    its own size, which holds kernel G to tpufem's g_a^T sigma g_b (a kernel
    that formed g_b^T sigma g_a agrees only on a symmetric sigma)."""
    p4 = np.tile(np.asarray(seeded_batch(8)[0] if p4 is None else p4, np.float64), (q, 1))
    X = st.nodes_grid(res, torch.as_tensor(p4, device=device), torch.float64)
    geo = st.cell_geometry(res, X)
    gen = torch.Generator(device=device).manual_seed(seed)
    u0 = 1e-3 * torch.randn(X.shape, generator=gen, dtype=torch.float64, device=device)
    x = torch.randn(X.shape, generator=gen, dtype=torch.float64, device=device)
    free = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=torch.float64, device=device)
    free[..., 0] = 0.0
    lam, mu = lame_params(Material())
    sig = bk.element_stress_plain(res, geo, u0, lam, mu)
    if not symmetric:
        sig = sig + sig.abs().max() * torch.randn(sig.shape, generator=gen, dtype=torch.float64,
                                                  device=device)
    return geo, u0, sig, x, free


def calls(res, geo, u0, sig, x, free):
    """{kernel: (call, plain call, its operands)} on one set of inputs."""
    lam, mu = lame_params(Material())
    return {
        "element_stress": (lambda: bk.element_stress(res, geo, u0, lam, mu),
                           lambda: bk.element_stress_plain(res, geo, u0, lam, mu),
                           (geo[0], u0)),
        "geom_apply": (lambda: bk.geom_apply(res, geo, sig, x, free),
                       lambda: bk.geom_apply_plain(res, geo, sig, x, free),
                       (geo[0], geo[1], sig, x, free)),
    }


def call_bound(name, operands, out, n_tets, dtype):
    """(bound in us, "bytes" or "operations") of one call."""
    nbytes = sum(t.numel() * t.element_size() for t in (*operands, out))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_TET[name] * n_tets / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def measure(res, q, device, p4=None, timed=True, symmetric=True):
    """Every kernel of F and G in f64 and f32 at grid `res`, q lanes of wing
    p4 (sig non-symmetric unless `symmetric`): checks (raises on a miss) and,
    with `timed`, times. Returns {"<kernel> <dtype>": record}."""
    geo64, u064, sig64, x64, free64 = geometric_inputs(res, q, device, p4, symmetric=symmetric)
    refs = {k: plain() for k, (_, plain, _) in calls(res, geo64, u064, sig64, x64,
                                                      free64).items()}
    out = {}
    for dt, dname in ((torch.float64, "f64"), (torch.float32, "f32")):
        geo = tuple(t.to(dt) for t in geo64)
        args = (geo, u064.to(dt), sig64.to(dt), x64.to(dt), free64.to(dt))
        for name, (fn, plain, operands) in calls(res, *args).items():
            ref = refs[name]
            counter = getattr(bk, name)
            before = counter.launches
            y = fn()
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise RuntimeError(f"{name} {dname}: {counter.launches - before} launches per call")
            if not torch.equal(y, fn()):
                raise RuntimeError(f"{name} {dname}: two calls differ")
            scale = ref.abs().max().item()
            err = (y.double() - ref).abs().max().item()
            plain_err = (plain().double() - ref).abs().max().item()
            bar = 1e-12 if dt == torch.float64 else 1e-5
            if not err <= bar * scale:
                raise RuntimeError(f"{name} {dname} at {res.key} q={q}: max|err| {err:.3e} > "
                                   f"{bar} x {scale:.3e}")
            rec = {"kernel": name, "grid": list(res.key), "q": q, "dtype": dname,
                   "symmetric_sigma": symmetric,
                   "max_abs_err": err, "scale": scale, "rel_err": err / scale,
                   "plain_max_abs_err": plain_err}
            if timed:
                n_tets = geo[1].numel()  # vol holds one entry per (tet, lane, cell)
                bound_us, by = call_bound(name, operands, y, n_tets, dt)
                r = device_time(fn, name, cold=True)
                if r["launches"] != 1 or r["activities"] != 1:
                    raise RuntimeError(f"{name} {dname}: {r['launches']} launches and "
                                       f"{r['activities']} device activities per call, not 1")
                rec.update(
                    ms=median_event_ms(fn, 7), plain_ms=median_event_ms(plain, 7),
                    bound_us=bound_us, bound_by=by, device_us=r["device_us"],
                    device_us_cold=r["device_us_cold"], launches=r["launches"],
                    activities=r["activities"], share=bound_us / r["device_us_cold"],
                    share_repeated=bound_us / r["device_us"])
            out[f"{name} {dname}"] = rec
    return out


def library_geom_apply(lib, res, geo, sig, u, free):
    """geom_apply through another build of the kernels (--compare): the
    wrapper's launch without its operand checks and launch counter. Returns
    the call; each call overwrites one output buffer."""
    g, vol = geo
    _, B, NI, NK, NJ = u.shape
    y = torch.empty_like(u)
    fn = lib.tpufem_geom_apply_f64 if u.dtype == torch.float64 else lib.tpufem_geom_apply_f32
    args = (g.data_ptr(), vol.data_ptr(), sig.data_ptr(), u.data_ptr(), free.data_ptr(),
            y.data_ptr(), B, NI, NK, NJ, int(res.te_floor_frac == 0.0))

    def call():
        check(fn(*args, torch.cuda.current_stream(u.device).cuda_stream), "geom_apply")
        return y

    return call


def measure_library(label, lib, res, q, device, p4=None):
    """Kernel G of library `lib` (another commit's or a variant's build) on
    measure()'s inputs: error against the plain f64 result, the same bits
    twice, device time repeated and with the L2 flushed, and the share of
    the same bound. Returns {"geom_apply <dtype>": record}."""
    geo64, _, sig64, x64, free64 = geometric_inputs(res, q, device, p4)
    ref = bk.geom_apply_plain(res, geo64, sig64, x64, free64)
    out = {}
    for dt, dname in ((torch.float64, "f64"), (torch.float32, "f32")):
        geo = tuple(t.to(dt) for t in geo64)
        sig, x, free = sig64.to(dt), x64.to(dt), free64.to(dt)
        fn = library_geom_apply(lib, res, geo, sig, x, free)
        y = fn().clone()
        port = bk.geom_apply(res, geo, sig, x, free)
        err = (y.double() - ref).abs().max().item()
        r = device_time(fn, "geom_apply", cold=True)
        bound_us, by = call_bound("geom_apply", (geo[0], geo[1], sig, x, free), y,
                                  geo[1].numel(), dt)
        out[f"geom_apply {dname}"] = {
            "kernel": "geom_apply", "library": label, "grid": list(res.key), "q": q,
            "dtype": dname, "max_abs_err": err, "rel_err": err / ref.abs().max().item(),
            "bitwise_repeat": bool(torch.equal(y, fn())), "same_bits_as_port": bool(
                torch.equal(y, port)), "device_us": r["device_us"],
            "device_us_cold": r["device_us_cold"], "activities": r["activities"],
            "bound_us": bound_us, "bound_by": by, "share": bound_us / r["device_us_cold"],
            "share_repeated": bound_us / r["device_us"]}
    return out


def library_line(label, rec):
    return (f"[compare {rec['library']}] geom_apply {label} q={rec['q']} {rec['dtype']}: rel err "
            f"{rec['rel_err']:.2e}, bitwise repeat {rec['bitwise_repeat']}, the port's bits "
            f"{rec['same_bits_as_port']}; device "
            f"{rec['device_us']:.2f} us repeated, {rec['device_us_cold']:.2f} us L2 flushed, "
            f"{rec['activities']:.0f} activity per call; bound {rec['bound_us']:.2f} us: "
            f"{rec['share']:.1%} flushed")


def line(label, rec):
    s = (f"[kernel {'F' if rec['kernel'] == 'element_stress' else 'G'}] {rec['kernel']} {label} "
         f"q={rec['q']} {rec['dtype']}: max|err| {rec['max_abs_err']:.3e} (scale "
         f"{rec['scale']:.3e}, rel {rec['rel_err']:.2e}; plain in this dtype "
         f"{rec['plain_max_abs_err']:.3e}), bitwise repeatable")
    if "ms" in rec:
        s += (f"; {rec['launches']:.0f} launch, {rec['activities']:.0f} device activity per call;"
              f" event {rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms (median of 7); device "
              f"{rec['device_us']:.2f} us repeated, {rec['device_us_cold']:.2f} us L2 flushed; "
              f"bound {rec['bound_us']:.2f} us ({rec['bound_by']}): {rec['share']:.1%} flushed, "
              f"{rec['share_repeated']:.1%} repeated; no one-call PyTorch equivalent")
    return s


def prestress_share(device) -> dict:
    """Kernel G's device time within WingPrestressedModal's block CG at the
    CLI defaults (module docstring)."""
    wp = bk.WingPrestressedModal(CLI_RES, CLI_P4, inner_maxiter=400, device=device)

    def solve():
        out = wp.solve(n_modes=6, load_factor=PRESTRESS_P, tol=1e-9)
        torch.cuda.synchronize()
        return out

    solve()  # builds the solver's state and the kernels
    t0 = time.perf_counter()
    out = solve()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        wall_prof = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    g_us = [e.time_range.elapsed_us() for e in dev if "geom_apply" in e.name]
    if not g_us:
        raise RuntimeError("the profiler saw no geom_apply kernel in the prestressed solve")
    it = out.inner_iters
    return {"case": "prestressed block CG", "grid": list(CLI_RES.key), "q": 12,
            "load_factor": PRESTRESS_P, "sweeps": out.sweeps, "inner_iters": it,
            "converged": bool(out.converged), "wall_s": wall, "ms_per_iter": wall / it * 1e3,
            "wall_s_profiled": wall_prof, "busy_ms_per_iter": busy_us / it / 1e3,
            "activities_per_iter": len(dev) / it, "geom_apply_launches": len(g_us),
            "geom_apply_us_per_launch": sum(g_us) / len(g_us),
            "geom_apply_share_of_busy": sum(g_us) / busy_us,
            "geom_apply_share_of_wall": sum(g_us) / 1e6 / wall_prof,
            "busy_share_of_wall": busy_us / 1e6 / wall_prof}


def buckling_history(device, tol: float) -> dict:
    """WingBuckling at the CLI defaults to `tol` (module docstring)."""
    wb = bk.WingBuckling(CLI_RES, CLI_P4, device=device)
    t0 = time.perf_counter()
    out = wb.solve(n_modes=4, tol=tol, max_sweeps=200)
    return {"case": "buckling", "tol": tol, "factors": out.factors.tolist(),
            "sweeps": out.sweeps, "converged": out.converged,
            "wall_s": time.perf_counter() - t0,
            "history": [{"inner_tol": float(t), "cg_iters": n, "rel_change": r}
                        for t, n, r in out.history]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--buckling_tols", type=float, nargs="*", default=[1e-5, 1e-7])
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time kernel G as built from each csrc/ DIR (another commit's or a "
                         "variant's), before and after the port's own, at every shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_geometric: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = compare_libraries(args.compare)
    rows = []
    cases = [("DOF100K", DOF100K, Q, None), ("MEDIUM (sharp TE)", MEDIUM, Q, None)]
    cases += [(label, CLI_RES, q, CLI_P4) for label, q in CLI_SHAPES.items()]
    for label, res, q, p4 in cases:
        # in turns: the compared builds, the port's kernels, the compared builds again
        for turn in (0, 1):
            if turn:
                for key, rec in measure(res, q, dev, p4).items():
                    print(line(label, rec), flush=True)
                    rows.append({"case": label, **rec})
            for lab, lib in (libs.items() if turn == 0 else reversed(libs.items())):
                for rec in measure_library(lab, lib, res, q, dev, p4).values():
                    print(library_line(label, rec), flush=True)
                    rows.append({"case": label, "turn": turn, **rec})
    r = prestress_share(dev)
    print(f"[prestress] {r['grid']} q=12 p={PRESTRESS_P}: {r['sweeps']} sweeps, "
          f"{r['inner_iters']} CG iterations, {r['wall_s']:.3f} s, {r['ms_per_iter']:.3f} ms per "
          f"iteration; profiled: busy {r['busy_ms_per_iter']:.3f} ms and "
          f"{r['activities_per_iter']:.1f} activities per iteration, busy "
          f"{r['busy_share_of_wall']:.1%} of the wall; kernel G {r['geom_apply_launches']} "
          f"launches, {r['geom_apply_us_per_launch']:.2f} us each, "
          f"{r['geom_apply_share_of_busy']:.2%} of the busy time, "
          f"{r['geom_apply_share_of_wall']:.2%} of the wall", flush=True)
    rows.append(r)
    for tol in args.buckling_tols:
        r = buckling_history(dev, tol)
        print(f"[buckling] tol {tol:g}: factors {r['factors']}, {r['sweeps']} sweeps, converged "
              f"{r['converged']}, {r['wall_s']:.3f} s; per sweep (inner tol, CG iterations, "
              f"rel change): {[tuple(h.values()) for h in r['history']]}", flush=True)
        rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
