"""Kernels H (``fem.nonlinear.stvk_internal_force``), I
(``stvk_tangent_apply``), J (``stvk_energy``) and K
(``fem.stencil.strain_apply_geo_vjp``) on one CUDA card: against their plain
versions, bitwise repeat, launches and device activities per call, event and
device times against the byte bound; then where a WingNonlinear solve's
device time goes.

measure(): H, I and J on one wing's f64 geometry with u a displacement scaled
so that its largest displacement gradient |H| is 1e-2 (so the quadratic
terms are not negligible): by default the wing's linear solution under its
pressure (WingStencilT, tol 1e-8), or a seeded random field; x (I's
direction) is seeded random. measure_vjp(): K on a batch's geometry, with u
and the cotangent w seeded random. The shapes (chip_smoke.py phase 8 and
main()): DOF100K wing 0 of the seeded batch and the nonlinear CLI's 16x24x4
wing (B = 1), a sharp-TE 16x24x4 grid and the tiles' edge grids (EDGE_RES,
EDGE_ROWS_RES; H's and I's records name the tile their launch took,
launch_tile); K at the optimize CLI's grids 32x40x4
and 24x32x2 (its record's) at its four starting designs, and DOF100K wings
0-3. Per kernel: the error against the plain version over the plain result's
largest entry, or for H and I the magnitude of the terms that cancel where
u is smooth (error_scales) where that is larger (bar 1e-12), the same bits
twice, the median of 7 event
timings of kernel and plain version, and from torch.profiler windows
(utils/profiling.py::device_time) the device time per launch, repeated and
with the L2 flushed, and the device activities per call. The bound is the
larger of the bytes each call must move (each operand read once, each output
written once) over the card's memory rate and FLOPS_PER_TET per Kuhn tet over
its f64 rate (tpufem_torch/device.py); the share is by the flushed time. No
single PyTorch call computes any of these functions.

newton_profile(): WingNonlinear at the nonlinear CLI's wing and grid, one
load step at a quarter of its pressure (the CLI's first step), three Newton
corrections, solved once to warm up, then under torch.profiler: CG and Newton
iterations, wall, device busy time, and the device time of kernels I, H, J
and B (f64: the linear reference solve; f32: the V-cycle) as shares of it.

--compare LABEL=DIR ...: kernels H, I and J (at every measure() shape) and K
(at every measure_vjp() shape) as built from another csrc/ (the parent
commit's, unpacked with `git archive <rev> tpufem_torch/csrc | tar -x -C
build/parent`, or an edited copy of the port's) are timed the same way, in
turns: the compared builds, the port's own, the compared builds again, each
build a library of its own (ops/kernels.py::compare_libraries) and held to
the plain version and to its own bits on repeat. J's partials are sized by
each library's own tpufem_stvk_energy_blocks. Each library's ptxas
registers and spills are printed, and an empty kernel's device time per
launch (torch.cuda._sleep(0)), the floor of a launch at the small shapes.

Usage: python -m tpufem_torch.profile_nonlinear [--out PATH] [--compare LABEL=DIR ...]
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
from tpufem_torch.fem import nonlinear as nl
from tpufem_torch.fem import stencil as st
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import DOF100K, WingMeshResolution
from tpufem_torch.ops.kernels import (
    build_info,
    check,
    compare_libraries,
    load_kernels,
    ptxas_report,
)
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.utils.profiling import device_time, median_event_ms

# per Kuhn tet: H forms H (72 flops), E (~45), S (~12), P (~60), V P and the 4
# corner forces (~80); I adds dH, dE, dS and dP's two products (~190 more); J
# forms H, E and the density (~135); K forms two H, two sigma, volbar and the
# 4 corner cotangents (~250)
FLOPS_PER_TET = {"stvk_internal_force": 330, "stvk_tangent_apply": 520, "stvk_energy": 135,
                 "strain_apply_geo_vjp": 250}
KERNEL_NAMES = {"stvk_internal_force": "stvk_force", "stvk_tangent_apply": "stvk_tangent",
                "stvk_energy": "stvk_energy", "strain_apply_geo_vjp": "strain_geo_vjp"}
LETTERS = {"stvk_internal_force": "H", "stvk_tangent_apply": "I", "stvk_energy": "J",
           "strain_apply_geo_vjp": "K"}
SOURCES = {"stvk_internal_force": "tpufem_torch/csrc/stvk_force.cu",
           "stvk_tangent_apply": "tpufem_torch/csrc/stvk_tangent.cu",
           "stvk_energy": "tpufem_torch/csrc/stvk_energy.cu",
           "strain_apply_geo_vjp": "tpufem_torch/csrc/strain_geo_vjp.cu"}
REPLACES = {"stvk_internal_force": "tpufem/fem/nonlinear.py:107",
            "stvk_tangent_apply": "tpufem/fem/nonlinear.py:238",
            "stvk_energy": "tpufem/fem/nonlinear.py:130",
            "strain_apply_geo_vjp": "tpufem/fem/adjoint.py:156"}
DESIGNS = {"stvk_internal_force": "csrc/grid_tile.cuh: a thread per cell of a tile of 16 (else 8) "
                                  "node columns at full thickness, all cells at once, one barrier "
                                  "and a fixed-order node sum in shared memory; the StVK body",
           "stvk_tangent_apply": "the same schedule with a 2-field body (x and u)",
           "stvk_energy": "a thread per lane, cell and Kuhn tet (the cell fastest), blocks of "
                          "64-256 threads, a fixed-order shuffle sum per block, the block "
                          "partials summed by the last block in a fixed order",
           "strain_apply_geo_vjp": "a thread per lane, cell and Kuhn tet (the cell fastest), "
                                   "blocks of 64-256 threads, each output written once, no "
                                   "scatter"}
# the design CLIs' defaults
NL_RES = WingMeshResolution(16, 24, 4, 0.006, "le")
NL_P4 = (1.6, 0.3, 0.0, 0.08)
NL_PRESSURE = 1.5e5
OPT_RES = WingMeshResolution(32, 40, 4, 0.006, "le")
OPT_RECORD_RES = WingMeshResolution(24, 32, 2, 0.006, "le")  # results/wing_optimization.json's
# the edges of H's and I's tiles (grid_tile.cuh; the tiles a 132-SM card
# takes): 38 node columns fill no tile of 8 columns and one chord row evenly,
# with a welded trailing edge and two cell layers; and DOF100K with a welded
# trailing edge, whose tiles of 16 columns and 3 chord rows leave 2 of 3 rows
# in the last chord tile (the weld row among them) and 1 of 16 columns in the
# last span tile
EDGE_RES = WingMeshResolution(13, 37, 2, 0.0, "le")
EDGE_ROWS_RES = WingMeshResolution(64, 80, 6, 0.0, "le")
LAM, MU = lame_params(Material())


def opt_start_p4() -> np.ndarray:
    """optimize_wing's four starting designs: its fixed (span, sweep) per
    lane, chord and thickness mid-box (theta = 0)."""
    from tpufem_torch.pipeline.types import PRD_RANGES
    from tpufem_torch.scripts.optimize_wing import FIXED_SPAN_SWEEP

    c, t = (0.5 * sum(PRD_RANGES[k]) for k in ("chord_m", "thickness_ratio"))
    return np.array([[s, c, sw, t] for s, sw in FIXED_SPAN_SWEEP])


def root_mask(res: WingMeshResolution, device) -> torch.Tensor:
    free = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=torch.float64, device=device)
    free[..., 0] = 0.0
    return free


def max_grad(res: WingMeshResolution, geo, u, free) -> float:
    """The largest |H| entry, H = grad u, over the Kuhn tets of every cell."""
    uc = st._corners(st.weld_spread(res, u * free))
    return max(float(nl._elem_H(geo[0], uc, t).abs().max()) for t in range(6))


def seeded_field(res: WingMeshResolution, B: int, seed: int, device) -> torch.Tensor:
    shape = (3, B, res.n_chord + 1, res.n_thick + 1, res.n_span + 1)
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape), device=device)


def linear_u(res: WingMeshResolution, p4, pressure: float, device) -> torch.Tensor:
    """The wing's linear-static displacement (3,1,NI,NK,NJ) under `pressure`."""
    from tpufem_torch.fem.stencil_mg import WingStencilT

    out = WingStencilT(res, device=device).solve(np.asarray(p4, np.float64).reshape(1, 4),
                                                 pressure=pressure, tol=1e-8, maxiter=4000)
    return st.to_grid(res, out.u)


def nl_inputs(res: WingMeshResolution, p4, device, u=None, seed=0):
    """(geo, u, x, free), f64 on `device`: wing p4's geometry, u (the given
    field, else a seeded random one) scaled to max |grad u| = 1e-2, a seeded
    random direction x and the root mask."""
    X = st.nodes_grid(res, torch.as_tensor(np.asarray(p4, np.float64).reshape(1, 4),
                                           device=device), torch.float64)
    geo = st.cell_geometry(res, X)
    free = root_mask(res, device)
    u = seeded_field(res, 1, seed, device) if u is None else u.to(device, torch.float64)
    u = (u * (1e-2 / max_grad(res, geo, u, free))).contiguous()
    return geo, u, seeded_field(res, 1, seed + 1, device), free


def launch_tile(res: WingMeshResolution, B: int = 1) -> tuple[int, int]:
    """(owned node columns along span, chord rows): the tile kernels H and I
    launch with at grid res on the current card."""
    out = (ctypes.c_int * 2)()
    load_kernels().tpufem_grid_tile_f64(B, res.n_chord + 1, res.n_thick + 1, res.n_span + 1,
                                        ctypes.addressof(out))
    return out[0], out[1]


def error_scales(res, geo, u, x, free) -> dict:
    """The scale H's and I's errors are judged against: the plain version's
    largest entry, or the magnitude of the terms whose sums cancel, where
    that is larger. Where u is smooth (a linear solution), H = sum_a g_a u_a
    cancels the cells' translation (terms ~1e3 |H| at DOF100K) and sym(H)
    their rotation, so both versions carry a rounding error of a few eps of
    kernel B's plain operator applied to |u| with |g|, which this returns
    (for I, also to |x|). J sums positive terms and K no node sums: their
    scale is their result's largest entry."""
    ga = (geo[0].abs(), geo[1])

    def lin(v):
        return float(st.strain_apply_plain(res, ga, v.abs(), free, LAM, MU).abs().max())

    return {"stvk_internal_force": lin(u), "stvk_tangent_apply": max(lin(u), lin(x))}


def nl_calls(res, geo, u, x, free):
    """{kernel: (call, plain call, the operands it reads)} on one set of inputs."""
    return {
        "stvk_internal_force": (lambda: nl.stvk_internal_force(res, geo, u, free, LAM, MU),
                                lambda: nl.stvk_internal_force_plain(res, geo, u, free, LAM, MU),
                                (*geo, u, free)),
        "stvk_tangent_apply": (lambda: nl.stvk_tangent_apply(res, geo, u, x, free, LAM, MU),
                               lambda: nl.stvk_tangent_apply_plain(res, geo, u, x, free, LAM, MU),
                               (*geo, u, x, free)),
        "stvk_energy": (lambda: nl.stvk_energy(res, geo, u, free, LAM, MU),
                        lambda: nl.stvk_energy_plain(res, geo, u, free, LAM, MU),
                        (*geo, u, free)),
    }


def counter(name: str):
    return st.strain_apply_geo_vjp if name == "strain_apply_geo_vjp" else getattr(nl, name)


def call_bound(name, operands, outputs, n_tets):
    """(bound us, "bytes" or "operations", bytes) of one call: each operand
    read once and each output written once over the card's memory rate, or
    FLOPS_PER_TET per Kuhn tet over its f64 rate, the larger."""
    nbytes = sum(t.numel() * t.element_size() for t in (*operands, *outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_TET[name] * n_tets / PEAK_FLOPS[torch.float64]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations", nbytes


def as_tuple(y) -> tuple:
    """A kernel's result as a tuple of tensors (K returns two)."""
    return y if isinstance(y, tuple) else (y,)


def check_and_time(name, label, fn, plain, operands, n_tets, timed=True, scale=None) -> dict:
    """One kernel's checks (raises on a miss: one launch per call, the same
    bits twice, within 1e-12 of the plain version's largest entry or of
    `scale` where that is larger) and, with `timed`, its times and bound."""
    c = counter(name)
    before = c.launches
    y = fn()
    torch.cuda.synchronize()
    if c.launches != before + 1:
        raise RuntimeError(f"{name} {label}: {c.launches - before} launches per call")
    ys = as_tuple(y)
    if not all(torch.equal(a, b) for a, b in zip(ys, as_tuple(fn()))):
        raise RuntimeError(f"{name} {label}: two calls differ")
    refs = as_tuple(plain())
    out_scale = max(r.abs().max().item() for r in refs)
    scale = max(out_scale, scale or 0.0)
    err = max((a - r).abs().max().item() for a, r in zip(ys, refs))
    if not err <= 1e-12 * scale:
        raise RuntimeError(f"{name} {label}: max|err| {err:.3e} > 1e-12 x {scale:.3e}")
    rec = {"kernel": name, "case": label, "max_abs_err": err, "scale": scale,
           "rel_err": err / scale, "output_scale": out_scale}
    if timed:
        bound_us, bound_by, nbytes = call_bound(name, operands, ys, n_tets)
        r = device_time(fn, KERNEL_NAMES[name], cold=True)
        if r["launches"] != 1 or r["activities"] != 1:
            raise RuntimeError(f"{name} {label}: {r['launches']} launches and "
                               f"{r['activities']} device activities per call, not 1")
        rec.update(ms=median_event_ms(fn, 7), plain_ms=median_event_ms(plain, 7),
                   bound_us=bound_us, bound_by=bound_by, bytes=nbytes,
                   device_us=r["device_us"], device_us_cold=r["device_us_cold"],
                   launches=r["launches"], activities=r["activities"],
                   share=bound_us / r["device_us_cold"], share_repeated=bound_us / r["device_us"])
    return rec


TILED = ("stvk_internal_force", "stvk_tangent_apply")  # on grid_tile.cuh's tiles


def measure(label, res, p4, device, u=None, seed=0, timed=True) -> dict:
    """Kernels H, I and J on nl_inputs(res, p4, device, u, seed):
    {kernel: record}; raises on a miss."""
    geo, u, x, free = nl_inputs(res, p4, device, u, seed)
    scales = error_scales(res, geo, u, x, free)
    own_j, own_i = launch_tile(res)
    tile = {"tile": [own_j, own_i],
            "blocks": -(-(res.n_span + 1) // own_j) * -(-(res.n_chord + 1) // own_i)}
    return {name: {**check_and_time(name, label, fn, plain, ops, geo[1].numel(), timed,
                                    scales.get(name)),
                   "grid": list(res.key), "B": 1, **(tile if name in TILED else {})}
            for name, (fn, plain, ops) in nl_calls(res, geo, u, x, free).items()}


def vjp_inputs(res: WingMeshResolution, p4, device, seed=0):
    """(geo, u, w, free), f64 on `device`: the geometry of the batch p4
    (B,4), u 1e-4 times a seeded random field, a seeded random cotangent w
    and the root mask."""
    p4 = torch.as_tensor(np.asarray(p4, np.float64), device=device)
    geo = st.cell_geometry(res, st.nodes_grid(res, p4, torch.float64))
    B = p4.shape[0]
    return (geo, 1e-4 * seeded_field(res, B, seed, device), seeded_field(res, B, seed + 1, device),
            root_mask(res, device))


def vjp_call(res, geo, u, w, free):
    """(call, plain call, the operands it reads) of kernel K."""
    return (lambda: st.strain_apply_geo_vjp(res, geo, u, w, free, LAM, MU),
            lambda: st.strain_apply_geo_vjp_plain(res, geo, u, w, free, LAM, MU),
            (*geo, u, w, free))


def measure_vjp(label, res, p4, device, seed=0, timed=True) -> dict:
    """Kernel K at grid res on vjp_inputs(res, p4, device, seed): the record;
    raises on a miss."""
    geo, u, w, free = vjp_inputs(res, p4, device, seed)
    rec = check_and_time("strain_apply_geo_vjp", label, *vjp_call(res, geo, u, w, free),
                         geo[1].numel(), timed)
    return {**rec, "grid": list(res.key), "B": int(u.shape[1])}


def library_call(lib, name, res, geo, u, x, free):
    """Kernel H, I, J or K (x then the cotangent w) through another build of
    the kernels (--compare): the wrapper's launch without its operand checks
    and launch counter, J's partials sized by that library's own
    tpufem_stvk_energy_blocks. Returns the call; each call overwrites its
    output buffers."""
    g, vol = geo
    _, B, NI, NK, NJ = u.shape
    if name == "stvk_energy":
        outs = (torch.empty((), dtype=u.dtype, device=u.device),)
        partial = torch.empty(lib.tpufem_stvk_energy_blocks(B, NI, NK, NJ), dtype=u.dtype,
                              device=u.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=u.device)
        fn, ptrs = lib.tpufem_stvk_energy_f64, (g, vol, u, free, partial, ticket, outs[0])
    elif name == "strain_apply_geo_vjp":
        outs = (torch.empty_like(g), torch.empty_like(vol))
        fn, ptrs = lib.tpufem_strain_geo_vjp_f64, (g, vol, u, x, free, *outs)
    else:
        outs = (torch.empty_like(u),)
        fn, ptrs = ((lib.tpufem_stvk_force_f64, (g, vol, u, free, *outs))
                    if name == "stvk_internal_force"
                    else (lib.tpufem_stvk_tangent_f64, (g, vol, x, u, free, *outs)))
    shape = (B, NI, NK, NJ, int(res.te_floor_frac == 0.0), float(LAM), float(MU))

    def call():  # reads ptrs, which keeps J's partials and ticket alive with the call
        check(fn(*(t.data_ptr() for t in ptrs), *shape,
                 torch.cuda.current_stream(u.device).cuda_stream), KERNEL_NAMES[name])
        return outs if len(outs) > 1 else outs[0]

    return call


def library_record(name, label, lib_label, fn, plain, operands, n_tets, scale=None) -> dict:
    """One kernel of another build on one set of inputs: the error against
    the plain version (over its largest entry, or `scale` where that is
    larger), the same bits twice, device time repeated and with the L2
    flushed, device activities per call and the share of the same bound."""
    ys = tuple(y.clone() for y in as_tuple(fn()))
    again, refs = as_tuple(fn()), as_tuple(plain())
    scale = max(max(r.abs().max().item() for r in refs), scale or 0.0)
    err = max((a - r).abs().max().item() for a, r in zip(ys, refs))
    r = device_time(fn, KERNEL_NAMES[name], cold=True)
    bound_us, bound_by, _ = call_bound(name, operands, ys, n_tets)
    return {"kernel": name, "library": lib_label, "case": label, "max_abs_err": err,
            "rel_err": err / scale,
            "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(ys, again)),
            "device_us": r["device_us"], "device_us_cold": r["device_us_cold"],
            "launches": r["launches"], "activities": r["activities"], "bound_us": bound_us,
            "bound_by": bound_by, "share": bound_us / r["device_us_cold"],
            "share_repeated": bound_us / r["device_us"]}


def measure_library(label, lib_label, lib, res, p4, device, u=None, seed=0) -> dict:
    """Kernels H, I and J of library `lib` (another commit's or a variant's
    build) on measure()'s inputs and error scales (library_record). Returns
    {kernel: record}."""
    geo, u, x, free = nl_inputs(res, p4, device, u, seed)
    scales = error_scales(res, geo, u, x, free)
    return {name: {**library_record(name, label, lib_label,
                                    library_call(lib, name, res, geo, u, x, free), plain,
                                    operands, geo[1].numel(), scales.get(name)),
                   "grid": list(res.key), "B": 1}
            for name, (_, plain, operands) in nl_calls(res, geo, u, x, free).items()}


def measure_vjp_library(label, lib_label, lib, res, p4, device, seed=0) -> dict:
    """Kernel K of library `lib` on measure_vjp()'s inputs (library_record).
    Returns {kernel: record}."""
    geo, u, w, free = vjp_inputs(res, p4, device, seed)
    name = "strain_apply_geo_vjp"
    _, plain, operands = vjp_call(res, geo, u, w, free)
    rec = library_record(name, label, lib_label, library_call(lib, name, res, geo, u, w, free),
                         plain, operands, geo[1].numel())
    return {name: {**rec, "grid": list(res.key), "B": int(u.shape[1])}}


def library_line(rec) -> str:
    return (f"[compare {rec['library']}] {rec['kernel']} {rec['case']} {rec['grid']}: rel err "
            f"{rec['rel_err']:.2e}, bitwise repeat {rec['bitwise_repeat']}; device "
            f"{rec['device_us']:.2f} us repeated, {rec['device_us_cold']:.2f} us L2 flushed, "
            f"{rec['launches']:.0f} launch and {rec['activities']:.0f} activity per call; bound "
            f"{rec['bound_us']:.2f} us: {rec['share']:.1%} flushed")


def ptxas_line(label, log) -> str:
    """The registers and spills ptxas reported for the grid kernels of one
    library's build (kernels B, G, H, I, J, K)."""
    keep = ("strain_apply_kernel", "geom_apply_kernel", "stvk_force_kernel",
            "stvk_tangent_kernel", "stvk_energy_kernel", "strain_geo_vjp_kernel")
    rep = {k: v for k, v in ptxas_report(log).items() if any(n in k for n in keep)}
    return f"[ptxas {label}] (registers, spill store bytes, spill load bytes): {rep}"


def line(rec) -> str:
    s = (f"[kernel {LETTERS[rec['kernel']]}] {rec['kernel']} {rec['case']} {rec['grid']} "
         f"B={rec['B']} f64: max|err| {rec['max_abs_err']:.3e} (scale {rec['scale']:.3e}, rel "
         f"{rec['rel_err']:.2e}; the result's largest entry {rec['output_scale']:.3e}), bitwise "
         f"repeatable")
    if "tile" in rec:
        s += f"; tile {rec['tile'][0]} x {rec['tile'][1]} node columns, {rec['blocks']} blocks"
    if "ms" in rec:
        s += (f"; {rec['launches']:.0f} launch, {rec['activities']:.0f} device activity per call;"
              f" event {rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms (median of 7); device "
              f"{rec['device_us']:.2f} us repeated, {rec['device_us_cold']:.2f} us L2 flushed; "
              f"bound {rec['bound_us']:.2f} us ({rec['bound_by']}, {rec['bytes'] / 1e6:.1f} MB): "
              f"{rec['share']:.1%} flushed, {rec['share_repeated']:.1%} repeated; no one-call "
              f"PyTorch equivalent")
    return s


def shapes(device, u_dof100k=None):
    """The cases of measure() and measure_vjp() as (label, function, kwargs),
    at the shapes chip_smoke.py's phase 8 launches the kernels with."""
    w0 = seeded_batch(8)[0]
    return [
        ("DOF100K wing 0, linear u", measure, {"res": DOF100K, "p4": w0, "u": u_dof100k}),
        ("DOF100K wing 0, random u", measure, {"res": DOF100K, "p4": w0, "seed": 3}),
        ("16x24x4 CLI wing, linear u", measure,
         {"res": NL_RES, "p4": NL_P4, "u": linear_u(NL_RES, NL_P4, NL_PRESSURE, device)}),
        ("16x24x4 sharp TE, random u", measure,
         {"res": WingMeshResolution(16, 24, 4, 0.0, "le"), "p4": NL_P4, "seed": 5}),
        ("13x37x2 ragged tiles, sharp TE, random u", measure, {"res": EDGE_RES, "p4": NL_P4,
                                                               "seed": 7}),
        ("DOF100K sharp TE, ragged tiles, random u", measure, {"res": EDGE_ROWS_RES, "p4": w0,
                                                               "seed": 9}),
        ("32x40x4 optimizer start", measure_vjp, {"res": OPT_RES, "p4": opt_start_p4()}),
        ("24x32x2 optimizer start", measure_vjp, {"res": OPT_RECORD_RES, "p4": opt_start_p4()}),
        ("DOF100K wings 0-3", measure_vjp, {"res": DOF100K, "p4": seeded_batch(8)[:4]}),
    ]


def newton_profile(device) -> dict:
    """Where a WingNonlinear solve's device time goes (module docstring)."""
    solver = nl.WingNonlinear(NL_RES, NL_P4, pressure=NL_PRESSURE / 4, inner_tol=1e-10,
                              inner_maxiter=800, device=device)

    def solve():
        out = solver.solve(n_steps=1, max_newton=3)
        torch.cuda.synchronize()
        return out

    solve()  # builds the solver's state and the kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = solve()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    groups = {"I stvk_tangent": lambda n: "stvk_tangent" in n,
              "H stvk_force": lambda n: "stvk_force" in n,
              "J stvk_energy": lambda n: "stvk_energy" in n,
              "B strain_apply f64": lambda n: "strain_apply" in n and "double" in n,
              "B strain_apply f32": lambda n: "strain_apply" in n and "float" in n}
    by = {k: [e.time_range.elapsed_us() for e in dev if f(e.name)] for k, f in groups.items()}
    if not by["I stvk_tangent"]:
        raise RuntimeError("the profiler saw no stvk_tangent kernel in the Newton solve")
    return {"case": "Newton solve", "grid": list(NL_RES.key), "pressure": NL_PRESSURE / 4,
            "newton_iters": out.newton_iters, "cg_iters": out.cg_iters,
            "rel_residual": out.rel_residual, "wall_s": wall, "busy_s": busy_us / 1e6,
            "busy_share_of_wall": busy_us / 1e6 / wall, "activities": len(dev),
            "ms_per_cg_iter": wall / max(out.cg_iters, 1) * 1e3,
            "kernels": {k: {"launches": len(v), "us_per_launch": sum(v) / max(len(v), 1),
                            "share_of_busy": sum(v) / busy_us} for k, v in by.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time kernels H, I, J and K as built from each csrc/ DIR "
                         "(another commit's, or an edited copy), before and after the port's "
                         "own, at every shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_nonlinear: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    load_kernels()
    libs = compare_libraries(args.compare)
    print(ptxas_line("port", build_info.get("log", "")), flush=True)
    for lab, lib in libs.items():
        print(ptxas_line(lab, lib.build_info.get("log", "")), flush=True)
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    r = device_time(empty, "")  # the window holds nothing else
    print(f"[empty kernel] torch.cuda._sleep(0): device {r['device_us']:.2f} us per launch, "
          f"event {median_event_ms(empty, 7):.4f} ms: the floor of one launch", flush=True)
    rows = [{"case": "empty kernel", **r}]
    for label, fn, kw in shapes(dev):
        # in turns: the compared builds, the port's kernels, the compared builds again
        for turn in (0, 1):
            if turn:
                out = fn(label, device=dev, **kw)
                for rec in (out.values() if fn is measure else (out,)):
                    print(line(rec), flush=True)
                    rows.append(rec)
            lib_fn = measure_library if fn is measure else measure_vjp_library
            for lab, lib in (libs.items() if turn == 0 else reversed(libs.items())):
                for rec in lib_fn(label, lab, lib, device=dev, **kw).values():
                    print(library_line(rec), flush=True)
                    rows.append({**rec, "turn": turn})
    r = newton_profile(dev)
    print(f"[newton] {r['grid']} p={r['pressure']:.0f}: {r['newton_iters']} Newton, "
          f"{r['cg_iters']} CG iterations, {r['wall_s']:.3f} s ({r['ms_per_cg_iter']:.3f} ms per "
          f"CG iteration, linear reference included); busy {r['busy_s']:.3f} s = "
          f"{r['busy_share_of_wall']:.1%} of the wall; "
          + "; ".join(f"{k}: {v['launches']} launches, {v['us_per_launch']:.2f} us each, "
                      f"{v['share_of_busy']:.1%} of busy" for k, v in r["kernels"].items()),
          flush=True)
    rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
