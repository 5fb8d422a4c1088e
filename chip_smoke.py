#!/usr/bin/env python3
"""Smoke run of the tpufem_torch port on one CUDA card (H100, sm_90a).

Drives the port's main path once at full size: a batch of 8 PRD wing designs
(the seeded batch bench.py times) -> DOF100K (64x80x6 cells, 109,107 DOF)
f64-outer multigrid-CG solve -> von Mises -> surface graphs -> the full-width
GraphSAGE surrogate forward (random weights from a seeded torch.Generator; no
trained checkpoint exists). Along the way:

  1. builds the CUDA kernels from tpufem_torch/csrc (nvcc, into build/) and
     prints the card's name and power limit;
  2. checks kernel B (strain_apply, the whole welded and Dirichlet-wrapped
     operator in one launch) against its plain PyTorch version in f64 and f32
     at every V-cycle level that applies it, at DOF100K B=8 and at MEDIUM
     (sharp TE) B=1, bitwise repeatable; then at DOF100K its single-call
     times, its device time per launch from a torch.profiler window against
     the byte bound, and its device activities per apply (exactly 1);
  3. solves, and recomputes the TRUE f64 residual independently on the CPU
     (plain strain_apply, numpy loads); checks the physics;
  4. runs the surrogate on all 8 surface graphs under aggregate_impl
     "segment" (the fused neighbour mean: the row-pointer kernel once and
     kernel A entry (b) once per layer) and on the first under "pallas"
     (messages materialised: kernel C gathers them, kernel A entry (a) sums
     them), holds the two against each other and against the plain forward
     on the CPU, and checks every entry of csrc/segment_sum.cu against its
     plain version at one graph and at the 8-graph batch, with its event
     time, device time, plain and library times and bound;
  5. the training path, through the port's CLIs in a temporary --data_root
     under build/: 16 DOF100K wings (geometry -> mesh -> batched FEM, all
     converged at TRUE rel <= 1e-6, every stage's GLBs written and parsed),
     3 epochs of the full-width GraphSAGE (9 steps at batch 4, the fused
     route: kernel A entry (b) forward, and backward over the transposed
     plan), inference on the 3 test wings (with wing_pred.glb /
     wing_error.glb); then the card's gradients of one merged batch against
     the CPU's under both aggregate_impl values (the "pallas" route's
     backward launches kernels C and A entry (b)), the step's
     forward/backward/optimizer times, and every entry of segment_sum.cu
     again at the merged batch's shape (kernel C's headline shape);
  6. the gather path: (a) kernel D (stiffness_apply: the gather operator's
     mask, element forces, per-node sum and Dirichlet identity in one launch)
     against the plain composition at the DOF100K mesh's shapes, f64 and f32,
     masked and unmasked, and on the same mesh with its nodes renumbered by a
     seeded permutation (a stand-in for a user mesh), bitwise repeatable,
     exactly 1 launch and 1 device activity per apply, with its event times,
     device time (repeated and with the L2 flushed) and bound; kernel E
     (csr_segment_sum) at every plan and width it runs at on the gather path
     (DOF100K wing 0: the incidence at C = 3, 6, 1, the loads, the line
     blocks' blk_plan, the RBM group_plan at C = 4 and 6 and the RBM
     pair_plans[0] at C = 36) and in the stencil engine (phase 3's batch:
     upper_plan at C = 3B, tet_plan at C = 6B and B): bit for bit the CPU
     plain version's output in f64 and f32, with event, plain and library
     times (zeros, then index_add_) and device times per launch (repeated
     and flushed; the library's by every activity) against the byte bound;
     (b) phase 3's batch solved again, on a fresh WingStencilT (its
     setup built anew: kernel E's fixed summation order) and on phase 3's
     solver (a hit of its setup cache, setup 0 s): the same iterations and
     bitwise-equal nodes / u / stress6 / vm / residuals; (c)
     the first wing of the batch at DOF100K through solve_wing_case in f64
     with the line + RBM preconditioner, twice, bitwise equal (TRUE f64
     residual recomputed on the CPU, against phase 3's stencil solution),
     then through the FEM stage with engine="gather" and the default f32
     config (down the solve ladder, with GLBs); (d) the entry points at
     MEDIUM: the three spec cases through tpufem_torch.pipeline.verify, a
     user MSH2 mesh through the mesh and FEM stages, and the hard case down
     the gather ladder;
  7. the dynamics path: (a) kernels F (element_stress) and G (geom_apply)
     against their plain versions at DOF100K, wing 0 tiled over q = 12
     lanes, and at the shapes (d) and (e) launch them with (the CLIs' grid
     32x40x4 and wing at q = 16 and q = 12), f64 and f32, bitwise
     repeatable, exactly 1 launch and 1 device activity per call, with event
     times, device time (repeated and with the L2 flushed) and bound, and
     at 32x40x4 q = 12 again on a non-symmetric sigma (G computes tpufem's
     g_a^T sigma g_b); the
     kernels' line takes F's and G's numbers at the shape of most of their
     launches in (b)-(e); then, launch counters zeroed: (b) WingModal at
     DOF100K, wing 0, 6 modes (converged, first eigen-residual <= 1e-6,
     ascending positive frequencies, first mode spanwise bending); (c) the
     modal_analysis CLI at its defaults (32x40x4, 19,803 DOF), the six
     frequencies within 1e-6 of results/modal_demo/modal_report.json, mode
     GLBs parsed; (d) the buckling_analysis CLI at its defaults (4 modes, tol
     1e-5), the factors within 1e-4 of
     results/buckling_demo/buckling_report.json; (e) the prestress_sweep CLI
     at p = 0 (the spectrum of (c) within 1e-6) and p = 0.5 lambda_cr (a lower
     first frequency);
  8. the design path: (a) kernels H (stvk_internal_force), I
     (stvk_tangent_apply) and J (stvk_energy) against their plain versions
     at DOF100K wing 0 (u: phase 3's solution, then a seeded random field,
     each scaled to max |grad u| = 1e-2), at the nonlinear CLI's 16x24x4
     wing (its linear solution; a sharp-TE grid with a random field) and at
     the edges of H's and I's tiles (13x37x2 and 64x80x6, sharp TE, random
     fields; each record names the tile its launch took), and
     kernel K (strain_apply_geo_vjp) at the optimize CLI's 32x40x4 and
     24x32x2 at its four starting designs and at DOF100K wings 0-3: f64,
     bitwise repeatable, exactly 1 launch and 1 device activity per call,
     event times, device time (repeated and with the L2 flushed) and bound;
     then, launch counters zeroed: (b) the nonlinear_solve CLI at its
     defaults (with GLBs) against results/nonlinear_demo/nonlinear_report.json
     (tip deflections 1e-5, stiffening 0.01 points, Cauchy von Mises 1e-4);
     (c) WingNonlinear at DOF100K wing 0, 5 kPa, one load step, to a
     Newton tolerance of 1e-7 (f64's floor there is ~3e-8); (d)
     DifferentiableWingFEM at 32x40x4 on the optimizer's four starting
     designs: the compliance gradient against central differences on the
     card (chord and thickness of lanes 0 and 3, 1e-5), both CGs' TRUE f64
     residuals; (e) the optimize_wing CLI at its record's grid (24x32x2), 5
     steps, rows 0-4 against tpufem's own CPU run
     (tpufem_torch/reference/optimize_wing_24x32x2_steps5.json; the record's
     history keeps every fifth step only) and row 0 against the record, at
     the record's rounding;
  9. the tet10 path: (a) kernels L (strain_apply10, the doubled-grid tet10
     operator) and M (prolong_p / restrict_p, the P1 <-> P2 transfers)
     against their plain versions at the flagship's DOF1M_TET10 B = 1, the
     tet10 modal CLI's 32x40x4 q = 12 and a sharp-TE 16x24x4 B = 2, f64 and
     f32, bitwise repeatable, exactly 1 launch and 1 device activity per
     call, event / device (repeated and with the L2 flushed) / plain times,
     the bound (bytes or operations) and M's library time (torch.sparse.mm
     of the transfer matrix, by event and by device time); (b) kernel B at every level of the flagship's
     tet4 V-cycle (96x128x8, its first launches at n_thick = 8); then,
     launch counters zeroed: (c) the flagship CLI, `solve_tet10_1m --refine
     8` (2,511,147 DOF): converged, TRUE f64 rel <= 1e-5 on the device and
     recomputed on the CPU by strain_apply10_plain, the 80-bit xprec rel <=
     1e-5, max von Mises within 1e-3 of results/flagship_tet10_2p5mdof.json's
     54.924 MPa, tip u_z < 0, root vM > 3x tip vM; iterations, timing and
     peak device memory as information; (d) modal_analysis --element tet10 at
     its defaults (32x40x4): converged, first mode spanwise bending,
     frequencies beside phase 7's tet4 ones; (e) WingModal10 at 8x10x2 equal
     to scipy shift-invert of assemble_K10 with lumped_mass10 to 1e-7;
     (f) kernel E on the flagship solver's own plans and operands, with
     phase 6's checks (the CPU plain version's bits, f64 and f32): the T6
     midside loads (C = 3) and the connectivity's nodal stress numerator
     (C = 6) and denominator (C = 1); then the tet10 gather engine: (g)
     kernel N (tet10_force, the gather operator: mask, element forces at 4
     Gauss points, per-node sum, Dirichlet identity; each tet evaluated once,
     a launch over the tiles of its plan and one over its halo nodes)
     against its plain version at the flagship, 32x40x4 and a sharp-TE
     16x24x4, f64 and f32, masked and unmasked (f64 1e-12 of the largest
     entry, f32 no worse than 2x the plain f32 error against f64, bitwise
     repeatable, one count and exactly 2 launches and 2 device activities a
     call), with event / device (repeated and flushed, both launches and
     each alone) / plain times, the bound, torch.sparse.mm of the masked
     matrix (assembled on the card, checked against N's function), the
     plan's overlap, blocks, rows, shared memory and halo share, and ptxas's
     registers; then, launch counters zeroed: (h) `solve_tet10_1m --engine
     gather --refine 8`: converged, TRUE f64 rel <= 1e-5 on the device and
     on the CPU, xprec <= 1e-5, max vM within 1e-3 of the record's and of
     (c)'s, tip u_z < 0, root vM > 3x tip vM (iterations, launches per CG
     iteration, the largest u difference from (c), timing and peak memory as
     information); (i) solve_tet10_case (line + RBM two-level) and
     Tet10MGSolver, f64, tol 1e-9, at tpufem's test grid 16x16x4: u within
     1e-7 and the p-MG in fewer iterations; kernel N launched;
 10. the second batched engine on phase 3's batch: (a) kernel O
     (stiffness_apply_t, the trailing-batch tet4 operator of WingBatchT and
     WingMGT: mask, element forces of B lanes, per-node sums, Dirichlet
     identity in one launch) against its plain version at every level of
     DOF100K's V-cycle but the coarsest (B = 8) and at COARSE (B = 3), f64
     within 1e-12 and f32 within 1e-5 of the largest entry, masked and
     unmasked, bitwise repeatable, exactly 1 launch and 1 device activity
     per apply, event / plain / device times (repeated and flushed) against
     the byte bound, each shape's plan (its tiles, blocks and lane groups,
     how often a tet is evaluated, ghost share, halo share counted from the
     plan (0: the kernel launches no cluster and no row leaves its block),
     shared memory) and kernel O's ptxas registers and spills; then, launch
     counters zeroed: (b) WingBatchT(DOF100K,
     float64, mg_levels=None) and the stencil engine (outer_f64) at tol
     1e-7: converged, TRUE f64 rel <= 2e-7 recomputed on the CPU, u within
     1e-5; (c) at MEDIUM the two-level and the multigrid WingBatchT, f64, tol
     1e-6: converged, the two-level in more iterations, u within 1e-4; (d)
     WingBatchT(DOF100K, float32, mg_levels=None), tol 1e-6: converged, tip
     u_z < 0, u within 1e-2 of (b)'s (TRUE f64 residuals printed); (e)
     WingStencilT.solve(refine_steps=4, inner_tol=1e-3): TRUE f64 rel <= 1e-6
     on the CPU in every lane, u within 1e-4 of phase 3's; the f32-only CG
     (iterations, recurred and TRUE residuals printed); (f) the
     verify_stencil_solver CLI exits 0, and generate_fem_dataset --batched
     --engine twolevel --limit 4 --no_glb --force on a copy of phase 5's
     data root: every report success with engine "twolevel", the surface
     displacement within 1e-4 of the stencil engine's (the vm gap, the
     retry queue and the launches of each step printed); kernel O launched;
 11. the library yardsticks (tpufem_torch/profile_library.py): for kernels
     B, D, F, G, I, K and O, each linear at fixed state, torch.sparse.mm of
     the kernel's matrix assembled on the card (probed through the plain
     version, or summed from D's element matrices; O's B lanes as one
     block-diagonal matrix), held to the plain version to 1e-12 (f64), timed
     beside the kernel at the shape that heads the kernel's entry: its
     `library_ms` and `library`; for B, D, F, G and O the matrix cast to f32
     too, held to the f32 plain version to 1e-5 and timed beside the f32
     kernel (`library["f32"]`); H and J, nonlinear in u, say so in
     `library_note`;
 12. the multi-device path (tpufem_torch.parallel, every rank a process of
     torch.distributed spawned by run_ranks; the card's one H100 takes NCCL
     at world 1 and gloo with 2 and 4 ranks sharing it), all f64, each
     step's kernel launches counted from 0 on every rank: (a)
     WingStencilT(DOF100K, dtype=float64) on wing 0 of phase 3's batch, tol
     1e-8 (TRUE rel on the CPU <= 1e-6); (b) the sharded tet4 solve of the
     same wing at NCCL 1, gloo 2 and gloo 4: the exchange layer's values,
     u within 1e-8 of (a), iterations within 2, TRUE rel within 10 % of
     (a)'s, the same u on every rank, make_plan's levels and cells, ms per
     CG iteration and the exchange share; (c) tet10 at 32x40x4, gloo 2,
     against Tet10StencilT(float64): u within 1e-8, iterations within 2; (e)
     3 data-parallel steps of the full-width GraphSAGE on 4 of phase 5's
     graphs at NCCL 1 and gloo 2, the first against the single-process step
     (loss 1e-6, params 1e-5), the loss falling; (d) the sharded_flagship CLI at
     DOF1M_TET10, gloo 2 (converged, TRUE rel on the CPU <= 1e-5, its
     iterations beside tpufem's 188, its u against phase 9's); (f) the
     dryrun_multichip stages at gloo 2; then kernels B, L, M on rank slabs
     and D, N, E on a halo-extended mesh against their plain versions in
     f64 (times and bound): their kernels-line entries gain these shapes and
     `phase12_launches`;
 13. the last of tpufem, its launch counters zeroed first: (a)
     WingStencilT.solve's A/B variants of the main path on phase 3's batch,
     warm_f32, dd_main and both (bench.py --warm_f32 / --dd_main):
     converged, TRUE f64 rel <= 1e-6 recomputed on the CPU in every lane, u
     within 1e-7 of phase 3's; iterations (beside phase 3's and tpufem's
     TPU claim of 331 for warm_f32), wall time and kernel B's launches
     printed; (b) the warm_f32 solve inside utils.profiling.trace: exactly
     one trace file, naming kernel B's CUDA function as many times as B's
     counter moved; (c) ops.segment: segment_sum_sorted launches kernel A
     in f32 at C = 128 over phase 4's graph (within 1e-5 of the plain f64
     sum) and kernel E in f64 at C = 6 over the RBM group ids of phase 6's
     wing (the CPU's bits); incidence_gather_sum on the card within 1e-12 of
     the CPU's at DOF100K; (d) the native MSH2 parser (tpufem_torch/native,
     g++) built on this host, parse_msh2 of the DOF100K wing through it
     equal to the numpy parser's mesh, both parse times printed; B, A, E
     (and the row pointers) gain `phase13_launches` in the kernels' line;
 14. WingBatchT.solve(fast_layout=True), tpufem's EXPERIMENTAL layout,
     which the port runs as the two-level CG with every lane dot summed in
     f64, on kernel O; with O's and E's counters zeroed: (b) at MEDIUM the
     f32 two-level setup must refuse phase 3's batch in both layouts alike
     (lane 3's coarse operator is not positive definite in f32), and the
     f64 pair gives the same iterations and bits (the flag changes nothing
     in f64), both converged, u within 1e-2 of 10c's f64 u; (c) the f32
     pair at DOF100K on phase 3's batch, timed in turns (default, fast,
     fast, default), each layout's runs bitwise equal: finite u, tip u_z <
     0 in every lane, the fast layout converged wherever the default one
     is, u within 1e-2 of 10b's f64 u on the converged lanes (iterations,
     ms an iteration, recurred and TRUE f64 residuals printed); O's and E's
     launches go into the line as `phase14_launches`; (d) fast_layout=True
     under mg_levels=None gives 10b's answer;
 15. prints the wall time of every phase, the peak device memory of the
     phase-3 solve, the training phase, the gather solve, the dynamics, the
     design, the tet10 phase and its gather part, the second batched engine,
     the kernels' JSON line, then {"ok": true, "device": {...}}.

Every phase raises on failure; the script then exits nonzero and prints no
result. Usage: python3 chip_smoke.py   (one card, no arguments)

Its phases took 309-359 s (phase 6: 30-40 s with kernel E at every plan,
phase 7: 35-47 s, phase 8: 80-98 s, phase 9: 91-100 s with the gather
engine, phase 10: 16 s) on an NVIDIA H100 80GB HBM3 at 700 W; with phase 12
(the multi-device path, 217.6 s) 590 s, 603 s of command time.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TOL = 1e-6
PRESSURE = 5e3
BATCH = 8
TPU_RECORD_ITERS = 218  # tpufem's iters on the same batch (BENCH_r05); information only
N_WINGS = 16  # phase 5's dataset: a 11 / 2 / 3 split, 3 steps per epoch at batch 4
EPOCHS = 3


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, runs=7):
    """Median of `runs` timed calls (CUDA events, after a warm-up call)."""
    from tpufem_torch.utils.profiling import median_event_ms

    return median_event_ms(fn, runs)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, dtype):
    """The least time the card could take for a kernel's work: its bytes
    (each input read once, each output written once) over the memory rate, or
    its arithmetic over the rate for `dtype` outside the tensor cores,
    whichever is larger (NVIDIA H100 SXM data sheet)."""
    from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS

    tb, to = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(tb, to) * 1e3, "bound_by": "bytes" if tb >= to else "operations"}


def require_glb(path):
    """The file exists and parses as a binary glTF with at least one mesh."""
    from tpufem_torch.viz.glb import read_glb

    require(path.exists(), f"{path} was not written")
    require(len(read_glb(path)["json"]["meshes"]) >= 1, f"{path}: no mesh")


def sample_params(rng, n, prd):
    names = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
    return np.stack([rng.uniform(*prd[k], n) for k in names], axis=1).astype(np.float32)


def check_strain_apply(dev, res, p4):
    """Kernel B against strain_apply_plain in f64 and f32 at every V-cycle
    level of `res` that applies it (B=8) and of MEDIUM, sharp TE (B=1, as the
    FEM stage solves it); then, at `res`, its single-call times and, from a
    short torch.profiler window, its device time per launch against the byte
    bound and the device activities per apply (exactly 1: the weld spread and
    reduce, the mask and the Dirichlet identity are inside the kernel)."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
    from tpufem_torch.mesher import MEDIUM
    from tpufem_torch.profile_operator import operator_inputs, profile_apply

    lam, mu = lame_params(Material())
    levels = {}
    for grid, batch in ((res, p4), (MEDIUM, p4[:1])):
        for r in hierarchy_resolutions(grid)[:-1]:  # the coarsest is a dense inverse
            levels[f"{r.key} B={batch.shape[0]}"] = check_strain_apply_level(
                dev, r, batch, lam, mu)
    for key, v in levels.items():
        print(f"[kernel B] {key}: f64 max|err| {v['f64']['max_abs_err']:.3e} (scale "
              f"{v['f64']['scale']:.3e}, bar 1e-12 rel); f32 err vs f64 "
              f"{v['f32']['max_abs_err']:.3e} (plain f32 {v['f32']['plain_max_abs_err']:.3e}, "
              f"bar 2x); bitwise repeatable in both")

    lvl0 = levels[f"{res.key} B={p4.shape[0]}"]
    t = {}
    for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        geo, u, free = operator_inputs(res, p4, dt, dev)
        prof = profile_apply(res, geo, u, free, lam, mu)
        require(prof["activities_per_apply"] == 1 and prof["launches"] == 1,
                f"kernel B {name}: {prof['activities_per_apply']} device activities and "
                f"{prof['launches']} kernel launches per apply, not 1")
        t[name] = {"max_abs_err": lvl0[name]["max_abs_err"],
                   "ms": median_ms(lambda: st.strain_apply(res, geo, u, free, lam, mu)),
                   "plain_ms": median_ms(lambda: st.strain_apply_plain(res, geo, u, free, lam, mu)),
                   **{k: prof[k] for k in ("device_us", "device_us_cold", "bound_us", "bound_by",
                                           "share", "activities_per_apply")}}
        p = t[name]
        print(f"[kernel B] {res.key} B={p4.shape[0]} {name}: {p['device_us']:.2f} us of device "
              f"time per launch (torch.profiler; {p['device_us_cold']:.2f} with the L2 flushed), "
              f"bound {p['bound_us']:.2f} us ({p['bound_by']}): "
              f"{p['share']:.1%} of the bound; {p['activities_per_apply']:.0f} device activity per "
              f"apply; single call {p['ms']:.4f} ms vs plain {p['plain_ms']:.4f} ms (median of 7)")
    return {"levels": levels, **t}


def check_strain_apply_level(dev, r, p4, lam, mu):
    """Kernel B at grid r on the batch p4: f64 within 1e-12 of the largest
    plain f64 force; f32 error against that f64 result no worse than 2x the
    plain f32 version's; the same bits twice in both."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.profile_operator import operator_inputs

    geo, u, free = operator_inputs(r, p4, torch.float64, dev, seed=2)
    ref = st.strain_apply_plain(r, geo, u, free, lam, mu)
    scale = ref.abs().max().item()
    out = {}
    for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        geo_d, u_d, free_d = tuple(t.to(dt) for t in geo), u.to(dt), free.to(dt)
        y = st.strain_apply(r, geo_d, u_d, free_d, lam, mu)
        torch.cuda.synchronize()
        require(torch.equal(y, st.strain_apply(r, geo_d, u_d, free_d, lam, mu)),
                f"kernel B {name} at {r.key}: two applies differ")
        err = (y.double() - ref).abs().max().item()
        if dt == torch.float64:
            require(err <= 1e-12 * scale, f"kernel B f64 at {r.key}: {err:.3e} vs scale {scale:.3e}")
            out[name] = {"max_abs_err": err, "scale": scale}
        else:
            e_p = (st.strain_apply_plain(r, geo_d, u_d, free_d, lam, mu).double()
                   - ref).abs().max().item()
            require(err <= 2.0 * e_p,
                    f"kernel B f32 at {r.key}: error {err:.3e} > 2x plain f32 error {e_p:.3e}")
            out[name] = {"max_abs_err": err, "plain_max_abs_err": e_p}
    return out


SEGMENT_SUM_CU = "tpufem_torch/csrc/segment_sum.cu"
ONE_GRAPH, TRAIN_BATCH = "one graph", "merged batch of 4"
# name in the kernels' line -> (its entry in profile_aggregation.measure_entries, the shape
# whose numbers head its line, the TPU code it replaces)
SEGMENT_ENTRIES = {
    "segment_rowptr": ("rowptr", ONE_GRAPH, "tpufem/ops/gather_scatter.py:59"),
    "sorted_segment_sum": ("a C=128", ONE_GRAPH, "tpufem/ops/gather_scatter.py:49"),
    "gather_row_sum": ("b forward", ONE_GRAPH, "tpufem/ops/gather_scatter.py:190"),
    "segment_gather": ("c", TRAIN_BATCH, "tpufem/ops/gather_scatter.py:173"),
}


def check_segment_sum(label, edge_index, edge_mask, num_nodes):
    """Every entry of csrc/segment_sum.cu on one graph (tensors on the card):
    the row pointers and kernel C bitwise against their plain versions,
    kernel A's entries (a) and (b) within 1e-5 of the plain f64 sums, all
    bitwise repeatable (measure_entries raises otherwise); then each one's
    event time, device time, plain and library times and bound."""
    from tpufem_torch.profile_aggregation import WIDTH, entry_line, measure_entries

    out = measure_entries(edge_index, edge_mask, num_nodes)
    for name, v in out.items():
        # one add per summed element, a multiply more where the row is weighted
        flops = {"a": v["E"] * (1 if name.endswith("C=1") else WIDTH),
                 "b": 2 * v["kept_edges"] * WIDTH}.get(name[0], 0)
        v.update(bound(v["bytes"], flops, torch.float32))
        print(entry_line(label, name, v))
    return out


def segment_kernel_entries(seg):
    """The kernels' line entries of csrc/segment_sum.cu from what phases 4
    and 5 left in `seg`: "shapes" maps a shape's label to check_segment_sum's
    result there, "launches" holds phase 4's counts (the line's `launches`),
    "training" / "inference" / "gradient_check" phase 5's."""
    # "share" is the bound over the flushed device time (device_us_cold)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_us",
            "device_us_cold", "share", "share_repeated")
    return [{"name": name, "route": "cuda", "source": SEGMENT_SUM_CU, "replaces": replaces,
             "launches": seg["launches"][name],
             **{k: seg["shapes"][headline][entry][k] for k in keys}, "headline_shape": headline,
             **{f"{path}_launches": seg[path][name]
                for path in ("training", "inference", "gradient_check")},
             "training_step_parts_s": seg["step_parts_s"],
             "shapes": {f"{lbl} {e}": v for lbl, res in seg["shapes"].items()
                        for e, v in res.items() if e.split()[0] == entry.split()[0]}}
            for name, (entry, headline, replaces) in SEGMENT_ENTRIES.items()]


def segment_counters():
    """The launch counters of csrc/segment_sum.cu's wrappers, by the names
    of the kernels' line."""
    from tpufem_torch.ops import gather_scatter as gs

    return {"segment_rowptr": gs.segment_rowptr, "sorted_segment_sum": gs.sorted_segment_sum,
            "gather_row_sum": gs.gather_row_sum, "segment_gather": gs.segment_gather}


def zero_segment_counters():
    for fn in segment_counters().values():
        fn.launches = 0


def read_segment_counters():
    return {name: fn.launches for name, fn in segment_counters().items()}


def true_residual_cpu(res, p4, u_nodes, upper, free, lam, mu):
    """TRUE f64 relative residual per case, recomputed on the CPU with the
    plain strain_apply and numpy pressure loads (independent of the card)."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.mesher import wing_topology

    topo = wing_topology(res)
    X = st.nodes_grid(res, torch.as_tensor(p4, dtype=torch.float64), torch.float64)
    nodes = st.from_grid(res, X).numpy()  # (N,3,B)
    b = np.zeros_like(nodes)
    for k in range(nodes.shape[2]):
        v = nodes[:, :, k][upper]
        f_vert = (-PRESSURE / 3.0) * 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        for c in range(3):
            np.add.at(b[:, :, k], upper[:, c], f_vert)
    b *= free[:, :, None]
    require(b.shape[0] == topo.num_nodes, "load vector size")
    bg = st.to_grid(res, torch.as_tensor(b))
    fmask = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=torch.float64)
    fmask[..., 0] = 0.0
    geo = st.cell_geometry(res, X)
    r = bg - st.strain_apply_plain(res, geo, st.to_grid(res, u_nodes), fmask, lam, mu)
    rn = torch.sqrt((r * r).sum(dim=(0, 2, 3, 4)))
    bn = torch.sqrt((bg * bg).sum(dim=(0, 2, 3, 4)))
    return (rn / bn).numpy()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from tpufem_torch.mesher import DOF100K

    dev = torch.device("cuda")
    kernels, state = run(dev, DOF100K, BATCH)
    walls = state["walls"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_training_path(dev, state["segment"])
    walls["5 training path"] = time.perf_counter() - t0
    state["peak_bytes"]["training phase"] = torch.cuda.max_memory_allocated()
    kernels = segment_kernel_entries(state["segment"]) + kernels
    t0 = time.perf_counter()
    kernels += run_gather_path(dev, DOF100K, state)
    walls["6 gather path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels += run_dynamics(dev, DOF100K, state)
    walls["7 dynamics path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels += run_design(dev, DOF100K, state)
    walls["8 design path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels += run_tet10(dev, state)
    walls["9 tet10 path"] = time.perf_counter() - t0
    e = next(k for k in kernels if k["name"] == "csr_segment_sum")
    e["tet10_launches"] = state["tet10_csr"]["launches"]
    e["shapes"].update(state["tet10_csr"]["shapes"])
    t0 = time.perf_counter()
    kernels.append(run_batched_engine(dev, state, smi))
    walls["10 second batched engine"] = time.perf_counter() - t0
    print(f"[batched] phase 10 wall {walls['10 second batched engine']:.3f} s", flush=True)
    t0 = time.perf_counter()
    run_library_yardsticks(dev, kernels)
    walls["11 library yardsticks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p12_launches, p12_shapes = run_multi_device(dev, state, smi)
    walls["12 multi-device path"] = time.perf_counter() - t0
    print(f"[multi] phase 12 wall {walls['12 multi-device path']:.3f} s", flush=True)
    for k in kernels:
        if k["name"] in P12_KERNELS:
            k["phase12_launches"] = p12_launches.get(k["name"], 0)
            k.setdefault("shapes", {}).update(p12_shapes.get(k["name"], {}))
    t0 = time.perf_counter()
    p13_launches = run_last_pieces(dev, state, smi)
    walls["13 last pieces"] = time.perf_counter() - t0
    print(f"[last] phase 13 wall {walls['13 last pieces']:.3f} s", flush=True)
    for k in kernels:
        if k["name"] in p13_launches:
            k["phase13_launches"] = p13_launches[k["name"]]
    t0 = time.perf_counter()
    p14_launches = run_fast_layout(dev, state, smi)
    walls["14 fast layout"] = time.perf_counter() - t0
    for k in kernels:
        if k["name"] in p14_launches:
            k["phase14_launches"] = p14_launches[k["name"]]
    print(f"[fast] phase 14 wall {walls['14 fast layout']:.3f} s", flush=True)
    print(json.dumps({"phase_wall_s": walls}))
    print(json.dumps({"peak_device_memory_bytes": state["peak_bytes"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# kernel letter in profile_library.CASES -> its name in the kernels' line
LIBRARY_KERNELS = {"B": "strain_apply", "D": "stiffness_apply", "F": "element_stress",
                   "G": "geom_apply", "I": "stvk_tangent_apply", "K": "strain_apply_geo_vjp",
                   "O": "stiffness_apply_t"}


def run_library_yardsticks(dev, kernels):
    """Phase 11: each linear kernel's torch.sparse.mm yardstick
    (profile_library.library_record raises unless the assembled matrix gives
    the plain version's result to 1e-12), into the kernels' line."""
    from tpufem_torch.profile_library import CASES, library_record, line

    by_name = {k["name"]: k for k in kernels}
    for letter, name in LIBRARY_KERNELS.items():
        rec = library_record(CASES[letter](dev))
        print(line(letter, rec))
        by_name[name]["library_ms"] = rec["library_ms"]
        by_name[name]["library"] = rec
        torch.cuda.empty_cache()
    for name in ("stvk_internal_force", "stvk_energy"):
        by_name[name]["library_note"] = "none: nonlinear in u, no one PyTorch call computes it"


def run(dev, res, batch):
    """Phases 1-4 at resolution `res` with `batch` wings; returns the kernels'
    report entries."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.driver import FemSolution, surface_results
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.stencil_mg import WingStencilT
    from tpufem_torch.mesh_types import Mesh
    from tpufem_torch.models.graph import build_graph
    from tpufem_torch.models.metrics import compute_metrics
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
    from tpufem_torch.ops import csr_segment_sum as cs
    from tpufem_torch.ops.kernels import build_info, load_kernels
    from tpufem_torch.pipeline.types import PRD_RANGES

    # ---- 1. build
    walls = {}
    t_phase = time.perf_counter()
    load_kernels()
    print(f"[build] kernels built in {build_info['seconds']:.2f} s -> {build_info['path']}")
    for line in build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[build] {line.strip()}")

    # ---- batch: the second seeded draw, as bench.py times it
    rng = np.random.default_rng(42)
    sample_params(rng, batch, PRD_RANGES)  # bench's warm-up draw
    p4 = sample_params(rng, batch, PRD_RANGES)

    walls["1 build"] = time.perf_counter() - t_phase

    # ---- 2. kernel B on the card
    t_phase = time.perf_counter()
    kb = check_strain_apply(dev, res, p4)
    walls["2 kernel B"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---- 3 + 4. the main path, with the launch counters zeroed just before
    lam, mu = lame_params(Material())
    t0 = time.perf_counter()
    solver = WingStencilT(res, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    st.strain_apply.launches = 0
    zero_segment_counters()
    cs.csr_segment_sum.launches = 0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = solver.solve(p4, pressure=PRESSURE, tol=TOL, maxiter=2000, outer_f64=True)
    torch.cuda.synchronize()
    solve_wall = time.perf_counter() - t0
    peak_bytes = {f"{res.key} B={batch} stencil solve": torch.cuda.max_memory_allocated()}

    bt = solver.bt
    nodes = out.nodes.cpu().numpy().astype(np.float64)
    u, s6, vm = out.u.cpu().numpy(), out.stress6.cpu().numpy(), out.vm.cpu().numpy()
    rel, conv = out.rel_residual.cpu().numpy(), out.converged.cpu().numpy()
    faces = bt.surf_faces[bt.sets.surf_all_faces]
    names = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
    # "segment", the default: the fused neighbour mean; "pallas": messages, then segment sums
    model, model_pallas = (
        GraphSAGE(SAGEConfig(aggregate_impl=impl), generator=torch.Generator().manual_seed(0),
                  device=dev).eval() for impl in ("segment", "pallas"))
    graphs, preds = [], []
    t0 = time.perf_counter()
    for k in range(batch):
        params = dict(zip(names, map(float, p4[k])))
        mesh = Mesh(nodes=nodes[:, :, k], tets=bt.tets.cpu().numpy(), surf_faces=bt.surf_faces)
        sol = FemSolution(u=u[:, :, k], stress6=s6[:, :, k], vm=vm[:, k], iters=out.iters,
                          rel_residual=float(rel[k]), converged=bool(conv[k]))
        g = build_graph(surface_results(mesh, bt.sets, sol, params["span_m"]), faces, params)
        with torch.no_grad():
            pred = model(torch.as_tensor(g.x, device=dev), torch.as_tensor(g.edge_index, device=dev),
                         torch.as_tensor(g.edge_mask, device=dev))
        graphs.append(g)
        preds.append(pred.cpu().numpy())
    torch.cuda.synchronize()
    surrogate_s = time.perf_counter() - t0
    fused_launches = read_segment_counters()
    g = graphs[0]
    with torch.no_grad():
        pred_pallas = model_pallas(
            torch.as_tensor(g.x, device=dev), torch.as_tensor(g.edge_index, device=dev),
            torch.as_tensor(g.edge_mask, device=dev)).cpu().numpy()
    launches = {"strain_apply": st.strain_apply.launches, **read_segment_counters(),
                "csr_segment_sum": cs.csr_segment_sum.launches}
    print(f"[main path] kernel launches: {launches} (the fused surrogate forwards alone: "
          f"{fused_launches})")
    require(launches["strain_apply"] > 0, "kernel B was not launched on the main path")
    require(fused_launches["gather_row_sum"] > 0 and fused_launches["segment_rowptr"] > 0,
            "kernel A entry (b) or the row-pointer kernel was not launched by the fused forward")
    require(fused_launches["sorted_segment_sum"] == 0 and fused_launches["segment_gather"] == 0,
            "the fused forward launched the message route's kernels")
    require(launches["sorted_segment_sum"] > 0 and launches["segment_gather"] > 0,
            'kernel A entry (a) or kernel C was not launched by the "pallas" forward')
    require(launches["csr_segment_sum"] > 0, "kernel E was not launched by the stencil solve")

    # ---- 3. solve checks
    tm = solver.last_timing
    print(f"[solve] {res.key} B={batch} dof={3 * solver.num_nodes} tol={TOL}: iters {out.iters} "
          f"(tpufem's record on this batch: {TPU_RECORD_ITERS}; information, not parity)")
    print(f"[solve] converged {conv.tolist()} rel {[f'{r:.3e}' for r in rel]}")
    print(f"[solve] solver init {init_s:.3f} s; setup {tm['setup_s']:.3f} s, solve "
          f"{tm['solve_s']:.3f} s, recover {tm['recover_s']:.3f} s; wall {solve_wall:.3f} s "
          f"= {solve_wall / batch:.4f} s/case")
    require(bool(conv.all()), f"not all lanes converged: {rel}")
    upper = bt.upper.cpu().numpy()
    free = bt.free64.cpu().numpy()
    rel_cpu = true_residual_cpu(res, p4, out.u.cpu(), upper, free, lam, mu)
    print(f"[solve] TRUE f64 rel residual recomputed on the CPU: max {rel_cpu.max():.3e} "
          f"(bar {TOL})")
    require(float(rel_cpu.max()) <= TOL, f"TRUE residual above tol: {rel_cpu}")
    for k in range(batch):
        y = nodes[:, 1, k]
        span = float(p4[k, 0])
        uz_tip = u[y > 0.9 * span, 2, k].mean()
        vm_root = vm[y < 0.25 * span, k].mean()
        vm_tip = vm[y > 0.75 * span, k].mean()
        require(uz_tip < 0, f"case {k}: tip mean u_z {uz_tip:.3e} not downward")
        require(vm_root > 3.0 * vm_tip, f"case {k}: root vM {vm_root:.3e} vs tip {vm_tip:.3e}")
        require(np.isfinite(u[:, :, k]).all() and np.isfinite(vm[:, k]).all(), "nan/inf")
    print(f"[solve] physics: tip u_z < 0 and root-band vM > 3x tip-band vM in all {batch} cases")

    # ---- 4. surrogate checks
    model_cpu = GraphSAGE(SAGEConfig(), generator=torch.Generator().manual_seed(0),
                          device="cpu").eval()
    for k, (g, pred) in enumerate(zip(graphs, preds)):
        require(pred.shape == (g.num_nodes,) and np.isfinite(pred).all(), f"case {k}: bad pred")
        with torch.no_grad():
            plain = model_cpu(torch.as_tensor(g.x), torch.as_tensor(g.edge_index),
                              torch.as_tensor(g.edge_mask)).numpy()
        diff = np.abs(pred - plain).max()
        require(diff <= 1e-4 * max(1.0, np.abs(plain).max()),
                f"case {k}: fused forward vs plain forward {diff:.3e}")
    impl_diff = np.abs(pred_pallas - preds[0]).max()
    require(impl_diff <= 1e-5 * max(1.0, np.abs(preds[0]).max()),
            f'case 0: "pallas" forward vs "segment" forward {impl_diff:.3e}')
    m = compute_metrics(preds[0], graphs[0].stress_vm, graphs[0].loss_mask)["masked_nodes"]
    print(f"[surrogate] GraphSAGE(SAGEConfig()) on {batch} graphs "
          f"({graphs[0].num_nodes} nodes, {graphs[0].num_edges} edges each): "
          f"{surrogate_s:.3f} s incl. graph building; the fused forward equals the "
          f"plain-aggregation forward on the CPU (1e-4) and, on case 0, the \"pallas\" forward "
          f"(max |diff| {impl_diff:.3e}, bar 1e-5)")
    print(f"[surrogate] UNTRAINED random weights, case 0 vs FEM: MAE {m['mae_pa'] / 1e6:.3f} MPa "
          f"rel {m['rel_mae']:.3f} (meaningless until a checkpoint exists)")
    offs = np.cumsum([0] + [g.num_nodes for g in graphs])
    merged = (np.concatenate([g.edge_index + np.int32(o) for g, o in zip(graphs, offs)], axis=1),
              np.concatenate([g.edge_mask for g in graphs]), int(offs[-1]))
    shapes = {label: check_segment_sum(label, torch.as_tensor(ei, device=dev),
                                       torch.as_tensor(em, device=dev), n)
              for label, (ei, em, n) in ((ONE_GRAPH, (graphs[0].edge_index, graphs[0].edge_mask,
                                                      graphs[0].num_nodes)),
                                         (f"{batch}-graph batch", merged))}

    walls["3-4 stencil solve, surrogate"] = time.perf_counter() - t_phase
    state = {"solver": solver, "p4": p4, "out": out, "peak_bytes": peak_bytes, "walls": walls,
             "stencil_csr_launches": launches["csr_segment_sum"], "graph0": graphs[0],
             "segment": {"shapes": shapes, "launches": launches}}
    b64, b32 = kb["f64"], kb["f32"]
    return [
        {"name": "strain_apply", "route": "cuda", "source": "tpufem_torch/csrc/strain_apply.cu",
         "replaces": "tpufem/fem/stencil.py:249", "launches": launches["strain_apply"],
         "max_abs_err": b64["max_abs_err"], "ms": b64["ms"], "plain_ms": b64["plain_ms"],
         "bound_ms": b64["bound_us"] / 1e3, "bound_by": b64["bound_by"], "library_ms": None,
         "bound_us": b64["bound_us"], "device_us": b64["device_us"],
         "activities_per_apply": b64["activities_per_apply"],
         "device_us_cold": b64["device_us_cold"],
         "f32": {k: b32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_us", "device_us",
                                     "device_us_cold", "activities_per_apply")},
         "levels": kb["levels"]},
    ], state


def time_step_parts(dev, model, batch, runs=5):
    """Median seconds of the training step's forward (loss), backward and
    optimizer (clip + AdamW) on `batch`, each bracketed by synchronize."""
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    parts = {"forward_s": [], "backward_s": [], "optimizer_s": []}
    from tpufem_torch.models.train import Trainer, clip_by_global_norm_

    for i in range(runs + 1):
        model.train()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = Trainer._loss_fn(model, batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        clip_by_global_norm_(model.parameters(), 1.0)
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:  # the first run is a warm-up
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(v)
    return {k: float(np.median(v)) for k, v in parts.items()}


def check_gradients(dev, graphs):
    """Every parameter's gradient of one merged batch (dropout off) on the
    card against the same model on the CPU (plain path), to 1e-4 of each
    tensor's max |grad|, under both aggregate_impl values: "segment" runs
    kernel A entry (b) forward and backward, "pallas" kernels C and A entry
    (a) forward and kernels C and A entry (b) backward. Returns the launches
    of both runs together."""
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
    from tpufem_torch.models.train import GraphSet, Trainer

    total = dict.fromkeys(segment_counters(), 0)
    for impl in ("segment", "pallas"):
        cfg = SAGEConfig(dropout=0.0, aggregate_impl=impl)
        grads, losses = {}, {}
        zero_segment_counters()
        for d in (dev, torch.device("cpu")):
            model = GraphSAGE(cfg, generator=torch.Generator().manual_seed(0), device=d).train()
            loss = Trainer._loss_fn(model, GraphSet(graphs, d).batch(range(len(graphs))))
            loss.backward()
            losses[d.type] = float(loss.detach())
            grads[d.type] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        counts = read_segment_counters()
        n_layers = cfg.num_layers
        want = ({"gather_row_sum": 2 * n_layers, "sorted_segment_sum": 0, "segment_gather": 0}
                if impl == "segment" else
                {"gather_row_sum": n_layers, "sorted_segment_sum": 2 * n_layers,
                 "segment_gather": 2 * n_layers})
        require(all(counts[k] == v for k, v in want.items()) and counts["segment_rowptr"] == 2,
                f"aggregate_impl={impl}: launches {counts}, expected {want} and 2 row-pointer "
                f"launches")
        worst = 0.0
        for name, g_cpu in grads["cpu"].items():
            err = (grads["cuda"][name] - g_cpu).abs().max().item()
            scale = g_cpu.abs().max().item()
            require(err <= 1e-4 * scale,
                    f"{impl}: grad {name}: card vs CPU {err:.3e} > 1e-4 x {scale:.3e}")
            worst = max(worst, err / max(scale, 1e-30))
        print(f"[train] gradients of one merged batch ({len(graphs)} graphs, dropout off), "
              f"aggregate_impl={impl}: {len(grads['cpu'])} tensors, card vs CPU plain path: "
              f"worst |err|/max|grad| {worst:.3e} (bar 1e-4); loss {losses['cuda']:.6f} vs "
              f"{losses['cpu']:.6f}; launches {counts}")
        total = {k: total[k] + counts[k] for k in total}
    return total


def run_training_path(dev, seg):
    """Phase 5: dataset CLIs -> train_gnn -> inference_gnn at DOF100K, then
    the gradient and step-time checks and every entry of segment_sum.cu at
    the merged batch's shape. Reuses no state of phases 1-4. Adds to `seg`
    (phase 4's record of those kernels) the merged batch's shape, the
    launches of training, inference and the gradient check, and the step's
    parts."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.models.dataset import WingStressDataset
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
    from tpufem_torch.models.train import GraphSet
    from tpufem_torch.pipeline.config import get_paths
    from tpufem_torch.scripts import (
        generate_fem_dataset,
        generate_geometry_dataset,
        generate_mesh_dataset,
        inference_gnn,
        train_gnn,
    )

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_data_") as root:
        paths = get_paths(root)
        wall = {}

        def cli(name, mod, argv):
            t0 = time.perf_counter()
            rc = mod.main([*argv, "--data_root", root])
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            require(rc == 0, f"{name} CLI exited {rc}")

        cli("geometry", generate_geometry_dataset, ["--count", str(N_WINGS), "--seed", "7"])
        cli("mesh", generate_mesh_dataset,
            ["--n_chord", "64", "--n_span", "80", "--n_thick", "6",
             "--te_floor_frac", "0.006", "--spacing", "le"])
        st.strain_apply.launches = 0
        cli("fem", generate_fem_dataset,
            ["--batched", "--batch_size", "8", "--tol", str(TOL), "--pressure", "5000",
             "--device", "cuda"])
        fem_launches = st.strain_apply.launches
        require(fem_launches > 0, "kernel B was not launched by the FEM CLI")
        reps = [json.loads((paths.fem_case(f"{i:03d}") / "fem_report.json").read_text())
                for i in range(1, N_WINGS + 1)]
        for r in reps:
            sv = r["extra"].get("solver", {})
            require(r["status"] == "success" and sv.get("converged") is True
                    and "batched_lane_failure" not in r["extra"],
                    f"case {r['case_id']}: {r['status']} {r['failure_reason']}")
            require(sv["rel_residual"] <= TOL, f"case {r['case_id']}: rel {sv['rel_residual']}")
        for i in range(1, N_WINGS + 1):
            cid = f"{i:03d}"
            for d, name in ((paths.geometry_case(cid), "wing_viz.glb"),
                            (paths.mesh_case(cid), "surf_sets.glb"),
                            (paths.fem_case(cid), "wing_result.glb"),
                            (paths.fem_case(cid), "wing_result_arrows.glb")):
                require_glb(d / name)
        rels = [r["extra"]["solver"]["rel_residual"] for r in reps]
        iters = sorted({r["extra"]["solver"]["iters"] for r in reps})
        write_s = sum(r["elapsed_ms"] for r in reps) / 1e3
        print(f"[dataset] {N_WINGS} DOF100K wings, {N_WINGS}/{N_WINGS} converged, iters {iters}, "
              f"max TRUE rel {max(rels):.3e} (bar {TOL}); kernel B launches {fem_launches}; "
              f"wing_viz, surf_sets, wing_result and wing_result_arrows GLBs parse")
        print(f"[dataset] s/wing: geometry {wall['geometry'] / N_WINGS:.4f}, mesh "
              f"{wall['mesh'] / N_WINGS:.4f}, FEM solve {(wall['fem'] - write_s) / N_WINGS:.4f}, "
              f"writing {write_s / N_WINGS:.4f} (FEM CLI wall {wall['fem']:.3f} s)")
        # phase 10f solves the first TWOLEVEL_CASES again with --engine twolevel in a copy
        seg["data_copy"] = Path(tempfile.mkdtemp(dir=scratch, prefix="smoke_data_copy_"))
        shutil.copytree(root, seg["data_copy"], dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("*.glb", "models"))

        zero_segment_counters()
        cli("train", train_gnn, ["--epochs", str(EPOCHS), "--batch_size", "4",
                                 "--device", "cuda"])
        seg["training"] = read_segment_counters()
        print(f"[train] kernel launches during training (the fused route): {seg['training']}")
        require(seg["training"]["gather_row_sum"] > 0 and seg["training"]["segment_rowptr"] > 0,
                "kernel A entry (b) or the row-pointer kernel not launched in training")
        log = json.loads((paths.models / "training_log.json").read_text())
        train_losses = [e["train_loss"] for e in log["log"]]
        val_losses = [e["val_loss"] for e in log["log"]]
        require(len(train_losses) == EPOCHS, f"{len(train_losses)} epochs run")
        require(np.isfinite(train_losses + val_losses).all(), "non-finite loss")
        require(train_losses[-1] < train_losses[0], f"train loss did not fall: {train_losses}")
        epoch_s = [e["epoch_time_s"] for e in log["log"]]
        ds = WingStressDataset(paths, seed=42)
        n_split = {k: len(v) for k, v in ds.splits.items()}
        steps = -(-n_split["train"] // 4)
        print(f"[train] split {n_split}; {EPOCHS} epochs x {steps} steps at batch 4, "
              f"SAGEConfig() width; train loss {train_losses}, val {val_losses}")
        print(f"[train] s/epoch {epoch_s} (incl. validation); "
              f"s/step {epoch_s[-1] / steps:.4f} (last epoch / steps); CLI wall "
              f"{wall['train']:.3f} s")

        zero_segment_counters()
        cli("inference", inference_gnn, ["--split", "test", "--device", "cuda"])
        seg["inference"] = read_segment_counters()
        require(seg["inference"]["gather_row_sum"] > 0, "kernel A not launched in inference")
        test_ids = ds.splits["test"]
        require(len(test_ids) == 3, f"test split {test_ids}")
        inf_ms = []
        for cid in test_ids:
            pred = np.load(paths.fem_case(cid) / "pred_results.npz")["pred_pa"]
            require(pred.ndim == 1 and len(pred) > 0 and np.isfinite(pred).all(),
                    f"case {cid}: bad predictions")
            rep = json.loads((paths.fem_case(cid) / "inference_report.json").read_text())
            inf_ms.append(rep["inference_time_ms"])
            require_glb(paths.fem_case(cid) / "wing_pred.glb")
            require_glb(paths.fem_case(cid) / "wing_error.glb")
        summ = json.loads((paths.models / "inference_summary.json").read_text())
        require(summ["num_cases"] == 3, f"inference summary {summ}")
        print(f"[inference] {len(test_ids)} test wings, finite predictions, wing_pred.glb and "
              f"wing_error.glb parse; ms/wing {inf_ms} (incl. graph loading and GLBs); masked MAE "
              f"{summ['mae_mpa_masked_mean']:.3f} MPa after {EPOCHS} epochs")

        graphs = ds.graphs("train")[:4]
        seg["dp_graphs"] = graphs  # phase 12e's data-parallel step
        seg["gradient_check"] = check_gradients(dev, graphs)
        batch = GraphSet(graphs, dev).batch(range(4))
        model = GraphSAGE(SAGEConfig(), generator=torch.Generator().manual_seed(0), device=dev)
        parts = time_step_parts(dev, model, batch)
        print(f"[train] step parts on one merged batch (N={batch.x.shape[0]}, "
              f"E={batch.edge_index.shape[1]}), median of 5: forward {parts['forward_s']:.4f} s, "
              f"backward {parts['backward_s']:.4f} s, optimizer {parts['optimizer_s']:.4f} s")
        seg["shapes"][TRAIN_BATCH] = check_segment_sum(TRAIN_BATCH, batch.edge_index,
                                                       batch.edge_mask, batch.x.shape[0])
        seg["step_parts_s"] = parts


# ---------------------------------------------------------------- phase 6


def timed_pair(fn, plain):
    """(ms, plain_ms): medians of 7, kernel and plain version in turns."""
    return median_ms(fn), median_ms(plain)


def check_stiffness_apply(dev, mesh, root_nodes, lam, mu):
    """Kernel D against stiffness_apply_plain at the DOF100K mesh's shapes:
    f64 within 1e-12 of the largest plain f64 value, f32 no worse than 2x the
    plain f32 version's error, the same bits twice (check_apply raises
    otherwise), masked and unmasked, on the mesh as numbered and with its
    nodes renumbered by a seeded permutation; exactly 1 launch and 1 device
    activity per apply; event times of kernel and plain version, device time
    per launch repeated and with the L2 flushed, and the function's bound
    (its operands read once, y written once, every tet evaluated once; the
    plan's bytes and the repeated evaluations are the design's cost and are
    printed beside it). Returns its report, by "<mesh> <dtype>
    masked|unmasked"."""
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.profile_gather_operator import (
        check_apply,
        operator_inputs,
        permuted,
        profile_apply,
    )

    out = {}
    meshes = {"ordered": (mesh.nodes, mesh.tets, root_nodes),
              "permuted": permuted(mesh.nodes, mesh.tets, root_nodes)}
    for label, (nodes, tets, root) in meshes.items():
        g64, v64, tt, x64, f64, plan = operator_inputs(nodes, tets, root, torch.float64, dev)
        for masked in (True, False) if label == "ordered" else (True,):
            ref = asm.stiffness_apply_plain(g64, v64, tt, x64, lam, mu, plan,
                                            f64 if masked else None)
            for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
                g, v, x = g64.to(dt), v64.to(dt), x64.to(dt)
                free = f64.to(dt) if masked else None
                err, err_plain = check_apply(g, v, tt, x, free, plan, lam, mu, ref)
                r = profile_apply(g, v, tt, x, free, plan, lam, mu)
                require(r["launches"] == 1 and r["activities"] == 1,
                        f"kernel D {label} {name}: {r['launches']} launches and "
                        f"{r['activities']} device activities per apply, not 1")
                ms, plain_ms = timed_pair(
                    lambda: asm.stiffness_apply(g, v, tt, x, lam, mu, plan, free),
                    lambda: asm.stiffness_apply_plain(g, v, tt, x, lam, mu, plan, free))
                key = f"{label} {name} {'masked' if masked else 'unmasked'}"
                out[key] = {"max_abs_err": err, "plain_max_abs_err": err_plain,
                            "scale": ref.abs().max().item(), "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": r["bound_us"] / 1e3, "overlap": plan.overlap,
                            "blocks": plan.bnode.numel() - 1, "T": int(tt.shape[0]),
                            "N": int(x.shape[0]),
                            **{k: r[k] for k in ("bound_by", "bound_us", "device_us",
                                                 "device_us_cold", "share", "share_repeated",
                                                 "launches", "activities", "plan_bytes")}}
                p = out[key]
                print(f"[kernel D] stiffness_apply {key} T={p['T']} N={p['N']} ({p['blocks']} "
                      f"blocks, each tet evaluated {p['overlap']:.3f} times): max|err| {err:.3e} "
                      f"(plain {err_plain:.3e} in this dtype; scale {p['scale']:.3e}; bars 1e-12 "
                      f"rel in f64, 2x plain in f32), bitwise repeatable; {p['launches']:.0f} "
                      f"launch, {p['activities']:.0f} device activity per apply; single call "
                      f"{ms:.4f} ms vs plain {plain_ms:.4f} ms (median of 7); device time per "
                      f"launch (torch.profiler) {p['device_us']:.2f} us repeated, "
                      f"{p['device_us_cold']:.2f} us with the L2 flushed; bound "
                      f"{p['bound_us']:.2f} us ({p['bound_by']}, the operands alone): "
                      f"{p['share']:.1%} flushed, {p['share_repeated']:.1%} repeated; the plan "
                      f"adds {p['plan_bytes'] / 1e6:.2f} MB per launch; no one-call PyTorch "
                      f"equivalent")
    return out


def check_csr_sum(label, vals64, plan):
    """Kernel E at one plan and width: the card's output equal bit for bit to
    csr_segment_sum_plain on CPU copies, f64 and f32, and the same bits on a
    second call; event times of kernel, plain version and the library on
    equal work (torch.zeros, then index_add_), device times per launch
    (repeated and with the L2 flushed; the library's by every activity), the
    byte bound, each in f64 and f32."""
    from tpufem_torch.ops import csr_segment_sum as cs
    from tpufem_torch.utils.profiling import device_time

    plan_cpu = cs.plan_on(plan, "cpu")
    ids = torch.empty_like(plan.seg)  # each row's segment id, in row order
    ids[plan.order.long()] = plan.seg
    R, C = vals64.shape
    rec = {"R": R, "C": C, "N": plan.num_segments}
    for d, vals in (("f64", vals64), ("f32", vals64.float())):
        out = cs.csr_segment_sum(vals, plan)
        ref = cs.csr_segment_sum_plain(vals.cpu(), plan_cpu)
        require(torch.equal(out.cpu(), ref), f"kernel E {label} {d}: not the CPU plain version's "
                f"bits (largest difference {(out.cpu() - ref).abs().max().item():.3e})")
        require(torch.equal(out, cs.csr_segment_sum(vals, plan)),
                f"kernel E {label} {d}: two calls differ")
        filled = lambda v=vals, o=out: torch.zeros_like(o).index_add_(0, ids, v)  # noqa: E731
        tol = (1e-4 if d == "f32" else 1e-12) * max(out.abs().max().item(), 1e-300)
        require((filled() - out).abs().max().item() <= tol,
                f"index_add_ {label} {d} does not compute kernel E's sum")
        ms, plain_ms = timed_pair(lambda v=vals: cs.csr_segment_sum(v, plan),
                                  lambda v=vals: cs.csr_segment_sum_plain(v, plan))
        r = device_time(lambda v=vals: cs.csr_segment_sum(v, plan), "csr_segment_sum_kernel",
                        cold=True)
        lib = device_time(filled, "index", cold=True)  # counted by the adds' kernel
        bd = bound(nbytes(vals, plan.order, plan.starts, out), vals.numel(), vals.dtype)
        rec[d] = {"max_abs_err": (out.cpu() - ref).abs().max().item(), "equals_cpu_plain": True,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": median_ms(filled), **bd,
                  "device_us": r["device_us"], "device_us_cold": r["device_us_cold"],
                  "library_device_us": lib["all_device_us"],
                  "library_device_us_cold": lib["all_device_us_cold"],
                  "share": bd["bound_ms"] * 1e3 / r["device_us_cold"]}
    a, b = rec["f64"], rec["f32"]
    print(f"[kernel E] csr_segment_sum {label}: R={R} C={C} N={plan.num_segments}: the CPU plain "
          f"version's bits in f64 and f32, bitwise repeatable; f64 {a['ms']:.4f} ms vs plain "
          f"{a['plain_ms']:.4f} ms, zeros + index_add_ {a['library_ms']:.4f} ms; device per launch "
          f"f64 {a['device_us']:.2f} us repeated, {a['device_us_cold']:.2f} us L2 flushed (zeros + "
          f"index_add_, every activity: {a['library_device_us']:.2f} / "
          f"{a['library_device_us_cold']:.2f} us), bound {a['bound_ms'] * 1e3:.2f} us: "
          f"{a['share']:.1%} flushed; f32 {b['device_us']:.2f} / {b['device_us_cold']:.2f} us "
          f"(library {b['library_device_us']:.2f} / {b['library_device_us_cold']:.2f} us), bound "
          f"{b['bound_ms'] * 1e3:.2f} us: {b['share']:.1%}", flush=True)
    return rec


def gather_true_residual_cpu(mesh, bs, u, lam, mu):
    """TRUE f64 relative residual of a gather-path solution, recomputed on
    the CPU: the port's plain operator (kernels D and E's plain versions)
    and numpy pressure loads."""
    from tpufem_torch.fem.assembly import build_incidence, stiffness_operator
    from tpufem_torch.fem.bc import dirichlet_mask
    from tpufem_torch.fem.elements import tet4_setup

    faces = mesh.surf_faces[bs.surf_upper_faces]
    v = mesh.nodes[faces]
    f_vert = (-PRESSURE / 3.0) * 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    b = np.zeros_like(mesh.nodes)
    for c in range(3):
        np.add.at(b, faces[:, c], f_vert)
    free = dirichlet_mask(mesh.num_nodes, bs.nroot_nodes, dtype=torch.float64)
    b = torch.as_tensor(b.reshape(-1)) * free
    tets = torch.as_tensor(mesh.tets)
    grads, vols = tet4_setup(torch.as_tensor(mesh.nodes), tets)
    A = stiffness_operator(grads, vols, tets, lam, mu, build_incidence(mesh.tets, mesh.num_nodes),
                           free)
    r = b - A(torch.as_tensor(np.asarray(u, np.float64).reshape(-1)))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def write_msh2(path, mesh):
    """A mesh as a Gmsh MSH v2 ASCII file (nodes at 9 significant digits)."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.num_nodes)]
    lines += [f"{i} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}" for i, p in enumerate(mesh.nodes, 1)]
    lines += ["$EndNodes", "$Elements", str(mesh.num_tets)]
    lines += [f"{i} 4 2 0 1 {t[0]} {t[1]} {t[2]} {t[3]}" for i, t in enumerate(mesh.tets + 1, 1)]
    lines += ["$EndElements", ""]
    path.write_text("\n".join(lines))


def attempts_line(rep):
    """The solve attempts a gather-path FEM-stage report records: its ladder,
    or the primary rung alone when that succeeded."""
    ladder = rep.extra.get("solve_ladder")
    if ladder is None:
        sv = rep.extra.get("solver", {})
        return (f"primary (the only attempt) iters {sv.get('iters')} "
                f"{'ok' if sv.get('converged') else 'failed'}")
    return ", ".join(f"{a['attempt']} {a['dtype']} iters {a['iters']} "
                     f"{'ok' if a['ok'] else 'failed'}" for a in ladder)


def run_gather_path(dev, res, state):
    """Phase 6: kernels D and E at DOF100K, the stencil solve's repeatability,
    the DOF100K gather solve (twice) and FEM stage, and the MEDIUM entry
    points. Returns kernels D's and E's report entries."""
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.fem.driver import WingSolveConfig, mesh_plans, solve_wing_case
    from tpufem_torch.fem.elements import tet4_setup
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.stencil_mg import WingStencilT
    from tpufem_torch.mesher import MEDIUM, structured_wing_mesh
    from tpufem_torch.ops import csr_segment_sum as cs
    from tpufem_torch.pipeline.config import get_paths
    from tpufem_torch.pipeline.fem_stage import run_fem_case
    from tpufem_torch.pipeline.geometry_stage import run_geometry_case
    from tpufem_torch.pipeline.mesh_stage import run_mesh_case
    from tpufem_torch.pipeline.types import WingParams
    from tpufem_torch.pipeline.verify import SPEC_CASES, verify_pipeline
    from tpufem_torch.sets import build_boundary_sets

    lam, mu = lame_params(Material())
    p4, solver, out = state["p4"], state["solver"], state["out"]
    span, chord, sweep, tc = map(float, p4[0])
    mesh = structured_wing_mesh(span, chord, sweep, tc, res)
    bs = build_boundary_sets(mesh)

    # ---- 6a. kernels D and E at the DOF100K mesh's shapes
    tets = torch.as_tensor(mesh.tets, device=dev)
    grads, vols = tet4_setup(torch.as_tensor(mesh.nodes, device=dev), tets)
    gen = torch.Generator(device=dev).manual_seed(4)
    u = torch.randn((mesh.num_nodes, 3), generator=gen, dtype=torch.float64, device=dev)
    kd = check_stiffness_apply(dev, mesh, bs.nroot_nodes, lam, mu)
    # kernel E at every plan and width the port launches it at here: the
    # gather path's (the element forces on the incidence; seeded values
    # elsewhere) and the stencil engine's at phase 3's batch
    fe = asm.tet4_element_force_plain(grads, vols, tets, u, lam, mu)
    plans = mesh_plans(mesh, bs, dev, two_level=True)
    bt, nb = solver.bt, p4.shape[0]
    ke = {}
    for label, plan, widths in (
            ("gather incidence", plans["incidence"], (3, 6, 1)),
            ("gather loads", plans["loads"], (3,)),
            ("gather line blk_plan", plans["line"]["blk_plan"], (9,)),
            ("gather RBM group_plan", plans["rbm"].group_plan, (4, 6)),
            ("gather RBM pair_plans[0]", plans["rbm"].pair_plans[0], (36,)),
            ("stencil upper_plan", bt.upper_plan, (3 * nb,)),
            ("stencil tet_plan", bt.tet_plan, (6 * nb, nb))):
        for C in widths:
            vals = (fe if (label, C) == ("gather incidence", 3) else
                    torch.randn((plan.order.shape[0], C), generator=gen, dtype=torch.float64,
                                device=dev))
            ke[f"{label} C={C}"] = check_csr_sum(f"{label} C={C}", vals, plan)
    state["rbm_groups"] = (plans["rbm"].node_group.cpu().numpy(), plans["rbm"].n_groups)
    del plans, vals

    # ---- 6b. the stencil solve of phase 3, again: on a fresh solver (setup
    # built anew: kernel E's fixed order), then on phase 3's (its setup cache)
    for label, slv in (("a fresh WingStencilT", WingStencilT(res, device=dev)),
                       ("phase 3's solver, its setup cache", solver)):
        again = slv.solve(p4, pressure=PRESSURE, tol=TOL, maxiter=2000, outer_f64=True)
        torch.cuda.synchronize()
        setup_s = slv.last_timing["setup_s"]
        require(again.iters == out.iters, f"{label}: {again.iters} iters, not {out.iters}")
        for f in ("nodes", "u", "stress6", "vm", "rel_residual"):
            require(torch.equal(getattr(again, f), getattr(out, f)), f"{label}: {f} differs")
        require((setup_s == 0) == (slv is solver), f"{label}: setup took {setup_s:.3f} s")
        print(f"[repeat] phase 3's batch solved again on {label}: {again.iters} iters, setup "
              f"{setup_s:.3f} s, solve {slv.last_timing['solve_s']:.3f} s; nodes, u, stress6, vm "
              f"and the residuals bitwise equal to phase 3's")

    # ---- 6c. full width through the gather path, launch counters zeroed
    asm.stiffness_apply.launches = 0
    cs.csr_segment_sum.launches = 0
    # the ladder's float64 rung: it reports the TRUE residual and, where the
    # uninterrupted f64 CG drifted above tol (a recurred 1e-6 against a TRUE
    # 1.08e-6 on an NVIDIA H100 80GB HBM3, 700 W), takes one refinement step
    cfg64 = WingSolveConfig(pressure=PRESSURE, dtype=torch.float64, tol=TOL)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = solve_wing_case(mesh, bs, cfg64, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state["peak_bytes"]["DOF100K gather f64 solve"] = torch.cuda.max_memory_allocated()
    again = solve_wing_case(mesh, bs, cfg64, device=dev)
    require(again.iters == sol.iters and np.array_equal(again.u, sol.u)
            and np.array_equal(again.vm, sol.vm),
            f"gather f64 solve repeated: {again.iters} vs {sol.iters} iters or other bits")
    t0 = time.perf_counter()
    solve_wing_case(mesh, bs, dataclasses.replace(cfg64, maxiter=0), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    require(sol.converged, f"gather f64 solve not converged: rel {sol.rel_residual:.3e}")
    rel_cpu = gather_true_residual_cpu(mesh, bs, sol.u, lam, mu)
    u_st = out.u[:, :, 0].cpu().numpy()
    d_st = float(np.linalg.norm(sol.u - u_st) / np.linalg.norm(u_st))
    ms_iter = (wall - setup_s) / max(sol.iters, 1) * 1e3
    print(f"[gather] DOF100K wing 0 ({3 * mesh.num_nodes} DOF, T={mesh.num_tets}) f64, line + RBM "
          f"PCG (the float64 rung: a refinement step where the TRUE residual asks for it), tol "
          f"{TOL}: {sol.iters} iters, solved twice with bitwise-equal u and vm, reported TRUE rel "
          f"{sol.rel_residual:.3e}, wall {wall:.3f} s (setup + recovery {setup_s:.3f} s, the "
          f"same solve at maxiter=0) = {ms_iter:.4f} ms per iteration; TRUE f64 rel recomputed "
          f"on the CPU {rel_cpu:.3e} (bar {TOL}); |u - u_stencil| / |u_stencil| {d_st:.3e} "
          f"(bar 1e-3)")
    require(rel_cpu <= TOL, f"gather f64 TRUE residual {rel_cpu:.3e} above tol")
    require(d_st <= 1e-3, f"gather vs stencil solution {d_st:.3e}")

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_gather_") as root:
        paths = get_paths(Path(root) / "dof100k").ensure()
        wp = WingParams(span_m=span, chord_m=chord, sweep_deg=sweep, thickness_ratio=tc)
        require(run_geometry_case(wp, paths, case_id="g1").status == "success", "geometry")
        m = run_mesh_case(wp, "g1", paths, resolution=res)
        require(m.status == "success", f"mesh: {m.failure_reason}")
        t0 = time.perf_counter()
        rep = run_fem_case(wp, "g1", paths, pressure=PRESSURE, device=dev,
                           solve_config=WingSolveConfig(pressure=PRESSURE, engine="gather"))
        stage_s = time.perf_counter() - t0
        print(f"[gather] FEM stage, engine gather, default f32 config: {rep.status}; attempts: "
              f"{attempts_line(rep)}; spans {rep.extra.get('spans')}; wall {stage_s:.3f} s")
        require(rep.status == "success", f"gather FEM stage: {rep.failure_reason}")
        for name in ("wing_result.glb", "wing_result_arrows.glb"):
            require_glb(paths.fem_case("g1") / name)
        launches = {"stiffness_apply": asm.stiffness_apply.launches,
                    "csr_segment_sum": cs.csr_segment_sum.launches}
        print(f"[gather] kernel launches (6c): {launches}")
        require(launches["stiffness_apply"] > 0, "kernel D was not launched on the gather path")
        require(launches["csr_segment_sum"] > 0, "kernel E was not launched on the gather path")

        # ---- 6d. entry points at MEDIUM
        t0 = time.perf_counter()
        results = verify_pipeline(Path(root) / "verify", resolution=MEDIUM, device=dev)
        for r in results:
            # the hard case may fail, but with a stage's reason or its failed checks
            require(r.passed or (r.allowed_fail and ("reason" in r.details
                                                     or "checks" in r.details)),
                    f"spec case {r.name} failed: {r.details}")
        print(f"[verify] spec cases at MEDIUM: "
              f"{[(r.name, 'PASS' if r.passed else 'ALLOWED-FAIL') for r in results]} "
              f"({time.perf_counter() - t0:.3f} s)")

        paths = get_paths(Path(root) / "medium").ensure()
        easy = SPEC_CASES[0][1]
        src = structured_wing_mesh(easy.span_m, easy.chord_m, easy.sweep_deg,
                                   easy.thickness_ratio, MEDIUM)
        msh = Path(root) / "user_wing.msh"
        write_msh2(msh, src)
        m = run_mesh_case(easy, "user", paths, user_msh=msh)
        require(m.status == "success", f"user MSH mesh stage: {m.failure_reason}")
        t0 = time.perf_counter()
        rep = run_fem_case(easy, "user", paths, pressure=100.0, device=dev, solve_config=(
            WingSolveConfig(pressure=100.0, dtype=torch.float64, two_level=False)))
        require(rep.status == "success", f"user MSH FEM stage: {rep.failure_reason}")
        uz = float(np.load(paths.fem_case("user") / "surface_results.npz")["disp"][:, 2].mean())
        print(f"[user msh] MEDIUM mesh as MSH2 ({m.extra['num_nodes']} nodes): Jacobi PCG f64, "
              f"{attempts_line(rep)}, {time.perf_counter() - t0:.3f} s; mean surface u_z "
              f"{uz:.3e} m")
        require(uz < 0, f"user mesh mean u_z {uz:.3e} not downward")

        hard = SPEC_CASES[2][1]
        run_geometry_case(hard, paths, case_id="hard")
        m = run_mesh_case(hard, "hard", paths, resolution=MEDIUM)
        require(m.status == "success", f"hard mesh: {m.failure_reason}")
        t0 = time.perf_counter()
        rep = run_fem_case(hard, "hard", paths, pressure=5e3, device=dev, solve_config=(
            WingSolveConfig(pressure=5e3, tol=1e-6, maxiter=3000, engine="gather")))
        print(f"[ladder] hard case at MEDIUM, engine gather, f32, maxiter 3000: {rep.status}; "
              f"attempts: {attempts_line(rep)}; {time.perf_counter() - t0:.3f} s")
        require(rep.status == "success" or rep.failure_reason,
                "hard case failed without a reason")
        require("solve_ladder" in rep.extra or rep.extra["solver"]["converged"],
                "hard case: the ladder's attempts were not recorded")

    d64 = kd["ordered f64 masked"]
    e64 = ke["gather RBM group_plan C=6"]["f64"]
    return [
        {"name": "stiffness_apply", "route": "cuda", "source": "tpufem_torch/csrc/tet4_force.cu",
         "replaces": "tpufem/fem/assembly.py:60-97", "launches": launches["stiffness_apply"],
         **{k: d64[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         **{k: d64[k] for k in ("device_us", "device_us_cold", "share", "share_repeated",
                                "activities", "plan_bytes", "overlap", "blocks", "T", "N")},
         "shapes": kd},
        # at the shape of most of its launches: the RBM group sum of every
        # iteration of the f64 gather CG (6c), f64
        {"name": "csr_segment_sum", "route": "cuda",
         "source": "tpufem_torch/csrc/csr_segment_sum.cu",
         "replaces": "tpufem/fem/precond.py:267-268", "launches": launches["csr_segment_sum"],
         "shape": "gather RBM group_plan C=6", "dtype": "f64",
         "stencil_launches": state["stencil_csr_launches"],
         **{k: e64[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_us", "device_us_cold", "share",
                                "library_device_us", "library_device_us_cold")},
         "shapes": ke},
    ]


# ---------------------------------------------------------------- phase 7

REPO = Path(__file__).resolve().parent
MODAL_REPORT = REPO / "results" / "modal_demo" / "modal_report.json"
BUCKLING_REPORT = REPO / "results" / "buckling_demo" / "buckling_report.json"


def dynamics_counters():
    """The launch counters of the dynamics path's kernels, by the names of
    the kernels' line."""
    from tpufem_torch.fem import buckling as bk
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.ops import csr_segment_sum as cs

    return {"strain_apply": st.strain_apply, "csr_segment_sum": cs.csr_segment_sum,
            "element_stress": bk.element_stress, "geom_apply": bk.geom_apply}


def require_spanwise_bending(nodes, phi):
    """The first mode of a clamped thin wing is first bending: mostly z,
    amplitude growing root band -> mid -> tip band (tests/test_modal.py)."""
    comp = (phi**2).sum(axis=0)
    require(comp[2] > 5 * max(comp[0], comp[1]), f"mode 1 not z-dominant: {comp}")
    y = nodes[:, 1]
    span = y.max() - y.min()
    amp = np.abs(phi[:, 2])
    tip = amp[y > y.min() + 0.8 * span].mean()
    mid = amp[(y > y.min() + 0.4 * span) & (y < y.min() + 0.6 * span)].mean()
    root = amp[y < y.min() + 0.2 * span].mean()
    require(tip > mid > root, f"mode 1 amplitude root {root:.3e} mid {mid:.3e} tip {tip:.3e}")


def cli_report(mod, argv, out_dir, name):
    """Run a dynamics CLI on the card; its report JSON and wall seconds."""
    t0 = time.perf_counter()
    rc = mod.main([*argv, "--out", str(out_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(rc == 0, f"{mod.__name__} exited {rc}")
    return json.loads((out_dir / name).read_text()), wall


def run_dynamics(dev, res, state):
    """Phase 7: kernels F and G, then WingModal at DOF100K and the three
    dynamics CLIs at their defaults against tpufem's recorded reports.
    Returns kernels F's and G's report entries."""
    from tpufem_torch.fem.modal import WingModal
    from tpufem_torch.profile_geometric import (
        CLI_P4,
        CLI_RES,
        CLI_SHAPES,
        DESIGNS,
        Q,
        REPLACES,
        SOURCES,
        line,
        measure,
    )
    from tpufem_torch.scripts import buckling_analysis, modal_analysis, prestress_sweep

    # ---- 7a. kernels F and G at DOF100K, q = 12, and at the grid and lane
    # counts the buckling (7d) and prestress (7e) CLIs launch them with
    geo = {"DOF100K": measure(res, Q, dev)}
    for label, q in CLI_SHAPES.items():
        geo[label] = measure(CLI_RES, q, dev, CLI_P4)
    for label, recs in geo.items():
        for rec in recs.values():
            print(line(label, rec))
    # a non-symmetric sigma holds G to tpufem's g_a^T sigma g_b (measure raises on a miss)
    for rec in measure(CLI_RES, Q, dev, CLI_P4, timed=False, symmetric=False).values():
        print(line("32x40x4 non-symmetric sigma", rec))

    counters = dynamics_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fg = ("element_stress", "geom_apply")

    def fg_launches():
        return np.array([counters[n].launches for n in fg])

    # ---- 7b. WingModal at DOF100K, wing 0 of the seeded batch
    t0 = time.perf_counter()
    wm = WingModal(res, state["p4"][0])
    out = wm.solve(n_modes=6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    f = out.freqs_hz
    print(f"[modal] DOF100K wing 0 ({3 * wm.num_nodes} DOF), 6 modes, q=12: {f.tolist()} Hz; "
          f"{out.sweeps} sweeps, {out.inner_iters} block-CG iterations, converged "
          f"{out.converged}; eig_residual {[f'{r:.2e}' for r in out.eig_residual]}; wall "
          f"{wall:.3f} s (solver set-up included)")
    require(out.converged, "DOF100K modal solve did not converge")
    require(out.eig_residual[0] <= 1e-6, f"mode 1 eigen-residual {out.eig_residual[0]:.3e}")
    require(f[0] > 0 and bool(np.all(np.diff(f) > 0)), f"frequencies not ascending: {f}")
    require_spanwise_bending(wm.mesh.nodes, out.modes[:, :, 0])

    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="smoke_dyn_") as root:
        root = Path(root)
        # ---- 7c. modal CLI at its defaults against tpufem's record
        rep, wall = cli_report(modal_analysis, ["--glb"], root / "modal", "modal_report.json")
        ref = json.loads(MODAL_REPORT.read_text())
        fm, fr = np.array(rep["freqs_hz"]), np.array(ref["freqs_hz"])
        dm = float(np.max(np.abs(fm - fr) / fr))
        print(f"[modal] CLI defaults {rep['resolution']} ({rep['n_dof']} DOF): {fm.tolist()} Hz, "
              f"{rep['sweeps']} sweeps (tpufem's record: {ref['sweeps']}), converged "
              f"{rep['converged']}; largest relative difference from {MODAL_REPORT.name}: "
              f"{dm:.3e} (bar 1e-6); CLI wall {wall:.3f} s, solve {rep['wall_s']} s")
        require(rep["converged"] and dm <= 1e-6, f"modal vs tpufem's record: {dm:.3e}")
        state["modal_tet4_freqs"] = fm.tolist()
        for i, fi in enumerate(fm):
            require_glb(root / "modal" / f"mode_{i + 1:02d}_{fi:.1f}hz.glb")

        # ---- 7d. buckling CLI at its defaults against tpufem's record
        n_free = fg_launches()  # the free-vibration solves launch neither F nor G
        require(not n_free.any(), f"F, G launched by the free-vibration solves: {n_free}")
        rep, wall = cli_report(buckling_analysis, [], root / "buckling", "buckling_report.json")
        n_buckling = fg_launches()
        ref = json.loads(BUCKLING_REPORT.read_text())
        lb, lr = np.array(rep["factors"], float), np.array(ref["factors"], float)
        db = float(np.max(np.abs(lb - lr) / lr))
        print(f"[buckling] CLI defaults ({rep['n_dof']} DOF, 4 modes, tol 1e-5): factors "
              f"{lb.tolist()}, {rep['sweeps']} sweeps (tpufem's record: {ref['sweeps']}), "
              f"converged {rep['converged']}; largest relative difference from "
              f"{BUCKLING_REPORT.name}: {db:.3e} (bar 1e-4); CLI wall {wall:.3f} s, solve "
              f"{rep['wall_s']} s")
        require(rep["converged"] and db <= 1e-4, f"buckling vs tpufem's record: {db:.3e}")

        # ---- 7e. the stress-stiffened spectrum at p = 0 and 0.5 lambda_cr
        p = 0.5 * rep["load_factor"]
        rep, wall = cli_report(
            prestress_sweep, ["--load_factors", "0", repr(p), "--n_modes", "6", "--tol", "1e-9",
                              "--inner_maxiter", "400"],
            root / "prestress", "prestress_sweep.json")
        f0, fp = np.array(rep["freqs_hz"][0]), np.array(rep["freqs_hz"][1])
        d0 = float(np.max(np.abs(f0 - fm) / fm))
        print(f"[prestress] p = 0: largest relative difference from the free vibration of 7c "
              f"{d0:.3e} (bar 1e-6); p = {p:.1f} (0.5 lambda_cr): {fp.tolist()} Hz, f1 "
              f"{fp[0] / f0[0] - 1:+.2%}; sweeps {rep['sweeps']}, converged {rep['converged']}; "
              f"CLI wall {wall:.3f} s")
        require(all(rep["converged"]) and d0 <= 1e-6, f"p = 0 vs free vibration: {d0:.3e}")
        require(fp[0] < f0[0], f"p = 0.5 lambda_cr did not lower f1: {fp[0]} vs {f0[0]}")
        by_shape = dict(zip(CLI_SHAPES, (n_buckling, fg_launches() - n_buckling)))

    state["peak_bytes"]["dynamics phase"] = torch.cuda.max_memory_allocated()
    launches = {name: c.launches for name, c in counters.items()}
    fg_by_shape = {s: dict(zip(fg, n.tolist())) for s, n in by_shape.items()}
    print(f"[dynamics] kernel launches (7b-7e): {launches}; F and G by shape {fg_by_shape}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the dynamics path")
    entries = []
    for i, name in enumerate(fg):
        shape_n = {s: int(n[i]) for s, n in by_shape.items()}
        require(sum(shape_n.values()) == launches[name],
                f"{name}: launches outside the buckling and prestress CLIs")
        main = max(shape_n, key=shape_n.get)  # the shape of most launches (the first on a tie)
        rec, rec32 = geo[main][f"{name} f64"], geo[main][f"{name} f32"]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "design": DESIGNS[name],
            "replaces": REPLACES[name],
            "launches": launches[name], "shape": main, "launches_by_shape": shape_n,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms")},
            "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"], "library_ms": None,
            **{k: rec[k] for k in ("device_us", "device_us_cold", "share", "share_repeated",
                                   "activities", "q")},
            "f32": {k: rec32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_us",
                                          "device_us", "device_us_cold", "share")},
            "shapes": {s: {d: {k: r[f"{name} {d}"][k]
                               for k in ("q", "max_abs_err", "ms", "plain_ms", "bound_us",
                                         "device_us", "device_us_cold", "share")}
                           for d in ("f64", "f32")} for s, r in geo.items()}})
    return entries


# ---------------------------------------------------------------- phase 8

NONLINEAR_REPORT = REPO / "results" / "nonlinear_demo" / "nonlinear_report.json"
OPT_RECORD = REPO / "results" / "wing_optimization.json"
# tpufem's own CLI on the CPU: PYTHONPATH=. JAX_PLATFORMS=cpu python
# scripts/optimize_wing.py --n_chord 24 --n_span 32 --n_thick 2 --steps 5
OPT_CPU_REFERENCE = REPO / "tpufem_torch" / "reference" / "optimize_wing_24x32x2_steps5.json"
NEWTON_TOL_DOF100K = 1e-7


def design_counters():
    """The launch counters of the design path's kernels, by the names of the
    kernels' line."""
    from tpufem_torch.fem import nonlinear as nl
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.ops import csr_segment_sum as cs

    return {"strain_apply": st.strain_apply, "csr_segment_sum": cs.csr_segment_sum,
            "stvk_internal_force": nl.stvk_internal_force,
            "stvk_tangent_apply": nl.stvk_tangent_apply, "stvk_energy": nl.stvk_energy,
            "strain_apply_geo_vjp": st.strain_apply_geo_vjp}


def require_rows(rows, ref, label):
    """History rows against a reference's at the record's own rounding: the
    loss within 1e-6 relative, volume ratios within 1e-4, smax within 0.01
    MPa (one unit of the rounding each)."""
    for r, q in zip(rows, ref, strict=True):
        require(r["step"] == q["step"], f"{label}: step {r['step']} against {q['step']}")
        dl = abs(r["loss"] - q["loss"]) / abs(q["loss"])
        dv = np.abs(np.subtract(r["volume_ratio"], q["volume_ratio"])).max()
        ds = np.abs(np.subtract(r["smax_MPa"], q["smax_MPa"])).max()
        require(dl <= 1e-6 and dv <= 1e-4 + 1e-12 and ds <= 1e-2 + 1e-12,
                f"{label} step {r['step']}: loss {dl:.2e}, volume {dv:.1e}, smax {ds:.2f} MPa")


def run_design(dev, res, state):
    """Phase 8: kernels H, I, J and K, then the nonlinear CLI against
    tpufem's record, WingNonlinear at DOF100K, the adjoint gradient against
    finite differences and the optimize CLI against tpufem's rows. Returns
    the four kernels' report entries."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.adjoint import DifferentiableWingFEM
    from tpufem_torch.fem.nonlinear import WingNonlinear
    from tpufem_torch.profile_nonlinear import (
        DESIGNS,
        LETTERS,
        OPT_RES,
        REPLACES,
        SOURCES,
        line,
        measure,
        opt_start_p4,
        shapes,
    )
    from tpufem_torch.scripts import nonlinear_solve, optimize_wing

    # ---- 8a. kernels H, I, J and K at the shapes (b)-(e) launch them with, and
    # H, I and J at the edges of the tiles
    recs = {}
    for label, fn, kw in shapes(dev, u_dof100k=st.to_grid(res, state["out"].u[:, :, :1])):
        out = fn(label, device=dev, **kw)
        for rec in (out.values() if fn is measure else (out,)):
            print(line(rec))
            recs[(rec["kernel"], label)] = rec

    counters = design_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    by_case = {}

    def mark(case):
        by_case[case] = {n: c.launches - sum(v[n] for v in by_case.values())
                         for n, c in counters.items()}

    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="smoke_design_") as root:
        root = Path(root)
        # ---- 8b. the nonlinear CLI at its defaults against tpufem's record
        rep, wall = cli_report(nonlinear_solve, ["--glb"], root / "nl", "nonlinear_report.json")
        mark("16x24x4 CLI wing, linear u")
        ref = json.loads(NONLINEAR_REPORT.read_text())
        tip, tref = rep["tip_deflection_m"], ref["tip_deflection_m"]
        d_nl = abs(tip["nonlinear"] - tref["nonlinear"]) / tref["nonlinear"]
        d_lin = abs(tip["linear"] - tref["linear"]) / tref["linear"]
        d_st = abs(tip["stiffening_pct"] - tref["stiffening_pct"])
        vm, vref = (r["max_von_mises_pa"]["nonlinear_cauchy"] for r in (rep, ref))
        d_vm = abs(vm - vref) / vref
        print(f"[nonlinear] CLI defaults {rep['resolution']} ({rep['n_dof']} DOF), "
              f"{rep['pressure_pa']:.0f} Pa, {len(rep['load_steps'])} load steps: converged "
              f"{rep['converged']} at rel {rep['rel_residual']:.3e}; tip {tip['nonlinear']:.10f} m "
              f"nonlinear ({d_nl:.2e} from the record, bar 1e-5), {tip['linear']:.10f} m linear "
              f"({d_lin:.2e}), stiffening {tip['stiffening_pct']} % (record "
              f"{tref['stiffening_pct']}, bar 0.01); max Cauchy vM {vm:.6e} Pa ({d_vm:.2e}, bar "
              f"1e-4); Newton {rep['newton_iters']} and CG {rep['cg_iters']} iterations "
              f"(tpufem's record: {ref['newton_iters']} / {ref['cg_iters']}; information); CLI "
              f"wall {wall:.3f} s, solve {rep['wall_s']} s")
        require(rep["converged"] and d_nl <= 1e-5 and d_lin <= 1e-5 and d_st <= 0.01
                and d_vm <= 1e-4, f"nonlinear CLI against {NONLINEAR_REPORT.name}: "
                f"{d_nl:.2e} {d_lin:.2e} {d_st:.3f} {d_vm:.2e}")
        for name in ("nonlinear", "linear"):
            require_glb(root / "nl" / f"wing_{name}_deformed.glb")

        # ---- 8c. WingNonlinear at DOF100K, wing 0, one load step, to 1e-7:
        # f64's floor on this grid is ~3e-8 (TRUE residual of the linear solve
        # 3.3e-8 at any tol below it, of the Newton iterates 3.0e-8), so 1e-8
        # is out of reach
        t0 = time.perf_counter()
        wn = WingNonlinear(res, state["p4"][0], pressure=PRESSURE, inner_tol=1e-10,
                           inner_maxiter=800)
        out = wn.solve(n_steps=1, newton_tol=NEWTON_TOL_DOF100K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mark("DOF100K wing 0, linear u")
        dn = float(np.linalg.norm(out.u - out.u_linear) / np.linalg.norm(out.u_linear))
        n = by_case["DOF100K wing 0, linear u"]
        print(f"[nonlinear] DOF100K wing 0 ({3 * wn.num_nodes} DOF), {PRESSURE:.0f} Pa, one load "
              f"step, newton_tol {NEWTON_TOL_DOF100K}: converged {out.converged} at rel "
              f"{out.rel_residual:.3e}; Newton "
              f"{out.newton_iters}, CG {out.cg_iters} iterations; |u_nl - u_lin| / |u_lin| "
              f"{dn:.3e}; wall {wall:.3f} s (set-up and the linear reference included); "
              f"launches B {n['strain_apply']}, H {n['stvk_internal_force']}, I "
              f"{n['stvk_tangent_apply']}, J {n['stvk_energy']}")
        require(out.converged and 0 < dn < 1e-2, f"DOF100K nonlinear: {out.rel_residual:.3e}, "
                                                 f"{dn:.3e}")

        # ---- 8d. the adjoint gradient on the card against central differences
        p0 = opt_start_p4()
        t0 = time.perf_counter()
        fem = DifferentiableWingFEM(OPT_RES, p0, tol=1e-11, maxiter=4000)
        p = torch.tensor(p0, device=dev, requires_grad=True)
        grad = torch.autograd.grad(fem.compliance(p, fem.solve(p)).sum(), p)[0].cpu().numpy()
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        cg = {k: (v["iters"], float(v["rel"].max()), float(fem.true_residual(k).max()))
              for k, v in fem.last_cg.items()}
        worst = 0.0
        for b in (0, 3):
            for i, eps in ((1, 1e-5), (3, 1e-6)):
                vals = []
                for sign in (1, -1):
                    pp = p0.copy()
                    pp[b, i] += sign * eps
                    with torch.no_grad():
                        vals.append(float(fem.compliance(pp, fem.solve(pp)).sum()))
                fd = (vals[0] - vals[1]) / (2 * eps)
                worst = max(worst, abs(grad[b, i] - fd) / abs(fd))
        mark("32x40x4 optimizer start")
        print(f"[adjoint] {list(OPT_RES.key)} B=4 ({3 * fem.st.num_nodes} DOF per lane), tol "
              f"1e-11: compliance gradient in {grad_s:.3f} s (set-up included); CG (iterations, "
              f"recurred rel, TRUE f64 rel): {cg}; chord and thickness of lanes 0 and 3 against "
              f"central differences on the card: largest relative difference {worst:.2e} (bar "
              f"1e-5); thickness gradients {grad[:, 3].tolist()}")
        require(worst <= 1e-5 and bool((grad[:, 3] < 0).all()),
                f"adjoint gradient against finite differences: {worst:.2e}")

        # ---- 8e. the optimize CLI at its record's grid, 5 steps
        t0 = time.perf_counter()
        rc = optimize_wing.main(["--n_chord", "24", "--n_span", "32", "--n_thick", "2",
                                 "--steps", "5", "--out", str(root / "opt.json"),
                                 "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc == 0, f"optimize_wing exited {rc}")
        mark("24x32x2 optimizer start")
        rep = json.loads((root / "opt.json").read_text())
        cpu_ref = json.loads(OPT_CPU_REFERENCE.read_text())
        record = json.loads(OPT_RECORD.read_text())
        require_rows(rep["history"], cpu_ref["history"], "optimize_wing vs tpufem's CPU run")
        require_rows(rep["history"][:1], record["history"][:1], "optimize_wing vs the record")
        print(f"[optimize] 24x32x2 ({rep['dof']} DOF), 4 lanes, 5 steps on {rep['device']}: rows "
              f"0-4 equal tpufem's own CPU run ({OPT_CPU_REFERENCE.name}) and row 0 the record "
              f"at the record's rounding; losses {[h['loss'] for h in rep['history']]}; final "
              f"volume ratios {rep['final_volume_ratio']}, smax {rep['final_smax_MPa']} MPa; wall "
              f"{wall:.3f} s, {wall / 5:.3f} s per step (set-up included)")

    state["peak_bytes"]["design phase"] = torch.cuda.max_memory_allocated()
    launches = {name: c.launches for name, c in counters.items()}
    print(f"[design] kernel launches (8b-8e): {launches}; by case {by_case}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the design path")
    entries = []
    for name in ("stvk_internal_force", "stvk_tangent_apply", "stvk_energy",
                 "strain_apply_geo_vjp"):
        shape_n = {case: n[name] for case, n in by_case.items() if n[name]}
        main = max(shape_n, key=shape_n.get)  # the shape of most launches
        rec = recs[(name, main)]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "design": DESIGNS[name],
            "replaces": REPLACES[name], "kernel_letter": LETTERS[name],
            "launches": launches[name], "shape": main, "launches_by_shape": shape_n,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms")},
            "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"], "library_ms": None,
            **{k: rec[k] for k in ("device_us", "device_us_cold", "share", "share_repeated",
                                   "activities", "bytes")},
            "shapes": {lbl: {k: r[k] for k in ("grid", "B", "max_abs_err", "ms", "plain_ms",
                                              "bound_us", "device_us", "device_us_cold", "share")}
                       for (kn, lbl), r in recs.items() if kn == name}})
    return entries


# ---------------------------------------------------------------- phase 9

TET10_RECORD = REPO / "results" / "flagship_tet10_2p5mdof.json"
TET10_MODAL_RES = (8, 10, 2)  # tpufem's WingModal10 test grid


def tet10_counters():
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem import tet10 as tt10
    from tpufem_torch.fem import tet10_stencil as ts
    from tpufem_torch.ops import csr_segment_sum as cs

    return {"strain_apply10": ts.strain_apply10, "prolong_p": ts.prolong_p,
            "restrict_p": ts.restrict_p, "strain_apply": st.strain_apply,
            "csr_segment_sum": cs.csr_segment_sum, "tet10_force": tt10.tet10_force}


def tet10_true_residual_cpu(res, p4, u_nodes, upper_t6, lam, mu):
    """The flagship's TRUE f64 relative residual recomputed on the CPU: the
    f64 geometry and T6 loads built there, the operator strain_apply10_plain."""
    from tpufem_torch.fem import tet10_stencil as ts
    from tpufem_torch.fem.tet10 import pressure_loads_t6

    X = ts.nodes_grid2(res, torch.tensor([p4], dtype=torch.float64), torch.float64)
    geo = ts.cell_geometry2(res, X)
    free2 = ts.free_mask2(res, torch.float64)
    n10 = ts.from_grid2(res, X)
    bg = ts.to_grid2(res, pressure_loads_t6(n10, upper_t6, PRESSURE, n10.shape[0])) * free2
    r = bg - ts.strain_apply10_plain(res, geo, ts.to_grid2(res, torch.as_tensor(u_nodes)),
                                     free2, lam, mu)
    return float(torch.sqrt((r * r).sum()) / torch.sqrt((bg * bg).sum()))


def run_tet10(dev, state):
    """Phase 9: kernels L and M at the tet10 path's shapes, kernel B at every
    level of the flagship's tet4 V-cycle, then, launch counters zeroed, the
    flagship CLI (solve_tet10_1m --refine 8 at DOF1M_TET10), the modal CLI
    with --element tet10 at its defaults and WingModal10 against scipy.
    Returns kernels L's and M's report entries."""
    import scipy.sparse as ssp
    import scipy.sparse.linalg as spla

    from tpufem_torch import profile_tet10 as pt
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.modal import WingModal10
    from tpufem_torch.fem.refsolve import assemble_K10
    from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
    from tpufem_torch.fem import tet10_stencil as ts
    from tpufem_torch.fem.tet10 import (
        stress_nodal_terms,
        t6_midside_forces,
        tet10_setup,
        tet10_upper_t6,
    )
    from tpufem_torch.mesher import DOF1M_TET10, WingMeshResolution
    from tpufem_torch.scripts import modal_analysis, solve_tet10_1m

    lam, mu = lame_params(Material())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    # ---- 9a. kernels L and M at the flagship's, the modal CLI's and a sharp-TE shape
    recs = {}
    for label, (res, p4s) in pt.SHAPES.items():
        recs[label] = {**{f"strain_apply10 {d}": r
                          for d, r in pt.measure_L(label, res, p4s, dev).items()},
                       **pt.measure_M(label, res, len(p4s), dev)}
        for rec in recs[label].values():
            print(pt.line(rec) + f" [{smi}]", flush=True)
    # ---- 9b. kernel B at every level of the flagship's tet4 V-cycle (n_thick 8)
    for r in hierarchy_resolutions(DOF1M_TET10)[:-1]:
        v = check_strain_apply_level(dev, r, np.array([pt.FLAGSHIP_P4]), lam, mu)
        print(f"[kernel B] {r.key} B=1: f64 max|err| {v['f64']['max_abs_err']:.3e} (scale "
              f"{v['f64']['scale']:.3e}, bar 1e-12 rel); f32 err vs f64 "
              f"{v['f32']['max_abs_err']:.3e} (plain f32 {v['f32']['plain_max_abs_err']:.3e}, "
              f"bar 2x); bitwise repeatable in both", flush=True)

    counters = tet10_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    by_case = {}

    def mark(case):
        by_case[case] = {n: c.launches - sum(b[n] for b in by_case.values())
                         for n, c in counters.items()}

    # ---- 9c. the flagship CLI: the record's command without --chunk
    t0 = time.perf_counter()
    rec, extra = solve_tet10_1m.run(["--refine", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mark("flagship CLI")
    d = rec["detail"]
    ref = json.loads(TET10_RECORD.read_text())["detail"]
    out, solver, mesh = extra["out"], extra["solver"], extra["mesh"]
    u = out.u
    res = solver.res
    ut6 = tet10_upper_t6(solver.t10, extra["sets"].surf_upper_faces)
    rel_cpu = tet10_true_residual_cpu(res, pt.FLAGSHIP_P4, u[:, :, None], ut6, lam, mu)
    n10 = solver.t10.nodes10(mesh.nodes)
    y, span = n10[:, 1], n10[:, 1].max()
    uz_tip = u[y > 0.95 * span, 2].mean()
    vm = out.vm
    vm_root, vm_tip = vm[y < 0.25 * span].mean(), vm[y > 0.75 * span].mean()
    dvm = abs(d["max_vm_mpa"] - ref["max_vm_mpa"]) / ref["max_vm_mpa"]
    print(f"[tet10] flagship CLI at {res.key} ({d['dof']} DOF, {d['num_tet10']} tets) on "
          f"{d['device']} [{smi}]: {d['iters']} iterations (tpufem's record: {ref['iters']}), "
          f"converged {d['converged']}, TRUE f64 rel {d['rel_residual']:.3e} on the device, "
          f"{rel_cpu:.3e} recomputed on the CPU, 80-bit xprec {d['xprec_rel_residual']:.3e} "
          f"(record {ref['xprec_rel_residual']:.3e}); max vM {d['max_vm_mpa']} MPa (record "
          f"{ref['max_vm_mpa']}, rel {dvm:.2e}); tip u_z {uz_tip:.4e} m, root vM "
          f"{vm_root:.4e} vs tip {vm_tip:.4e}; CLI wall {wall:.3f} s, solve "
          f"{rec['value']} s, timing {d['timing_s']}, peak device memory "
          f"{d['peak_device_memory_bytes']} B", flush=True)
    require(d["converged"] and d["rel_residual"] <= 1e-5, f"flagship: {d}")
    require(rel_cpu <= 1e-5, f"flagship TRUE rel on the CPU {rel_cpu:.3e}")
    require(d["xprec_rel_residual"] <= 1e-5, f"flagship xprec {d['xprec_rel_residual']:.3e}")
    require(dvm <= 1e-3, f"flagship max vM {d['max_vm_mpa']} vs the record's {ref['max_vm_mpa']}")
    require(uz_tip < 0 and vm_root > 3.0 * vm_tip and np.isfinite(u).all(),
            f"flagship physics: tip u_z {uz_tip:.3e}, root vM {vm_root:.3e}, tip {vm_tip:.3e}")
    state["tet10"] = {"cli": rec, "true_rel_cpu": rel_cpu, "u": u}

    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="smoke_tet10_") as root:
        # ---- 9d. the modal CLI with --element tet10 at its defaults
        t0 = time.perf_counter()
        rep, mout, wm = modal_analysis.run(["--element", "tet10", "--device", "cuda",
                                            "--out", str(Path(root) / "modal10")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mark("modal CLI tet10")
        f4 = state.get("modal_tet4_freqs", [])
        print(f"[modal tet10] CLI defaults {rep['resolution']} ({rep['n_dof']} DOF): "
              f"{rep['freqs_hz']} Hz beside tet4's {f4} Hz; {rep['sweeps']} sweeps, "
              f"{mout.inner_iters} block-CG iterations, converged {rep['converged']}, "
              f"eig_residual {[f'{r:.2e}' for r in rep['eig_residual']]}; CLI wall {wall:.3f} s, "
              f"solve {rep['wall_s']} s [{smi}]", flush=True)
        require(rep["converged"], "modal CLI tet10 did not converge")
        require_spanwise_bending(wm.nodes10, mout.modes[:, :, 0])

    # ---- 9e. WingModal10 at tpufem's test grid against scipy shift-invert
    t0 = time.perf_counter()
    wm = WingModal10(WingMeshResolution(*TET10_MODAL_RES, 0.006, "le"), (1.2, 0.35, 10.0, 0.10))
    mres = wm.solve(n_modes=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mark("WingModal10 8x10x2")
    K = assemble_K10(wm.nodes10, wm.t10.tet10, Material())
    free = np.repeat(wm.free_rows, 3)
    w = spla.eigsh(K[free][:, free], k=4, M=ssp.diags(np.repeat(wm.mass, 3)[free]), sigma=0,
                   which="LM", return_eigenvectors=False)
    f_ref = np.sqrt(np.sort(w)) / (2 * np.pi)
    df = float(np.max(np.abs(mres.freqs_hz - f_ref) / f_ref))
    print(f"[modal tet10] WingModal10 {TET10_MODAL_RES}: {mres.freqs_hz.tolist()} Hz vs scipy "
          f"shift-invert {f_ref.tolist()}: largest relative difference {df:.3e} (bar 1e-7); "
          f"{mres.sweeps} sweeps, wall {wall:.3f} s", flush=True)
    require(mres.converged and df <= 1e-7, f"WingModal10 vs scipy: {df:.3e}")

    state["peak_bytes"]["tet10 phase"] = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[tet10] kernel launches (9c-9e): {launches}; by case {by_case}", flush=True)
    for name in ("strain_apply10", "prolong_p", "restrict_p", "strain_apply", "csr_segment_sum"):
        require(launches[name] > 0, f"{name} was not launched on the tet10 path")

    # ---- 9f. kernel E at the flagship's own plans and operands (after the
    # counts are read: these launches are comparisons): the T6 midside loads
    # (C=3) on the solver's t6 plan, the nodal stress numerator (C=6) and
    # denominator (C=1) on its connectivity plan
    conn, cplan = solver._conn()
    X64 = ts.nodes_grid2(res, torch.tensor([pt.FLAGSHIP_P4], dtype=torch.float64, device=dev),
                         torch.float64)
    f6 = t6_midside_forces(ts.from_grid2(res, X64), ut6, PRESSURE)
    Jinv, vols = tet10_setup(torch.as_tensor(n10, dtype=torch.float64, device=dev), conn)
    num, den = stress_nodal_terms(Jinv, vols, conn, torch.as_tensor(u, device=dev), lam, mu)
    state["tet10_csr"] = {
        "launches": launches["csr_segment_sum"],
        "shapes": {"tet10 T6 loads C=3": check_csr_sum("tet10 T6 midside loads C=3", f6,
                                                       solver._t6_plan(ut6)),
                   "tet10 connectivity C=6": check_csr_sum(
                       "tet10 connectivity (nodal stress numerator) C=6", num, cplan),
                   "tet10 connectivity C=1": check_csr_sum(
                       "tet10 connectivity (nodal stress denominator) C=1", den, cplan)}}
    del Jinv, vols, num, den, f6
    shape_of = {"flagship CLI": "DOF1M_TET10 B=1", "modal CLI tet10": "32x40x4 q=12"}
    entries = []
    for name in ("strain_apply10", "prolong_p", "restrict_p"):
        shape_n = {case: n[name] for case, n in by_case.items() if n[name]}
        top = max((c for c in shape_n if c in shape_of), key=shape_n.get)
        rec, rec64 = (recs[shape_of[top]][f"{name} f32"], recs[shape_of[top]][f"{name} f64"])
        entries.append({
            "name": name, "route": "cuda", "source": pt.SOURCES[name],
            "design": pt.DESIGNS[name], "replaces": pt.REPLACES[name],
            "kernel_letter": pt.LETTERS[name], "launches": launches[name],
            "shape": shape_of[top], "dtype": "f32", "launches_by_shape": shape_n,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms")},
            "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **{k: rec[k] for k in ("device_us", "device_us_cold", "share", "share_repeated",
                                   "activities", "bytes", "flops")},
            "library_device_us": rec["library_device_us"],
            "f64": {k: rec64[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_us",
                                          "bound_by", "device_us", "device_us_cold", "share",
                                          "library_ms", "library_device_us")},
            "shapes": {lbl: {k: {f: r[f] for f in ("grid", "B", "max_abs_err", "ms", "plain_ms",
                                                   "bound_us", "bound_by", "device_us",
                                                   "device_us_cold", "share", "library_ms",
                                                   "library_device_us")}
                             for k, r in rs.items() if k.startswith(name)}
                       for lbl, rs in recs.items()}})
    entries.append(run_tet10_gather(dev, state, smi, lam, mu))
    return entries


def run_tet10_gather(dev, state, smi, lam, mu):
    """Phase 9g-9i, the tet10 gather engine: (g) kernel N against its plain
    version at N_SHAPES; then, launch counters zeroed, (h) the flagship CLI
    with --engine gather and (i) solve_tet10_case against Tet10MGSolver at
    tpufem's test grid, the counts read after. Returns kernel N's report
    entry."""
    from tpufem_torch import profile_tet10 as pt
    from tpufem_torch.fem.tet10 import (
        solve_tet10_case,
        tet10_from_tet4,
        tet10_root_nodes,
        tet10_upper_t6,
    )
    from tpufem_torch.fem.tet10_mg import Tet10MGSolver
    from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh
    from tpufem_torch.ops.kernels import build_info, ptxas_report
    from tpufem_torch.scripts import solve_tet10_1m
    from tpufem_torch.sets import build_boundary_sets

    # ---- 9g. kernel N at the flagship, 32x40x4 and a sharp-TE 16x24x4
    regs = {k: v for k, v in ptxas_report(build_info.get("log", "")).items()
            if "tet10_force" in k}
    print(f"[kernel N] ptxas: " + "; ".join(f"{k}: {r} registers, {ss} / {sl} B spilled"
                                           for k, (r, ss, sl) in sorted(regs.items())), flush=True)
    nrec = {}
    for label, (res, p4) in pt.N_SHAPES.items():
        nrec[label] = pt.measure_N(label, res, p4, dev)
        for rec in nrec[label].values():
            print(pt.line(rec) + f" [{smi}]", flush=True)

    counters = tet10_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    by_case = {}

    def mark(case):
        by_case[case] = {n: c.launches - sum(b[n] for b in by_case.values())
                         for n, c in counters.items()}

    # ---- 9h. the flagship CLI through the gather engine
    t0 = time.perf_counter()
    rec, extra = solve_tet10_1m.run(["--refine", "8", "--device", "cuda", "--engine", "gather"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mark("gather flagship CLI")
    d = rec["detail"]
    ref = json.loads(TET10_RECORD.read_text())["detail"]
    st9c = state["tet10"]
    out, solver, mesh = extra["out"], extra["solver"], extra["mesh"]
    u = out.u
    res = solver.res
    ut6 = tet10_upper_t6(solver.t10, extra["sets"].surf_upper_faces)
    rel_cpu = tet10_true_residual_cpu(res, pt.FLAGSHIP_P4, u[:, :, None], ut6, lam, mu)
    n10 = solver.t10.nodes10(mesh.nodes)
    y, span = n10[:, 1], n10[:, 1].max()
    uz_tip = u[y > 0.95 * span, 2].mean()
    vm = out.vm
    vm_root, vm_tip = vm[y < 0.25 * span].mean(), vm[y > 0.75 * span].mean()
    dvm = abs(d["max_vm_mpa"] - ref["max_vm_mpa"]) / ref["max_vm_mpa"]
    vm9c = st9c["cli"]["detail"]["max_vm_mpa"]
    dvm9c = abs(d["max_vm_mpa"] - vm9c) / vm9c
    du = float(np.abs(u - st9c["u"]).max() / np.abs(st9c["u"]).max())
    per_iter = counters["tet10_force"].launches / max(d["iters"], 1)
    print(f"[tet10 gather] flagship CLI --engine gather at {res.key} ({d['dof']} DOF) on "
          f"{d['device']} [{smi}]: {d['iters']} iterations (the stencil engine in 9c: "
          f"{st9c['cli']['detail']['iters']}), converged {d['converged']}, TRUE f64 rel "
          f"{d['rel_residual']:.3e} on the device, {rel_cpu:.3e} recomputed on the CPU, 80-bit "
          f"xprec {d['xprec_rel_residual']:.3e}; max vM {d['max_vm_mpa']} MPa (record "
          f"{ref['max_vm_mpa']}, rel {dvm:.2e}; 9c {vm9c}, rel {dvm9c:.2e}); largest u difference "
          f"from 9c {du:.3e} of max |u|; tip u_z {uz_tip:.4e} m, root vM {vm_root:.4e} vs tip "
          f"{vm_tip:.4e}; kernel N {counters['tet10_force'].launches} launches "
          f"({per_iter:.2f} per CG iteration); CLI wall {wall:.3f} s, solve {rec['value']} s, "
          f"timing {d['timing_s']}, peak device memory {d['peak_device_memory_bytes']} B",
          flush=True)
    require(d["converged"] and d["rel_residual"] <= 1e-5, f"gather flagship: {d}")
    require(rel_cpu <= 1e-5, f"gather flagship TRUE rel on the CPU {rel_cpu:.3e}")
    require(d["xprec_rel_residual"] <= 1e-5, f"gather flagship xprec {d['xprec_rel_residual']}")
    require(dvm <= 1e-3 and dvm9c <= 1e-3,
            f"gather flagship max vM {d['max_vm_mpa']} vs the record's {ref['max_vm_mpa']} and "
            f"9c's {vm9c}")
    require(uz_tip < 0 and vm_root > 3.0 * vm_tip and np.isfinite(u).all(),
            f"gather flagship physics: tip u_z {uz_tip:.3e}, root vM {vm_root:.3e}, tip "
            f"{vm_tip:.3e}")
    del extra, solver, out
    state["tet10_gather"] = {"cli": rec, "true_rel_cpu": rel_cpu, "u_diff_9c": du}

    # ---- 9i. solve_tet10_case at tpufem's test grid against Tet10MGSolver, f64
    case_res = WingMeshResolution(16, 16, 4, 0.006, "le")
    case_p4 = (1.4, 0.3, 15.0, 0.09)
    cmesh = structured_wing_mesh(*case_p4, case_res)
    cbs = build_boundary_sets(cmesh)
    ct10 = tet10_from_tet4(cmesh)
    t0 = time.perf_counter()
    u_c, _, it_c, rel_c, conv_c = solve_tet10_case(
        ct10, tet10_root_nodes(ct10), tet10_upper_t6(ct10, cbs.surf_upper_faces), PRESSURE,
        tol=1e-9, maxiter=8000, dtype=torch.float64, nj2=2 * case_res.n_span + 1, device=dev)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    mark("solve_tet10_case 16x16x4")
    t0 = time.perf_counter()
    mg = Tet10MGSolver(case_res, ct10, dtype=torch.float64, device=dev).solve(
        case_p4, cbs.surf_upper_faces, pressure=PRESSURE, tol=1e-9, maxiter=2000)
    torch.cuda.synchronize()
    wall_mg = time.perf_counter() - t0
    mark("Tet10MGSolver 16x16x4")
    du_c = float(np.abs(mg.u - u_c).max() / np.abs(u_c).max())
    print(f"[tet10 gather] 16x16x4 f64 tol 1e-9: solve_tet10_case (line + RBM two-level) "
          f"{it_c} iterations, rel {rel_c:.3e}, {wall_c:.3f} s; Tet10MGSolver {mg.iters} "
          f"iterations, rel {mg.rel_residual:.3e}, {wall_mg:.3f} s; largest u difference "
          f"{du_c:.3e} of max |u| (bar 1e-7) [{smi}]", flush=True)
    require(conv_c and mg.converged, f"16x16x4: case converged {conv_c}, p-MG {mg.converged}")
    require(du_c <= 1e-7, f"16x16x4: p-MG and two-level differ by {du_c:.3e}")
    require(mg.iters < it_c, f"16x16x4: p-MG {mg.iters} iterations, two-level {it_c}")

    state["peak_bytes"]["tet10 gather phase"] = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[tet10 gather] kernel launches (9h-9i): {launches}; by case {by_case}", flush=True)
    for name in ("tet10_force", "csr_segment_sum", "strain_apply"):
        require(launches[name] > 0, f"{name} was not launched on the tet10 gather path")

    rec32, rec64 = nrec["DOF1M_TET10"]["f32 masked"], nrec["DOF1M_TET10"]["f64 masked"]
    return {
        "name": "tet10_force", "route": "cuda", "source": pt.SOURCES["tet10_force"],
        "design": pt.DESIGNS["tet10_force"], "replaces": pt.REPLACES["tet10_force"],
        "kernel_letter": "N", "launches": launches["tet10_force"],
        "launches_by_case": {c: n["tet10_force"] for c, n in by_case.items()},
        "shape": "DOF1M_TET10 masked", "dtype": "f32",
        **{k: rec32[k] for k in ("max_abs_err", "ms", "plain_ms")},
        "bound_ms": rec32["bound_us"] / 1e3, "bound_by": rec32["bound_by"],
        "library_ms": rec32["library_ms"],
        "launches_per_call": rec32["launches"],
        **{k: rec32[k] for k in ("device_us", "device_us_cold", "share", "share_repeated",
                                 "activities", "bytes", "flops", "overlap", "blocks", "rows",
                                 "closure", "smem_bytes", "halo_nodes", "halo_rows", "halo_share",
                                 "tiles_us_cold", "halo_us_cold")},
        "ptxas": {k: list(v) for k, v in regs.items()},
        "f64": {k: rec64[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_us", "bound_by",
                                      "device_us", "device_us_cold", "share", "library_ms",
                                      "smem_bytes", "tiles_us_cold", "halo_us_cold")},
        "shapes": {lbl: {k: {f: r.get(f) for f in ("grid", "T", "N", "overlap", "blocks",
                                                   "rows", "smem_bytes", "halo_share",
                                                   "max_abs_err",
                                                   "err_vs_f64", "plain_err_vs_f64", "ms",
                                                   "plain_ms", "bound_us", "bound_by",
                                                   "device_us", "device_us_cold", "share",
                                                   "library_ms", "library_device_us")}
                         for k, r in rs.items()}
                   for lbl, rs in nrec.items()}}


# ---------------------------------------------------------------- phase 10


TWOLEVEL_CASES = 4  # phase 10f: phase 5's first wings again, through --engine twolevel
O_SOURCE = "tpufem_torch/csrc/tet4_force_t.cu"
O_REPLACES = "tpufem/fem/multigrid.py:265"
O_HEADLINE = "DOF100K level 0 64x80x6 f64 masked"


def batched_counters():
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.ops import csr_segment_sum as cs

    return {"stiffness_apply_t": asm.stiffness_apply_t, "stiffness_apply": asm.stiffness_apply,
            "strain_apply": st.strain_apply, "csr_segment_sum": cs.csr_segment_sum}


def max_rel(a, b):
    """max |a - b| over max |b|, both as f64 numpy."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def run_batched_engine(dev, state, smi):
    """Phase 10, the second batched engine on phase 3's batch (B = 8, 5 kPa):
    (a) kernel O against its plain version at every level of DOF100K's
    V-cycle but the coarsest and at COARSE B = 3 (f64 1e-12, f32 1e-5 of the
    plain f32 version, masked and unmasked, bitwise repeat, exactly 1 launch
    and 1 device activity per apply, event / plain / device times, bound);
    then, launch counters zeroed, (b) WingBatchT(DOF100K, float64,
    mg_levels=None) and the stencil engine (outer_f64) at tol 1e-7, both
    converged, TRUE f64 rel <= 2e-7 on the CPU, u within 1e-5; (c) at MEDIUM
    the two-level and the multigrid WingBatchT, f64, tol 1e-6, converged, the
    two-level in more iterations, u within 1e-4; (d) WingBatchT(DOF100K,
    float32, mg_levels=None) at tol 1e-6, converged, tip u_z < 0, u within
    1e-2 of (b)'s; (e) WingStencilT.solve(refine_steps=4, inner_tol=1e-3):
    TRUE rel <= 1e-6 on the CPU in every lane, u within 1e-4 of phase 3's;
    the f32-only branch (printed); (f) the verify_stencil_solver CLI, and
    generate_fem_dataset --engine twolevel on phase 5's first wings (reports
    success, surface displacement within 1e-4 of the stencil engine's; the
    vm gap printed). Returns kernel O's entry of the kernels' line."""
    from tpufem_torch import profile_batched as pb
    from tpufem_torch.fem.batched_t import WingBatchT
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.mesher import DOF100K, MEDIUM
    from tpufem_torch.pipeline.config import get_paths
    from tpufem_torch.scripts import generate_fem_dataset, verify_stencil_solver

    lam, mu = lame_params(Material())
    p4 = state["p4"]
    solver = state["solver"]
    bt = solver.bt
    upper, free = bt.upper.cpu().numpy(), bt.free64.cpu().numpy()

    def true_rel(u):
        return true_residual_cpu(DOF100K, p4, u.detach().double().cpu(), upper, free, lam, mu)

    # ---- 10a. kernel O at each shape it runs at, against its plain version
    from tpufem_torch.ops.kernels import build_info

    o_regs = pb.o_registers(build_info.get("log", ""))
    print(f"[kernel O] {smi}; ptxas (registers, spill stores, spill loads): {o_regs}", flush=True)
    require({k.split()[0] for k in o_regs} == {"f32", "f64"},
            f"10a: no ptxas report of kernel O: {o_regs}")
    orec = {}
    for label, res, batch in pb.cases(p4):
        for r in pb.measure(label, res, batch, dev, lam, mu):
            key = f"{label} {r['dtype']} {'masked' if r['masked'] else 'unmasked'}"
            require(r["launches"] == 1 and r["activities"] == 1,
                    f"kernel O {key}: {r['launches']} launches and {r['activities']} device "
                    f"activities per apply, not 1")
            orec[key] = r
        for dtype in ("f64", "f32"):
            for mask in ("masked", "unmasked"):
                require(f"{label} {dtype} {mask}" in orec,
                        f"10a: kernel O was not checked at {label} {dtype} {mask}")

    counters = batched_counters()
    for c in counters.values():
        c.launches = 0
    by_step = {}

    def mark(step):
        by_step[step] = {n: c.launches - sum(v[n] for v in by_step.values())
                         for n, c in counters.items()}
        return by_step[step]

    torch.cuda.reset_peak_memory_stats()
    # ---- 10b. the multigrid WingBatchT against the stencil engine, f64, tol 1e-7
    t0 = time.perf_counter()
    mg64 = WingBatchT(DOF100K, dtype=torch.float64, mg_levels=None, device=dev)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_mg = mg64.solve(p4, pressure=PRESSURE, tol=1e-7, maxiter=2000)
    torch.cuda.synchronize()
    wall_mg = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_st = solver.solve(p4, pressure=PRESSURE, tol=1e-7, maxiter=2000, outer_f64=True)
    torch.cuda.synchronize()
    wall_st = time.perf_counter() - t0
    launches = mark("10b DOF100K f64 multigrid + stencil")
    rel_mg, rel_st = true_rel(out_mg.u), true_rel(out_st.u)
    gap = max_rel(out_mg.u.cpu(), out_st.u.cpu())
    print(f"[batched] 10b WingBatchT(DOF100K, float64, mg_levels=None), {len(mg64.mg.levels)} "
          f"levels: init {init_s:.3f} s, solve {wall_mg:.3f} s, {out_mg.iters} iterations, "
          f"recurred rel max {float(out_mg.rel_residual.max()):.3e}, TRUE f64 rel on the CPU max "
          f"{rel_mg.max():.3e}; stencil engine (outer_f64) {wall_st:.3f} s, {out_st.iters} "
          f"iterations, TRUE rel max {rel_st.max():.3e}; u gap {gap:.3e} of max |u| (bar 1e-5); "
          f"launches {launches} [{smi}]", flush=True)
    require(bool(out_mg.converged.all()) and bool(out_st.converged.all()),
            f"10b: converged {out_mg.converged.tolist()} / {out_st.converged.tolist()}")
    require(max(rel_mg.max(), rel_st.max()) <= 2e-7, f"10b: TRUE rel {rel_mg} / {rel_st}")
    require(gap <= 1e-5, f"10b: the engines differ by {gap:.3e}")
    require(launches["stiffness_apply_t"] > 0, "10b: kernel O was not launched")

    # ---- 10c. the two-level against the multigrid WingBatchT at MEDIUM, f64, tol 1e-6
    outs = {}
    for name, levels in (("two-level", 0), ("multigrid", None)):
        t0 = time.perf_counter()
        outs[name] = WingBatchT(MEDIUM, dtype=torch.float64, mg_levels=levels, device=dev).solve(
            p4, pressure=PRESSURE, tol=TOL, maxiter=20000)
        torch.cuda.synchronize()
        outs[name + " s"] = time.perf_counter() - t0
    launches = mark("10c MEDIUM f64 two-level + multigrid")
    two, mgm = outs["two-level"], outs["multigrid"]
    gap_c = max_rel(two.u.cpu(), mgm.u.cpu())
    print(f"[batched] 10c MEDIUM B={len(p4)} f64 tol {TOL}: two-level {two.iters} iterations "
          f"({outs['two-level s']:.3f} s), multigrid {mgm.iters} ({outs['multigrid s']:.3f} s); "
          f"u gap {gap_c:.3e} (bar 1e-4); launches {launches}", flush=True)
    require(bool(two.converged.all()) and bool(mgm.converged.all()), "10c: not converged")
    require(two.iters > mgm.iters, f"10c: two-level {two.iters}, multigrid {mgm.iters}")
    require(gap_c <= 1e-4, f"10c: two-level and multigrid differ by {gap_c:.3e}")
    # phase 14's references: 10b's solver and solve, 10c's f64 two-level u
    state["batched"] = {"mg64": mg64, "out_mg": out_mg, "medium_two_u": two.u}

    # ---- 10d. the f32 multigrid WingBatchT at DOF100K (tpufem's verify drive), tol 1e-6
    t0 = time.perf_counter()
    out32 = WingBatchT(DOF100K, dtype=torch.float32, mg_levels=None, device=dev).solve(
        p4, pressure=PRESSURE, tol=TOL, maxiter=2000)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    launches = mark("10d DOF100K f32 multigrid")
    u32 = out32.u.cpu().numpy()
    rel32 = true_rel(out32.u)
    gaps32 = [max_rel(u32[:, :, k], out_mg.u[:, :, k].cpu()) for k in range(len(p4))]
    nodes32 = out32.nodes.cpu().numpy()
    uz_tip = [float(u32[nodes32[:, 1, k] > 0.9 * float(p4[k, 0]), 2, k].mean())
              for k in range(len(p4))]
    print(f"[batched] 10d WingBatchT(DOF100K, float32, mg_levels=None) tol {TOL}: "
          f"{wall32:.3f} s, {out32.iters} iterations, converged {out32.converged.tolist()}, "
          f"recurred rel max {float(out32.rel_residual.max()):.3e}; TRUE f64 rel per lane "
          f"{[f'{r:.3e}' for r in rel32]}; u gap to 10b per lane {[f'{g:.3e}' for g in gaps32]} "
          f"(bar 1e-2); tip u_z {[f'{z:.3e}' for z in uz_tip]}; launches {launches}", flush=True)
    require(bool(out32.converged.all()), f"10d: converged {out32.converged.tolist()}")
    require(max(uz_tip) < 0, f"10d: tip u_z {uz_tip}")
    require(max(gaps32) <= 1e-2, f"10d: u gap {gaps32}")

    # ---- 10e. WingStencilT.solve's refine branch (bench.py --mode refine), and the f32 CG
    t0 = time.perf_counter()
    ref = solver.solve(p4, pressure=PRESSURE, tol=TOL, maxiter=2000, refine_steps=4,
                       inner_tol=1e-3)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    rel_ref = true_rel(ref.u)
    gap_ref = max_rel(ref.u.cpu(), state["out"].u.cpu())
    t0 = time.perf_counter()
    f32 = solver.solve(p4, pressure=PRESSURE, tol=TOL, maxiter=2000)
    torch.cuda.synchronize()
    wall_f32 = time.perf_counter() - t0
    launches = mark("10e stencil refine + f32-only")
    rel_f32 = true_rel(f32.u)
    print(f"[stencil] 10e refine_steps=4 inner_tol=1e-3: {wall_ref:.3f} s, {ref.iters} "
          f"iterations, TRUE f64 rel (solver) max {float(ref.rel_residual.max()):.3e}, on the CPU "
          f"{[f'{r:.3e}' for r in rel_ref]} (bar {TOL}); u gap to phase 3 {gap_ref:.3e} (bar 1e-4)"
          f"; f32-only CG: {wall_f32:.3f} s, {f32.iters} iterations, recurred rel "
          f"{[f'{r:.3e}' for r in f32.rel_residual.tolist()]}, TRUE f64 rel "
          f"{[f'{r:.3e}' for r in rel_f32]}; launches {launches} [{smi}]", flush=True)
    require(rel_ref.max() <= TOL, f"10e: refine TRUE rel {rel_ref}")
    require(gap_ref <= 1e-4, f"10e: refine differs from phase 3 by {gap_ref:.3e}")
    require(launches["strain_apply"] > 0, "10e: kernel B was not launched")

    # ---- 10f. the CLIs
    t0 = time.perf_counter()
    require(verify_stencil_solver.main(["--device", "cuda"]) == 0, "verify_stencil_solver failed")
    wall_verify = time.perf_counter() - t0
    mark("10f verify_stencil_solver")
    root = state["segment"].pop("data_copy")
    try:
        paths = get_paths(str(root))
        ids = [f"{i:03d}" for i in range(1, TWOLEVEL_CASES + 1)]
        stencil = {c: dict(np.load(paths.fem_case(c) / "surface_results.npz")) for c in ids}
        t0 = time.perf_counter()
        rc = generate_fem_dataset.main(["--batched", "--engine", "twolevel", "--limit",
                                        str(TWOLEVEL_CASES), "--no_glb", "--force", "--device",
                                        "cuda", "--data_root", str(root)])
        wall_two = time.perf_counter() - t0
        launches = mark("10f generate_fem_dataset --engine twolevel")
        reps = [json.loads((paths.fem_case(c) / "fem_report.json").read_text()) for c in ids]
        retried = [r["case_id"] for r in reps if "batched_lane_failure" in r["extra"]]
        two = {c: np.load(paths.fem_case(c) / "surface_results.npz") for c in ids}
        gaps_u = [max_rel(two[c]["disp"], stencil[c]["disp"]) for c in ids]
        gaps_vm = [max_rel(two[c]["stress_vm"], stencil[c]["stress_vm"]) for c in ids]
        print(f"[batched] 10f verify_stencil_solver {wall_verify:.3f} s; generate_fem_dataset "
              f"--engine twolevel on {TWOLEVEL_CASES} DOF100K wings: rc {rc}, {wall_two:.3f} s, "
              f"statuses {[r['status'] for r in reps]}, through the retry queue {len(retried)} "
              f"{retried}, engines {[r['extra'].get('engine') for r in reps]}, iterations "
              f"{[r['extra'].get('solver', {}).get('iters') for r in reps]}; gaps to the stencil "
              f"engine's artifacts: disp {[f'{g:.3e}' for g in gaps_u]} (bar 1e-4), vm "
              f"{[f'{g:.3e}' for g in gaps_vm]} (no bar: the f32 engine's stress near the LE sits "
              f"~12% off the f64 solution in tpufem too, tests/probe_twolevel_f32_stress.py); "
              f"launches {launches}", flush=True)
        require(rc == 0 and all(r["status"] == "success" for r in reps),
                f"10f: twolevel dataset {[r['status'] for r in reps]}")
        require(max(gaps_u) <= 1e-4, f"10f: disp gap {gaps_u}")
        require(launches["stiffness_apply"] > 0, "10f: kernel D was not launched")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    state["peak_bytes"]["second batched engine phase"] = torch.cuda.max_memory_allocated()
    total = {n: sum(v[n] for v in by_step.values()) for n in counters}
    print(f"[batched] kernel launches (10b-10f): {total}", flush=True)
    require(total["stiffness_apply_t"] > 0, "kernel O was not launched in phase 10")

    rec64, rec32 = orec[O_HEADLINE], orec[O_HEADLINE.replace("f64", "f32")]
    keys = ("device_us", "device_us_cold", "share", "share_repeated", "activities", "bound_us",
            "bound_by", "max_abs_err", "err_vs_plain", "ms", "plain_ms", "overlap", "tile",
            "tiles", "blocks", "group", "ghost_share", "halo_share", "rows",
            "nodes", "closure", "smem", "plan_bytes", "T", "N", "B")
    return {
        "name": "stiffness_apply_t", "route": "cuda", "source": O_SOURCE, "replaces": O_REPLACES,
        "kernel_letter": "O", "launches": total["stiffness_apply_t"],
        "launches_by_step": {k: v["stiffness_apply_t"] for k, v in by_step.items()},
        "shape": O_HEADLINE, "dtype": "f64",
        **{k: rec64[k] for k in ("max_abs_err", "ms", "plain_ms")},
        "bound_ms": rec64["bound_us"] / 1e3, "bound_by": rec64["bound_by"], "library_ms": None,
        **{k: rec64[k] for k in keys},
        "f32": {k: rec32[k] for k in keys}, "ptxas": {k: list(v) for k, v in o_regs.items()},
        "shapes": {k: {f: r[f] for f in keys} for k, r in orec.items()},
    }


# ---------------------------------------------------------------- phase 12

P12_TIMEOUT = 600.0  # seconds a spawn of phase 12 (and each of its collectives) may take
P12_TET10_RES = (32, 40, 4)  # 12c: the tet10 modal CLI's grid
P12_WING_DRYRUN = (12, 5, 2)  # the halo solves of the dry run at 2 ranks (12 x (2n+1) x 2)
TPUFEM_SHARDED_RECORD = REPO / "results" / "sharded_tet10_2p5mdof_cpu_mesh.json"
# each wrapper's line in the kernels' JSON
P12_KERNELS = ("strain_apply", "strain_apply10", "prolong_p", "restrict_p", "stiffness_apply",
               "tet10_force", "csr_segment_sum")


def check_exchange_values(outs, world):
    """Phase 12's exchange check: every rank's comm.check_exchanges result
    against the values its collectives must give (as tests/test_torch_parallel.py)."""
    base = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    slabs = [base + 100.0 * d for d in range(world)]
    full = np.concatenate([s[..., :-1] for s in slabs[:-1]] + [slabs[-1]], axis=-1)
    for d, o in enumerate(outs):
        want = slabs[d].copy()
        if d + 1 < world:
            want[..., -1] += slabs[d + 1][..., 0]
        if d > 0:
            want[..., 0] += slabs[d - 1][..., -1]
        require(np.array_equal(o["sync"], want) and np.array_equal(o["full"], full)
                and np.array_equal(o["sum"], [world, sum(range(world))])
                and np.array_equal(o["raw_sum"], [world * (world + 1) / 2] * 2),
                f"12: rank {d} of {world}: the exchanges gave wrong values")


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def slab_kernel_checks(dev, p4w, lam, mu):
    """Kernels B, L, M at the slab shapes phase 12 launches them with (rank
    1's slab at 2 ranks: its span end faces are not the root), and D, N, E
    on a halo-extended local mesh (rank 0 of the dry run's halo solves at 2
    ranks), each against its plain version on the same inputs in f64, the
    dtype phase 12 runs (1e-12 of the largest entry; M 1e-14; the same bits
    twice; one count a call),
    with event, device and plain times and the bound (profile_tet10.check_and_time)."""
    from tpufem_torch import profile_tet10 as pt
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem import tet10 as tt10
    from tpufem_torch.fem import tet10_stencil as ts
    from tpufem_torch.fem.assembly import build_incidence, stiffness_apply, stiffness_apply_plain
    from tpufem_torch.fem.elements import tet4_setup
    from tpufem_torch.mesher import DOF100K, DOF1M_TET10, WingMeshResolution
    from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum, csr_segment_sum_plain
    from tpufem_torch.parallel.halo_pcg import build_halo_partition, extended_nodes
    from tpufem_torch.parallel.shard_stencil import slab_res, slab_yfrac

    recs = {}
    tols = {torch.float64: 1e-12, torch.float32: 1e-5}

    def rand(shape, dtype, seed, scale=1e-3):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64).to(dtype) * scale

    # B on rank 1's DOF100K slab at 2 ranks (3,1,65,7,41)
    c = DOF100K.n_span // 2
    rs = slab_res(DOF100K, c)
    p4t = torch.tensor([p4w], dtype=torch.float64, device=dev)
    X = st.nodes_grid(DOF100K, p4t, torch.float64, yfrac=slab_yfrac(1, c, DOF100K.n_span))
    for dt in (torch.float64,):  # the dtype phase 12 launches it in
        geo = tuple(t.to(dt) for t in st.cell_geometry(rs, X))
        u = rand(X.shape, dt, 3)
        free = torch.ones((1, 1, 1, 1, c + 1), dtype=dt, device=dev)
        label = f"phase 12 DOF100K slab 64x{c}x6 of 2 ranks"
        recs.setdefault("strain_apply", {})[f"{label} {pt.DTYPE_NAMES[dt]}"] = {
            **pt.check_and_time("strain_apply", label,
                                lambda: st.strain_apply(rs, geo, u, free, lam, mu),
                                lambda: st.strain_apply_plain(rs, geo, u, free, lam, mu),
                                tols[dt], pt.nbytes(geo[0], geo[1], u, free) + pt.nbytes(u), 0,
                                dt), "grid": list(u.shape)}
    # L and M on rank 1's flagship slab at 2 ranks (3,1,193,17,129)
    c = DOF1M_TET10.n_span // 2
    rs10 = slab_res(DOF1M_TET10, c)
    p4f = torch.tensor([pt.FLAGSHIP_P4], dtype=torch.float64, device=dev)
    X2 = ts.nodes_grid2(DOF1M_TET10, p4f, torch.float64,
                        yfrac=slab_yfrac(1, c, DOF1M_TET10.n_span))
    geo64 = ts.cell_geometry2(rs10, X2)
    n_tets = 6 * rs10.n_chord * rs10.n_thick * rs10.n_span
    label = f"phase 12 DOF1M_TET10 slab 96x{c}x8 of 2 ranks"
    for dt in (torch.float64,):  # the dtype phase 12 launches them in
        d = pt.DTYPE_NAMES[dt]
        geo = tuple(t.to(dt) for t in geo64)
        u2 = rand(X2.shape, dt, 4)
        free2 = torch.ones((1, 1, 1, 1, 2 * c + 1), dtype=dt, device=dev)
        dup2 = ts.dup_mask2(DOF1M_TET10, dt, dev)[..., : 2 * c + 1].contiguous()
        recs.setdefault("strain_apply10", {})[f"{label} {d}"] = {
            **pt.check_and_time("strain_apply10", label,
                                lambda: ts.strain_apply10(rs10, geo, u2, free2, lam, mu),
                                lambda: ts.strain_apply10_plain(rs10, geo, u2, free2, lam, mu),
                                tols[dt], pt.nbytes(u2, geo[0][:, 1:], geo[1], free2)
                                + pt.nbytes(u2), pt.l_flops_per_tet() * n_tets, dt),
            "grid": list(u2.shape)}
        x4 = rand((3, 1, rs10.n_chord + 1, rs10.n_thick + 1, c + 1), dt, 5)
        free4 = torch.ones((1, 1, 1, 1, c + 1), dtype=dt, device=dev)
        recs.setdefault("prolong_p", {})[f"{label} {d}"] = {
            **pt.check_and_time("prolong_p", label,
                                lambda: ts.prolong_p(rs10, x4, dup2, free2),
                                lambda: ts.prolong_p_plain(rs10, x4, dup2, free2), pt.M_TOL[dt],
                                pt.nbytes(x4, dup2, free2) + pt.nbytes(u2), 0, dt),
            "grid": list(x4.shape)}
        recs.setdefault("restrict_p", {})[f"{label} {d}"] = {
            **pt.check_and_time("restrict_p", label,
                                lambda: ts.restrict_p(rs10, u2, free4),
                                lambda: ts.restrict_p_plain(rs10, u2, free4), pt.M_TOL[dt],
                                pt.nbytes(u2, free4) + pt.nbytes(x4), 0, dt),
            "grid": list(u2.shape)}
    del geo64, X2
    # D, N and E on rank 0's extended mesh of the dry run's halo solves (2 ranks)
    res = WingMeshResolution(*P12_WING_DRYRUN)
    for element in ("tet4", "tet10"):
        part = build_halo_partition(res, 2, 1.2, 0.35, 10.0, 0.10, dtype=np.float64,
                                    element=element)
        n_el = int(part.elem_mask[0].sum())
        elems_h = part.elems[0, :n_el]
        nodes = torch.as_tensor(extended_nodes(part, 0), device=dev)
        n_ext = nodes.shape[0]
        elems = torch.as_tensor(elems_h, device=dev).contiguous()
        x = rand((n_ext, 3), torch.float64, 6)
        label = f"phase 12 halo {element} {res.n_chord}x{res.n_span}x{res.n_thick} rank 0 of 2"
        if element == "tet4":
            grads, vols = tet4_setup(nodes, elems.long())
            plan = build_incidence(elems_h, n_ext, dev)
            recs.setdefault("stiffness_apply", {})[f"{label} f64"] = {
                **pt.check_and_time(
                    "stiffness_apply", label,
                    lambda: stiffness_apply(grads, vols, elems, x, lam, mu, plan),
                    lambda: stiffness_apply_plain(grads, vols, elems, x, lam, mu, plan), 1e-12,
                    pt.nbytes(grads, vols, elems, x) + pt.nbytes(x), 0, torch.float64),
                "T": n_el, "N": n_ext}
        else:
            Jinv, vols = tt10.tet10_setup(nodes, elems)
            mesh = tt10.Tet10Mesh(mesh4=None, tet10=elems_h.astype(np.int64),
                                  edge_endpoints=np.zeros((0, 2)), surf_t6=np.zeros((0, 6)),
                                  num_nodes=n_ext)
            plan = tt10.force_plan(mesh, dev)
            recs.setdefault("tet10_force", {})[f"{label} f64"] = {
                **pt.check_and_time(
                    "tet10_force", label,
                    lambda: tt10.tet10_force(Jinv, vols, elems, x, lam, mu, n_ext, plan=plan),
                    lambda: tt10.tet10_force_plain(Jinv, vols, elems, x, lam, mu, plan), 1e-12,
                    pt.nbytes(Jinv, vols, elems, x) + pt.nbytes(x), 0, torch.float64,
                    per_call=2), "T": n_el, "N": n_ext}
            gplan = csr_plan(part.node_group[0].astype(np.int64), part.n_groups, dev)
            vals = rand((part.n_max, 6), torch.float64, 7)
            label = f"phase 12 halo {element} RBM group sum C=6 rank 0 of 2"
            recs.setdefault("csr_segment_sum", {})[f"{label} f64"] = {
                **pt.check_and_time("csr_segment_sum", label,
                                    lambda: csr_segment_sum(vals, gplan),
                                    lambda: csr_segment_sum_plain(vals, gplan), 1e-12,
                                    pt.nbytes(vals) + 6 * 8 * part.n_groups, 0, torch.float64),
                "rows": part.n_max, "segments": part.n_groups}
    for name, by_shape in recs.items():
        for key, r in by_shape.items():
            print(f"[kernel {name}] {key}: max|err| {r['max_abs_err']:.3e} (rel "
                  f"{r['rel_err']:.2e}), bitwise repeatable; event {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, device {r['device_us']:.2f} us "
                  f"({r['device_us_cold']:.2f} flushed), bound {r['bound_us']:.2f} us "
                  f"({r['bound_by']})", flush=True)
    return recs


def run_multi_device(dev, state, smi):
    """Phase 12, the multi-device path (tpufem_torch.parallel), through
    run_ranks: 12a WingStencilT(DOF100K, dtype=float64) on wing 0 of the
    seeded batch, tol 1e-8 (the f64 MG-PCG the sharded solve is held to),
    TRUE rel on the CPU <= 1e-6 (its recurrence reaches 1e-8; its TRUE
    residual floors near 3.5e-7 at DOF100K whatever the tol: 3.49e-7 at tol
    1e-8 and 1e-10 on the CPU); 12b the sharded tet4 solve of the same wing
    at NCCL world 1 and gloo worlds 2 and 4 on the one card (u within 1e-8
    of 12a, iterations within 2, TRUE rel within 10 % of 12a's); 12c
    tet10 at 32x40x4, gloo world 2, against Tet10StencilT(float64) (u within
    1e-8, iterations within 2); 12d sharded_flagship at DOF1M_TET10, gloo
    world 2, f64, tol 1e-6 (converged on its recurrence, TRUE rel on the CPU
    <= 1e-5, the flagship's certified bar: the plain f64 CG's TRUE residual
    sits above its recurrence, 2.7e-6 at a recurred 9.0e-7); 12e 3 DP steps
    with the full-width GraphSAGE on 4 of phase 5's graphs at NCCL world 1
    and gloo world 2 (the first step's loss within 1e-6 and its params within
    1e-5 of the single-process step, the loss falling over the 3); 12f the
    dry run at gloo world 2. Every rank's kernel launches are counted from 0 in its
    step. Then kernels B, L, M, D, N and E at the slab and extended-mesh
    shapes against their plain versions. Returns ({wrapper: launches},
    {wrapper: {shape: record}})."""
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.stencil_mg import WingStencilT
    from tpufem_torch.fem.tet10 import tet10_upper_t6
    from tpufem_torch.fem.tet10_stencil import Tet10StencilT, grid_meta2
    from tpufem_torch.mesher import DOF100K, DOF1M_TET10, WingMeshResolution, structured_wing_mesh
    from tpufem_torch.models.sage import SAGEConfig
    from tpufem_torch.parallel.comm import check_exchanges
    from tpufem_torch.parallel.data_parallel import dp_train
    from tpufem_torch.parallel.launch import counted, kernel_counters, run_all, run_ranks
    from tpufem_torch.parallel.meshes import DeviceGroup
    from tpufem_torch.parallel.shard_stencil import sharded_solve
    from tpufem_torch.scripts import sharded_flagship
    from tpufem_torch.scripts.dryrun_multichip import dryrun_multichip, params_gap, stacked_graphs
    from tpufem_torch import profile_tet10 as pt
    from tpufem_torch.sets import build_boundary_sets

    lam, mu = lame_params(Material())
    walls, total = {}, {}
    p4w = tuple(float(v) for v in state["p4"][0])
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t_phase = time.perf_counter()

    # ---- 12a. the single-device f64 reference
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    ws = WingStencilT(DOF100K, dtype=torch.float64)
    ref = ws.solve(np.array([p4w]), pressure=PRESSURE, tol=1e-8, maxiter=2000)
    torch.cuda.synchronize()
    walls["12a"] = time.perf_counter() - t0
    add_launches(total, {k: f.launches for k, f in counters.items()})
    upper, free = ws.bt.upper.cpu().numpy(), ws.bt.free64.cpu().numpy()
    u_a = ref.u[:, :, 0].cpu().numpy()
    rel_a = float(true_residual_cpu(DOF100K, np.array([p4w]), ref.u.cpu(), upper, free, lam,
                                    mu)[0])
    print(f"[multi] 12a WingStencilT({DOF100K.key}, float64) wing 0 tol 1e-8: {ref.iters} "
          f"iterations, converged {bool(ref.converged.all())}, recurred rel "
          f"{float(ref.rel_residual[0]):.3e}, TRUE rel on the CPU {rel_a:.3e} (bar {TOL}: the "
          f"f64 CG's TRUE residual floors near 3.5e-7 here whatever its tol); "
          f"{walls['12a']:.3f} s, timing {ws.last_timing} [{smi}]", flush=True)
    require(bool(ref.converged.all()) and rel_a <= TOL, f"12a: rel {rel_a:.3e}")
    scale_a = np.abs(u_a).max()
    del ws

    # ---- 12b, 12c, 12e in one spawn per (backend, world)
    tet4 = (counted, (sharded_solve, DOF100K, "tet4", torch.float64, p4w, PRESSURE, 1e-8, 2000))
    res_c = WingMeshResolution(*P12_TET10_RES, 0.006, "le")
    tet10 = (counted, (sharded_solve, res_c, "tet10", torch.float64, p4w, PRESSURE, 1e-8, 600))
    graphs = stacked_graphs(state["segment"]["dp_graphs"])
    cfg = SAGEConfig()
    dp3 = (counted, (dp_train, cfg, graphs, 3, 0))
    plans = {("nccl", 1): [(check_exchanges, ()), tet4, dp3],
             ("gloo", 2): [(check_exchanges, ()), tet4, tet10, dp3],
             ("gloo", 4): [(check_exchanges, ()), tet4]}
    runs = {}
    for (backend, world), calls in plans.items():
        t0 = time.perf_counter()
        runs[(backend, world)] = run_ranks(run_all, world, backend, "cuda", args=(calls,),
                                           timeout_s=P12_TIMEOUT)
        walls[f"12b {backend} {world}"] = time.perf_counter() - t0
        outs = runs[(backend, world)]
        check_exchange_values([o[0] for o in outs], world)
        for o in outs:
            for r in o[1:]:
                add_launches(total, r["launches"])
        ranks = [o[1]["out"] for o in outs]
        r0 = ranks[0]
        tm = [r["timing"] for r in ranks]
        rel_b = float(true_residual_cpu(DOF100K, np.array([p4w]),
                                        torch.as_tensor(r0["u"][:, :, None]), upper, free,
                                        lam, mu)[0])
        du = np.abs(r0["u"] - u_a).max() / scale_a
        print(f"[multi] 12b sharded tet4 {DOF100K.key} {backend} world {world} on one card: "
              f"n_shard {r0['n_shard']}, cells {r0['cells']}; {r0['iters']} iterations (12a "
              f"{ref.iters}), recurred rel {r0['rel']:.3e}, TRUE rel on the CPU {rel_b:.3e} (bar: "
              f"within 10% of 12a's {rel_a:.3e}), max|u - u_12a| / max|u_12a| {du:.3e} (bar "
              f"1e-8); per rank: setup "
              f"{[round(t['setup_s'], 3) for t in tm]} s, solve "
              f"{[round(t['solve_s'], 3) for t in tm]} s, "
              f"{[round(1e3 * t['solve_s'] / max(r0['iters'], 1), 3) for t in tm]} ms per CG "
              f"iteration, exchange share "
              f"{[round(t['exchange_solve_s'] / t['solve_s'], 4) for t in tm]} "
              f"({tm[0]['exchange_calls']} exchange calls); launches rank 0 "
              f"{outs[0][1]['launches']}; spawn wall {walls[f'12b {backend} {world}']:.3f} s "
              f"[{smi}]", flush=True)
        require(all(r["iters"] == r0["iters"] and np.array_equal(r["u"], r0["u"]) for r in ranks),
                f"12b {backend} {world}: the ranks disagree")
        require(abs(r0["iters"] - ref.iters) <= 2 and du <= 1e-8 and rel_b <= 1.1 * rel_a,
                f"12b {backend} {world}: iters {r0['iters']}, du {du:.3e}, rel {rel_b:.3e}")
        require(outs[0][1]["launches"]["strain_apply"] > 0, "12b: kernel B was not launched")
    # 12c
    wm = structured_wing_mesh(*p4w, res_c)
    bs = build_boundary_sets(wm)
    t10ref = Tet10StencilT(res_c, dtype=torch.float64).solve(
        np.array([p4w]), bs.surf_upper_faces, pressure=PRESSURE, tol=1e-8, maxiter=600)
    c_out = runs[("gloo", 2)][0][2]
    rc = c_out["out"]
    u10 = t10ref.u[:, :, 0]
    du = np.abs(rc["u"] - u10).max() / np.abs(u10).max()
    print(f"[multi] 12c sharded tet10 {res_c.key} gloo world 2: {rc['iters']} iterations "
          f"(Tet10StencilT float64: {t10ref.iters}), rel {rc['rel']:.3e}, max|u - u_ref| / "
          f"max|u_ref| {du:.3e} (bar 1e-8); solve {rc['timing']['solve_s']:.3f} s, exchange "
          f"share {rc['timing']['exchange_solve_s'] / rc['timing']['solve_s']:.4f}; launches "
          f"{c_out['launches']}", flush=True)
    require(rc["rel"] <= 1e-8 and abs(rc["iters"] - t10ref.iters) <= 2 and du <= 1e-8,
            f"12c: iters {rc['iters']} vs {t10ref.iters}, du {du:.3e}")
    require(c_out["launches"]["strain_apply10"] > 0 and c_out["launches"]["restrict_p"] > 0
            and c_out["launches"]["prolong_p"] > 0, "12c: kernels L and M were not launched")

    # ---- 12e. the DP step against the single-process step (this process, world 1)
    t0 = time.perf_counter()
    single = dp_train(DeviceGroup(0, 1, "nccl", dev), cfg, graphs, steps=1, seed=0)
    for key in (("nccl", 1), ("gloo", 2)):
        three = runs[key][0][-1]
        losses = three["out"]["losses"]
        gap = params_gap(three["out"]["params_step1"], single["params"])
        dl = abs(losses[0] - single["losses"][0]) / abs(single["losses"][0])
        print(f"[multi] 12e DP steps, full-width GraphSAGE on 4 DOF100K graphs, {key[0]} world "
              f"{key[1]}: step 1 loss {losses[0]:.7f} vs single-process "
              f"{single['losses'][0]:.7f} (rel {dl:.2e}, bar 1e-6), params after it within "
              f"{gap:.2e} (bar 1e-5); 3 steps {losses}, params after them within "
              f"{params_gap(three['out']['params'], single['params']):.2e} of the single "
              f"step's (information); launches on rank 0 {three['launches']}", flush=True)
        require(dl <= 1e-6 and gap <= 1e-5, f"12e {key}: loss rel {dl:.2e}, params {gap:.2e}")
        require(losses[-1] < losses[0], f"12e {key}: the loss did not fall: {losses}")
        require(three["launches"]["gather_row_sum"] > 0, "12e: kernel A entry (b) not launched")
    walls["12e single-process step"] = time.perf_counter() - t0

    # ---- 12d. the sharded flagship CLI, gloo world 2 on the card
    t0 = time.perf_counter()
    rec, r0 = sharded_flagship.run(["--ranks", "2", "--backend", "gloo", "--device", "cuda",
                                    "--out", str(REPO / "build" / "sharded_tet10_2p5mdof.json")])
    walls["12d flagship"] = time.perf_counter() - t0
    d = rec["detail"]
    t10 = grid_meta2(DOF1M_TET10)["t10"]
    fw = structured_wing_mesh(*pt.FLAGSHIP_P4, DOF1M_TET10)
    ut6 = tet10_upper_t6(t10, build_boundary_sets(fw).surf_upper_faces)
    rel_d = tet10_true_residual_cpu(DOF1M_TET10, pt.FLAGSHIP_P4, r0["u"][:, :, None], ut6, lam,
                                    mu)
    u9 = np.asarray(state["tet10"]["u"])
    du9 = np.abs(r0["u"] - u9).max() / np.abs(u9).max()
    tp_iters = json.loads(TPUFEM_SHARDED_RECORD.read_text())["detail"]["iters"]
    print(f"[multi] 12d sharded_flagship {DOF1M_TET10.key} ({d['dof']} DOF) gloo world 2 on "
          f"{d['card']}: {d['iters']} iterations beside tpufem's {tp_iters} (8 CPU devices, "
          f"results/sharded_tet10_2p5mdof_cpu_mesh.json), converged {d['converged']}, recurred "
          f"rel {d['rel_residual']:.3e}, TRUE rel on the CPU {rel_d:.3e} (bar 1e-5, the "
          f"flagship's certified bar; a plain f64 CG's TRUE residual drifts above its "
          f"recurrence); "
          f"max|u - u_9| / max|u_9| {du9:.3e} (phase 9's stencil-engine u, its TRUE rel <= "
          f"1e-5); setup {d['setup_s']} s, solve {rec['value']} s, {d['ms_per_iter']} ms per "
          f"iteration, exchange share {d['exchange_share']}, n_shard {d['n_shard']} cells "
          f"{d['cells']}; peak device memory per rank {d['peak_bytes_per_rank']} B; CLI wall "
          f"{walls['12d flagship']:.3f} s; launches rank 0 {r0['launches']}", flush=True)
    if walls["12d flagship"] > 120.0:
        print(f"[multi] 12d took {walls['12d flagship']:.1f} s (> 120 s): {d['iters']} "
              f"iterations at {d['ms_per_iter']} ms, {d['exchange_share']:.1%} of the solve "
              f"inside the exchanges (gloo stages every layer through the host), setup "
              f"{d['setup_s']} s", flush=True)
    require(d["converged"] and rel_d <= 1e-5, f"12d: converged {d['converged']}, rel {rel_d:.3e}")
    add_launches(total, r0["launches"])

    # ---- 12f. the dry run, gloo world 2 on the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, "gloo", "cuda", P12_TIMEOUT)
    walls["12f dryrun"] = time.perf_counter() - t0
    add_launches(total, dry["launches"])
    print(f"[multi] 12f dryrun_multichip(2) gloo on the card: all five stages passed in "
          f"{walls['12f dryrun']:.3f} s; launches rank 0 {dry['launches']}", flush=True)
    require(dry["launches"]["stiffness_apply"] > 0 and dry["launches"]["tet10_force"] > 0,
            "12f: kernels D and N were not launched by the halo solves")

    walls["12 total to here"] = time.perf_counter() - t_phase
    print(f"[multi] launches of phase 12 (every rank of every step): {total}; walls {walls}",
          flush=True)
    for name in P12_KERNELS:
        require(total.get(name, 0) > 0, f"phase 12: {name} was not launched")
    t0 = time.perf_counter()
    shapes = slab_kernel_checks(dev, p4w, lam, mu)
    print(f"[multi] slab and extended-mesh kernel checks {time.perf_counter() - t0:.3f} s",
          flush=True)
    return total, shapes


# ---------------------------------------------------------------- phase 13

TPU_WARM_ITERS = 331  # tpufem's warm_f32 on the TPU (stencil_mg.py:715-723); a claim, not a bar


def traced_b_launches(trace_file):
    """Kernel B's device activities in a torch.profiler trace file."""
    events = json.loads(Path(trace_file).read_text())["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "strain_apply_kernel" in e.get("name", ""))


def run_last_pieces(dev, state, smi):
    """Phase 13, the last of tpufem on the card: (a) WingStencilT.solve's
    warm_f32 and dd_main branches and both together on phase 3's batch at
    DOF100K (TRUE f64 rel <= 1e-6 on the CPU in every lane, u within 1e-7
    of phase 3's); (b) the warm_f32 solve inside utils.profiling.trace: one
    trace file whose device events hold as many of kernel B's launches as
    its counter moved; (c) ops.segment's formulations at the real shapes:
    segment_sum_sorted launches kernel A in f32 (C = 128, phase 4's graph)
    and kernel E in f64 (C = 6, the RBM group ids of phase 6's wing), A
    within phase 4's 1e-5 of the plain f64 sum, E the CPU's bits;
    incidence_gather_sum on the card within 1e-12 of the CPU's; (d) the
    native MSH2 parser built on this host, and parse_msh2 through it equal
    to the numpy parser's mesh on the DOF100K wing. Returns the launches of
    the phase by the kernels' line names."""
    from tpufem_torch import msh2, native
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.mesher import DOF100K, structured_wing_mesh
    from tpufem_torch.ops import csr_segment_sum as cs
    from tpufem_torch.ops import gather_scatter as gs
    from tpufem_torch.ops import segment as sg
    from tpufem_torch.ops.gather_scatter import sorted_segment_sum_plain
    from tpufem_torch.utils.profiling import trace

    lam, mu = lame_params(Material())
    counters = {"strain_apply": st.strain_apply, "segment_rowptr": gs.segment_rowptr,
                "sorted_segment_sum": gs.sorted_segment_sum,
                "csr_segment_sum": cs.csr_segment_sum}
    for fn in counters.values():
        fn.launches = 0
    b = counters["strain_apply"]
    p4, solver, out3 = state["p4"], state["solver"], state["out"]
    u3 = out3.u
    bt = solver.bt
    upper, free = bt.upper.cpu().numpy(), bt.free64.cpu().numpy()
    kw = {"pressure": PRESSURE, "tol": TOL, "maxiter": 2000, "outer_f64": True}
    walls = {}

    # ---- 13a. the two branches and both together
    t_phase = time.perf_counter()
    results = {}
    for label, flags in (("warm_f32", {"warm_f32": True}), ("dd_main", {"dd_main": True}),
                         ("warm_f32 + dd_main", {"warm_f32": True, "dd_main": True})):
        b0 = b.launches
        t0 = time.perf_counter()
        o = solver.solve(p4, **kw, **flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rel_cpu = true_residual_cpu(DOF100K, p4, o.u.cpu(), upper, free, lam, mu)
        du = ((o.u - u3).abs().max() / u3.abs().max()).item()
        tm = solver.last_timing
        results[label] = {"iters": o.iters, "wall_s": wall, "b_launches": b.launches - b0,
                          "true_rel_max": float(rel_cpu.max()), "u_rel_to_phase3": du,
                          **{k: tm[k] for k in ("setup_s", "solve_s", "recover_s")}}
        print(f"[13a] {label}: {o.iters} iters (phase 3's default branch {out3.iters}; "
              f"tpufem's TPU record for warm_f32 {TPU_WARM_ITERS}, a claim, not a bar), wall "
              f"{wall:.3f} s (setup {tm['setup_s']:.3f}, solve {tm['solve_s']:.3f}, recover "
              f"{tm['recover_s']:.3f}), kernel B launches {b.launches - b0}; TRUE f64 rel on the "
              f"CPU max {rel_cpu.max():.3e} (bar {TOL}); max|u - u3| / max|u3| {du:.3e} "
              f"(bar 1e-7); {smi}", flush=True)
        require(bool(o.converged.all()) and float(rel_cpu.max()) <= TOL,
                f"13a {label}: converged {o.converged.tolist()}, TRUE rel {rel_cpu}")
        require(du <= 1e-7, f"13a {label}: u {du:.3e} from phase 3's")
    walls["13a branches"] = time.perf_counter() - t_phase

    # ---- 13b. the warm_f32 solve inside trace(): one file, kernel B's launches in it
    t0 = time.perf_counter()
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    for attempt in range(3):  # the tracer may come up late and lose the first device records
        with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_trace_") as tmp:
            with trace(tmp):
                head = torch.empty(1 << 20, device=dev)  # calls the tracer may lose, then a sync
                t_head = time.perf_counter() + 0.05 * 2**attempt
                while time.perf_counter() < t_head:
                    head.add_(1.0)
                torch.cuda.synchronize()
                b0 = b.launches
                solver.solve(p4, **kw, warm_f32=True)
                torch.cuda.synchronize()
                launched = b.launches - b0
            files = list(Path(tmp).iterdir())
            require(len(files) == 1, f"13b: trace() wrote {len(files)} files")
            size = files[0].stat().st_size
            traced = traced_b_launches(files[0])
        if traced == launched:
            break
        print(f"[13b] attempt {attempt + 1}: the trace holds {traced} of kernel B's {launched} "
              f"launches; again with a longer head", flush=True)
    require(traced == launched and launched > 0,
            f"13b: the trace names {traced} launches of kernel B, its counter moved {launched}")
    walls["13b trace"] = time.perf_counter() - t0
    print(f"[13b] trace(dir) around the warm_f32 solve: one file ({size / 1e6:.1f} MB) naming "
          f"kernel B (strain_apply_kernel) {traced} times, as its counter moved; "
          f"{walls['13b trace']:.3f} s", flush=True)

    # ---- 13c. ops.segment at the real shapes
    t0 = time.perf_counter()
    seg = {}
    g = state["graph0"]
    n_nodes = g.num_nodes
    dst = np.where(g.edge_mask > 0, g.edge_index[1], n_nodes)
    perm, sorted_ids = sg.make_sorted_plan(dst)
    gen = torch.Generator(device=dev).manual_seed(13)
    vals = torch.randn((dst.shape[0], 128), generator=gen, device=dev)
    a0 = counters["sorted_segment_sum"].launches
    y = sg.segment_sum_sorted(vals, perm, sorted_ids, n_nodes)
    torch.cuda.synchronize()
    require(counters["sorted_segment_sum"].launches == a0 + 1,
            "13c: segment_sum_sorted f32 did not launch kernel A")
    rows = vals[torch.as_tensor(perm, device=dev).long()]
    ref = sorted_segment_sum_plain(rows.double(), torch.as_tensor(sorted_ids, device=dev),
                                   n_nodes)
    err, scale = (y.double() - ref).abs().max().item(), ref.abs().max().item()
    require(err <= 1e-5 * scale, f"13c: kernel A {err:.3e} vs scale {scale:.3e}")
    saved = {name: fn.launches for name, fn in counters.items()}  # timing is not the path
    seg["f32 C=128"] = {"E": int(dst.shape[0]), "N": n_nodes, "max_abs_err": err, "scale": scale,
                        "ms": median_ms(lambda: sg.segment_sum_sorted(vals, perm, sorted_ids,
                                                                      n_nodes)),
                        "plain_ms": median_ms(lambda: sorted_segment_sum_plain(
                            rows, torch.as_tensor(sorted_ids, device=dev), n_nodes))}
    for name, fn in counters.items():
        fn.launches = saved[name]
    node_group, n_groups = state["rbm_groups"]
    perm, sorted_ids = sg.make_sorted_plan(node_group)
    vals = torch.randn((node_group.shape[0], 6), generator=gen, dtype=torch.float64, device=dev)
    e0 = counters["csr_segment_sum"].launches
    y = sg.segment_sum_sorted(vals, perm, sorted_ids, n_groups)
    torch.cuda.synchronize()
    require(counters["csr_segment_sum"].launches == e0 + 1,
            "13c: segment_sum_sorted f64 did not launch kernel E")
    ref = sg.segment_sum_sorted(vals.cpu(), perm, sorted_ids, n_groups)
    require(torch.equal(y.cpu(), ref), f"13c: kernel E is not the CPU's bits (largest "
            f"difference {(y.cpu() - ref).abs().max().item():.3e})")
    seg["f64 C=6"] = {"E": int(node_group.shape[0]), "N": n_groups, "max_abs_err": 0.0,
                      "equals_cpu_plain": True}
    span, chord, sweep, tc = map(float, p4[0])
    mesh = structured_wing_mesh(span, chord, sweep, tc, DOF100K)
    inc, mask = asm.padded_incidence(asm.build_incidence(mesh.tets, mesh.num_nodes))
    fe = torch.randn((4 * mesh.num_tets, 3), generator=gen, dtype=torch.float64, device=dev)
    y = sg.incidence_gather_sum(fe, inc, mask)
    ref = sg.incidence_gather_sum(fe.cpu(), inc, mask)
    err = (y.cpu() - ref).abs().max().item()
    require(err <= 1e-12 * ref.abs().max().item(), f"13c: incidence_gather_sum {err:.3e}")
    seg["incidence f64 C=3"] = {"N": mesh.num_nodes, "V": int(inc.shape[1]), "max_abs_err": err}
    walls["13c segment"] = time.perf_counter() - t0
    print(f"[13c] segment_sum_sorted: f32 C=128 over phase 4's graph (E={seg['f32 C=128']['E']}, "
          f"N={n_nodes}) launched kernel A, max|err| {seg['f32 C=128']['max_abs_err']:.3e} vs "
          f"the plain f64 sum (scale {scale:.3e}, bar 1e-5 rel), {seg['f32 C=128']['ms']:.4f} ms "
          f"vs plain {seg['f32 C=128']['plain_ms']:.4f} ms; f64 C=6 over the RBM group ids "
          f"(E={node_group.shape[0]}, N={n_groups}) launched kernel E, the CPU's bits; "
          f"incidence_gather_sum f64 at DOF100K wing 0 (N={mesh.num_nodes}, V={inc.shape[1]}) "
          f"within {err:.3e} of the CPU's", flush=True)

    # ---- 13d. the native MSH2 parser on this host
    t0 = time.perf_counter()
    require(native.available(), f"13d: meshcore did not build here: {native.build_error}")
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_msh2_") as tmp:
        path = Path(tmp) / "dof100k_wing0.msh"
        write_msh2(path, mesh)
        calls = native.msh2_parse_native.calls
        t1 = time.perf_counter()
        m_nat = msh2.parse_msh2(path)
        native_s = time.perf_counter() - t1
        require(native.msh2_parse_native.calls == calls + 1, "13d: parse_msh2 did not go native")
        parse_native = msh2.msh2_parse_native
        msh2.msh2_parse_native = lambda text: None  # the numpy parser alone
        try:
            t1 = time.perf_counter()
            m_np = msh2.parse_msh2(path)
            numpy_s = time.perf_counter() - t1
        finally:
            msh2.msh2_parse_native = parse_native
    for k in ("nodes", "tets", "surf_faces"):
        a, c = getattr(m_nat, k), getattr(m_np, k)
        require(a.dtype == c.dtype and np.array_equal(a, c), f"13d: {k} differs from numpy's")
    walls["13d native msh2"] = time.perf_counter() - t0
    print(f"[13d] meshcore built on this host; parse_msh2 of DOF100K wing 0 as MSH2 "
          f"({mesh.num_nodes} nodes, {mesh.num_tets} tets) went native in {native_s:.3f} s, the "
          f"numpy parser took {numpy_s:.3f} s; nodes, tets and faces equal", flush=True)

    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[13] launches {launches}; walls {walls}", flush=True)
    print(json.dumps({"phase13": {"branches": results, "segment": seg, "walls": walls,
                                  "native_parse_s": native_s, "numpy_parse_s": numpy_s,
                                  "device": smi}}), flush=True)
    return launches


# ---------------------------------------------------------------- phase 14

LAYOUTS = ("default", "fast")


def two_level_solve(bt, p4, layout):
    """One two-level solve of the batch p4 to TOL in `layout`: (result, wall
    s)."""
    t0 = time.perf_counter()
    o = bt.solve(p4, pressure=PRESSURE, tol=TOL, maxiter=20000, fast_layout=layout == "fast")
    torch.cuda.synchronize()
    return o, time.perf_counter() - t0


def pair_line(label, res, p4, pair, bt, ref_u, lam, mu):
    """Print one pair's iterations, residuals (recurred, and TRUE f64 on the
    CPU), seconds (every run, in the order run), the tip and the u gap per
    lane to ref_u; pair is {layout: (result, [wall s, ...])}; returns
    {layout: per-lane numbers}."""
    upper, free = bt.upper.cpu().numpy(), bt.free64.cpu().numpy()
    rec = {}
    for layout, (o, walls) in pair.items():
        u = o.u.cpu().double()
        nodes = o.nodes.cpu().numpy()
        true = true_residual_cpu(res, p4, u, upper, free, lam, mu)
        rec[layout] = {
            "iters": o.iters, "wall_s": walls, "ms_per_iter": [1e3 * w / o.iters for w in walls],
            "converged": o.converged.tolist(),
            "rel": [float(r) for r in o.rel_residual.tolist()], "true_rel": true.tolist(),
            "finite": bool(torch.isfinite(u).all()),
            "tip_uz": [float(u[nodes[:, 1, k] > 0.9 * float(p4[k, 0]), 2, k].mean())
                       for k in range(len(p4))],
            "gap": [max_rel(u[:, :, k], ref_u[:, :, k].cpu()) for k in range(len(p4))]}
        r = rec[layout]
        print(f"[fast] {label} {layout}: {r['iters']} iterations, "
              f"{[f'{w:.3f}' for w in walls]} s ({[f'{m:.3f}' for m in r['ms_per_iter']]} ms an "
              f"iteration), converged {r['converged']}, recurred rel "
              f"{[f'{x:.3e}' for x in r['rel']]}, TRUE f64 rel on the CPU "
              f"{[f'{x:.3e}' for x in r['true_rel']]}, u gap per lane "
              f"{[f'{x:.3e}' for x in r['gap']]}", flush=True)
    return rec


def run_fast_layout(dev, state, smi):
    """Phase 14, WingBatchT.solve(fast_layout=True), tpufem's EXPERIMENTAL
    layout, which the port runs as the two-level CG with every lane dot
    summed in f64, on kernel O. With the counters of kernels O and E
    zeroed: (b) at MEDIUM on phase 3's batch the f32 two-level setup must
    refuse the batch in both layouts alike (lane 3's coarse RBM operator is
    not positive definite in f32; tpufem's lane goes NaN there), and the
    pair runs in f64, where the flag changes nothing: the default solve's
    iterations and bits, both converged, u within 1e-2 of 10c's f64 u; (c)
    the f32 pair at DOF100K on phase 3's batch, each solver's host plans
    made first, timed in turns (default, fast, fast, default): each
    layout's two runs the same bits, finite u and a downward tip in every
    lane, the fast layout converged wherever the default one is, u within
    1e-2 of 10b's f64 multigrid u on every converged lane; iterations,
    recurred and TRUE f64 residuals and seconds printed. No refusal is
    caught there. The counters are read after (c). (d) fast_layout=True
    under mg_levels=None gives 10b's answer. Returns the launches of O and
    E in (b)-(c) by the kernels' line names."""
    from tpufem_torch.fem import assembly as asm
    from tpufem_torch.fem.batched_t import WingBatchT
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.precond import NotPositiveDefiniteError
    from tpufem_torch.mesher import DOF100K, MEDIUM
    from tpufem_torch.ops import csr_segment_sum as cs

    lam, mu = lame_params(Material())
    p4 = state["p4"]
    ref = state["batched"]
    walls, solves = {}, {}
    counters = {"stiffness_apply_t": asm.stiffness_apply_t, "csr_segment_sum": cs.csr_segment_sum}
    for fn in counters.values():
        fn.launches = 0

    def solver(res, dtype):
        t0 = time.perf_counter()
        bt = WingBatchT(res, dtype=dtype, device=dev)
        _ = bt._level, bt._rbm  # cached properties, made at their first use
        bt.force_plans(len(p4), bt.dtype)
        return bt, time.perf_counter() - t0

    def bars(step, res, pair, bt, ref_u, dtype, plans_s):
        rec = pair_line(f"{step} B={len(p4)} {dtype} tol {TOL}", res, p4, pair, bt, ref_u,
                        lam, mu)
        d, f = rec["default"], rec["fast"]
        require(d["finite"] and f["finite"] and max(d["tip_uz"] + f["tip_uz"]) < 0,
                f"{step}: finite {d['finite']} / {f['finite']}, tip u_z {d['tip_uz']} / "
                f"{f['tip_uz']}")
        require(all(cf or not cd for cd, cf in zip(d["converged"], f["converged"])),
                f"{step}: the fast layout failed where the default converged: "
                f"{d['converged']} / {f['converged']}")
        for r in (d, f):
            gaps = [g for g, c in zip(r["gap"], r["converged"]) if c]
            require(max(gaps, default=0.0) <= 1e-2, f"{step}: u gap {r['gap']}")
        rec["plans_s"] = plans_s
        solves[step] = {"dtype": dtype, **rec}
        return d, f

    # ---- 14b. MEDIUM: the f32 setup refuses the batch in both layouts; the f64 pair
    t0 = time.perf_counter()
    bt, _ = solver(MEDIUM, torch.float32)
    refused = {}
    for layout in LAYOUTS:
        try:
            two_level_solve(bt, p4, layout)
        except NotPositiveDefiniteError as e:
            refused[layout] = str(e)
    require(len(refused) == 2 and refused["default"] == refused["fast"],
            f"14b: the f32 two-level setup at MEDIUM refused phase 3's batch in {sorted(refused)}, "
            f"not in both layouts alike: {refused}")
    print(f"[fast] 14b MEDIUM B={len(p4)} f32 tol {TOL}: the two-level setup refuses the batch "
          f"in both layouts alike ({refused['fast']}); the pair in f64", flush=True)
    bt, plans_s = solver(MEDIUM, torch.float64)
    pair = {layout: two_level_solve(bt, p4, layout) for layout in LAYOUTS}
    d, f = bars("14b MEDIUM", MEDIUM, {k: (o, [w]) for k, (o, w) in pair.items()}, bt,
                ref["medium_two_u"], "f64", plans_s)
    require(all(d["converged"]) and all(f["converged"]),
            f"14b: converged {d['converged']} / {f['converged']}")
    same = torch.equal(pair["default"][0].u, pair["fast"][0].u)
    require(same and d["iters"] == f["iters"],
            f"14b: in f64 the flag changed the solve: {d['iters']} / {f['iters']} iterations, "
            f"bitwise {same}")
    solves["14b MEDIUM"]["refused_f32"] = refused["fast"]
    walls["14b MEDIUM"] = time.perf_counter() - t0

    # ---- 14c. DOF100K f32, in turns: default, fast, fast, default
    t0 = time.perf_counter()
    bt, plans_s = solver(DOF100K, torch.float32)
    runs = {layout: [] for layout in LAYOUTS}
    for layout in ("default", "fast", "fast", "default"):
        runs[layout].append(two_level_solve(bt, p4, layout))
    for layout, ((o1, _), (o2, _)) in runs.items():
        require(o1.iters == o2.iters and torch.equal(o1.u, o2.u),
                f"14c: the {layout} layout's two runs differ: {o1.iters} / {o2.iters} iterations")
    pair = {layout: (r[0][0], [w for _, w in r]) for layout, r in runs.items()}
    d, f = bars("14c DOF100K", DOF100K, pair, bt, ref["out_mg"].u, "f32", plans_s)
    # the TRUE residual of the f64 reference itself, rounded to f32
    floor = true_residual_cpu(DOF100K, p4, ref["out_mg"].u.float().cpu().double(),
                              bt.upper.cpu().numpy(), bt.free64.cpu().numpy(), lam, mu)
    print(f"[fast] 14c DOF100K: host plans {plans_s:.3f} s before the solves; the f64 "
          f"reference u rounded to f32 has TRUE f64 rel {[f'{x:.3e}' for x in floor]} (the "
          f"dtype's own floor); {smi}", flush=True)
    solves["14c DOF100K"]["reference_rounded_true_rel"] = floor.tolist()
    walls["14c DOF100K"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(all(launches.values()),
            f"the fast layout's solves did not launch every kernel of their path: {launches}")
    require(launches["stiffness_apply_t"] >= 2 * (d["iters"] + f["iters"] + 2),
            f"kernel O launched {launches['stiffness_apply_t']} times in phase 14, 14c's four "
            f"solves took {d['iters']} / {f['iters']} iterations each")

    # ---- 14d. the flag under the multigrid: 10b's answer
    t0 = time.perf_counter()
    again = ref["mg64"].solve(p4, pressure=PRESSURE, tol=1e-7, maxiter=2000, fast_layout=True)
    torch.cuda.synchronize()
    gap_d = max_rel(again.u.cpu(), ref["out_mg"].u.cpu())
    same = torch.equal(again.u, ref["out_mg"].u)
    print(f"[fast] 14d WingBatchT(DOF100K, float64, mg_levels=None).solve(fast_layout=True): "
          f"{again.iters} iterations (10b: {ref['out_mg'].iters}), u gap to 10b {gap_d:.3e}, "
          f"bitwise {same}", flush=True)
    require(again.iters == ref["out_mg"].iters and gap_d <= 1e-12,
            f"14d: {again.iters} iterations against 10b's {ref['out_mg'].iters}, u gap {gap_d}")
    walls["14d multigrid"] = time.perf_counter() - t0
    print(f"[fast] launches of phase 14b-14c: {launches}", flush=True)
    print(json.dumps({"phase14": {"solves": solves, "walls": walls, "launches": launches,
                                  "device": smi}}), flush=True)
    return launches


if __name__ == "__main__":
    sys.exit(main())
