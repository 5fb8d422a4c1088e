#!/usr/bin/env python3
"""Smoke run of the tpufem_torch port on one CUDA card (H100, sm_90a).

Drives the port's main path once at full size: a batch of 8 PRD wing designs
(the seeded batch bench.py times) -> DOF100K (64x80x6 cells, 109,107 DOF)
f64-outer multigrid-CG solve -> von Mises -> surface graphs -> the full-width
GraphSAGE surrogate forward (random weights from a seeded torch.Generator; no
trained checkpoint exists). Along the way:

  1. builds the CUDA kernels from tpufem_torch/csrc (nvcc, into build/) and
     prints the card's name and power limit;
  2. checks kernel B (strain_apply) against its plain PyTorch version at
     DOF100K, B=8, in f64 and f32, with both times, and in f32 at each
     coarser V-cycle level that applies it;
  3. solves, and recomputes the TRUE f64 residual independently on the CPU
     (plain strain_apply, numpy loads); checks the physics;
  4. runs the surrogate on all 8 surface graphs through kernel A
     (sorted_segment_sum), checks it against the plain-aggregation forward,
     and checks kernel A against its plain version on those graph shapes;
  5. the training path, through the port's CLIs in a temporary --data_root
     under build/: 16 DOF100K wings (geometry -> mesh -> batched FEM, all
     converged at TRUE rel <= 1e-6), 3 epochs of the full-width GraphSAGE
     (9 steps at batch 4, kernels A forward and C backward), inference on
     the 3 test wings; then the card's gradients of one merged batch against
     the CPU's, the step's forward/backward/optimizer times, and kernel C
     (segment_gather) against its plain version on the merged-batch shape;
  6. prints the kernels' JSON line, then {"ok": true, "device": {...}}.

Every phase raises on failure; the script then exits nonzero and prints no
result. Usage: python3 chip_smoke.py   (one card, no arguments)
"""

from __future__ import annotations

import json
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
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sample_params(rng, n, prd):
    names = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
    return np.stack([rng.uniform(*prd[k], n) for k in names], axis=1).astype(np.float32)


def check_strain_apply(dev, res, p4):
    """Kernel B against strain_apply_plain at the main path's shapes."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.material import Material, lame_params

    lam, mu = lame_params(Material())
    X = st.nodes_grid(res, torch.as_tensor(p4, device=dev), torch.float64)
    geo = st.cell_geometry(res, X)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn(X.shape, generator=gen, dtype=torch.float64, device=dev)
    free = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=torch.float64, device=dev)
    free[..., 0] = 0.0
    y = st.strain_apply(res, geo, u, free, lam, mu)
    ref = st.strain_apply_plain(res, geo, u, free, lam, mu)
    torch.cuda.synchronize()
    err64 = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(err64 <= 1e-12 * scale, f"kernel B f64 disagrees: {err64:.3e} vs scale {scale:.3e}")
    require(torch.equal(y, st.strain_apply(res, geo, u, free, lam, mu)), "kernel B not deterministic")
    geo32 = tuple(t.float() for t in geo)
    u32, free32 = u.float(), free.float()
    y32 = st.strain_apply(res, geo32, u32, free32, lam, mu)
    p32 = st.strain_apply_plain(res, geo32, u32, free32, lam, mu)
    e_k = (y32.double() - ref).abs().max().item()
    e_p = (p32.double() - ref).abs().max().item()
    require(e_k <= 2.0 * e_p, f"kernel B f32 error {e_k:.3e} > 2x plain f32 error {e_p:.3e}")
    coarse = check_strain_apply_levels(dev, res, p4, lam, mu)
    t = {
        "ms": median_ms(lambda: st.strain_apply(res, geo, u, free, lam, mu)),
        "plain_ms": median_ms(lambda: st.strain_apply_plain(res, geo, u, free, lam, mu)),
        "ms_f32": median_ms(lambda: st.strain_apply(res, geo32, u32, free32, lam, mu)),
        "plain_ms_f32": median_ms(lambda: st.strain_apply_plain(res, geo32, u32, free32, lam, mu)),
    }
    print(f"[kernel B] strain_apply {res.key} B={p4.shape[0]}: f64 max|err| {err64:.3e} "
          f"(scale {scale:.3e}, bar 1e-12 rel); f32 err vs f64 {e_k:.3e} "
          f"(plain f32 {e_p:.3e}, bar 2x)")
    for key, (ek, ep) in coarse.items():
        print(f"[kernel B] V-cycle level {key} f32: err vs f64 {ek:.3e} (plain f32 {ep:.3e}, bar 2x)")
    print(f"[kernel B] f64 {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms; "
          f"f32 {t['ms_f32']:.4f} ms vs plain {t['plain_ms_f32']:.4f} ms (median of 7)")
    return {"max_abs_err": err64, "max_abs_err_f32": e_k,
            "levels_f32": {str(k): {"max_abs_err": v[0], "plain_max_abs_err": v[1]}
                           for k, v in coarse.items()}, **t}


def check_strain_apply_levels(dev, res, p4, lam, mu):
    """Kernel B f32 against the plain f32 version, both judged against the
    plain f64 result, at the coarser V-cycle levels that apply it (all but
    the finest, checked above, and the coarsest, a dense inverse)."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.stencil_mg import hierarchy_resolutions

    out = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    for r in hierarchy_resolutions(res)[1:-1]:
        X = st.nodes_grid(r, torch.as_tensor(p4, device=dev), torch.float64)
        geo = st.cell_geometry(r, X)
        u = torch.randn(X.shape, generator=gen, dtype=torch.float64, device=dev)
        free = torch.ones((1, 1, 1, 1, r.n_span + 1), dtype=torch.float64, device=dev)
        free[..., 0] = 0.0
        ref = st.strain_apply_plain(r, geo, u, free, lam, mu)
        geo32 = tuple(t.float() for t in geo)
        y32 = st.strain_apply(r, geo32, u.float(), free.float(), lam, mu)
        p32 = st.strain_apply_plain(r, geo32, u.float(), free.float(), lam, mu)
        e_k = (y32.double() - ref).abs().max().item()
        e_p = (p32.double() - ref).abs().max().item()
        require(e_k <= 2.0 * e_p,
                f"kernel B f32 at {r.key}: error {e_k:.3e} > 2x plain f32 error {e_p:.3e}")
        out[r.key] = (e_k, e_p)
    return out


def segment_inputs(g, dev, C, gen):
    """(msgs, seg, N) as gather_mean_aggregate feeds kernel A on graph g,
    with the edge list padded to a multiple of 256 by masked (dump) edges."""
    E = g["edge_index"].shape[1]
    Ep = (E + 255) // 256 * 256 + 256  # at least 256 dump rows
    dst = torch.full((Ep,), g["N"], dtype=torch.int32, device=dev)
    dst[:E] = torch.as_tensor(g["edge_index"][1], device=dev)
    seg, _ = torch.sort(dst)
    msgs = torch.randn((Ep, C), generator=gen, device=dev)
    return msgs, seg, g["N"]


def check_segment_sum(dev, graphs):
    """Kernel A against the plain f64 sum on the surface graphs' shapes."""
    from tpufem_torch.ops import gather_scatter as gs

    gen = torch.Generator(device=dev).manual_seed(1)
    offs = np.cumsum([0] + [g["N"] for g in graphs])
    batched = {"N": int(offs[-1]), "edge_index": np.concatenate(
        [g["edge_index"] + o for g, o in zip(graphs, offs)], axis=1)}
    out = {}
    for label, g in (("one graph", graphs[0]), (f"{len(graphs)}-graph batch", batched)):
        for C in (128, 1):
            msgs, seg, N = segment_inputs(g, dev, C, gen)
            y = gs.sorted_segment_sum(msgs, seg, N)
            ref = gs.sorted_segment_sum_plain(msgs.double(), seg, N)
            torch.cuda.synchronize()
            err = (y.double() - ref).abs().max().item()
            scale = ref.abs().max().item()
            require(err <= 1e-5 * scale, f"kernel A {label} C={C}: {err:.3e} vs {scale:.3e}")
            require(torch.equal(y, gs.sorted_segment_sum(msgs, seg, N)),
                    "kernel A not deterministic")
            ms = median_ms(lambda: gs.sorted_segment_sum(msgs, seg, N))
            plain_ms = median_ms(lambda: gs.sorted_segment_sum_plain(msgs, seg, N))
            print(f"[kernel A] {label}: E={msgs.shape[0]} C={C} N={N}: max|err| {err:.3e} "
                  f"(scale {scale:.3e}, bar 1e-5 rel); {ms:.4f} ms vs plain {plain_ms:.4f} ms")
            out[(label, C)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                               "E": msgs.shape[0]}
    return out


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
    kernels = run(dev, DOF100K, BATCH)
    kernels += run_training_path(dev, kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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
    from tpufem_torch.ops import gather_scatter as gs
    from tpufem_torch.ops.kernels import build_info, load_kernels
    from tpufem_torch.pipeline.types import PRD_RANGES

    # ---- 1. build
    load_kernels()
    print(f"[build] kernels built in {build_info['seconds']:.2f} s -> {build_info['path']}")
    for line in build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # ---- batch: the second seeded draw, as bench.py times it
    rng = np.random.default_rng(42)
    sample_params(rng, batch, PRD_RANGES)  # bench's warm-up draw
    p4 = sample_params(rng, batch, PRD_RANGES)

    # ---- 2. kernel B on the card
    kb = check_strain_apply(dev, res, p4)

    # ---- 3 + 4. the main path, with the launch counters zeroed just before
    lam, mu = lame_params(Material())
    t0 = time.perf_counter()
    solver = WingStencilT(res, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    st.strain_apply.launches = 0
    gs.sorted_segment_sum.launches = 0

    t0 = time.perf_counter()
    out = solver.solve(p4, pressure=PRESSURE, tol=TOL, maxiter=2000)
    torch.cuda.synchronize()
    solve_wall = time.perf_counter() - t0

    bt = solver.bt
    nodes = out.nodes.cpu().numpy().astype(np.float64)
    u, s6, vm = out.u.cpu().numpy(), out.stress6.cpu().numpy(), out.vm.cpu().numpy()
    rel, conv = out.rel_residual.cpu().numpy(), out.converged.cpu().numpy()
    faces = bt.surf_faces[bt.sets.surf_all_faces]
    names = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
    model = GraphSAGE(SAGEConfig(), generator=torch.Generator().manual_seed(0), device=dev).eval()
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
    launches = {"strain_apply": st.strain_apply.launches,
                "sorted_segment_sum": gs.sorted_segment_sum.launches}
    print(f"[main path] kernel launches: {launches}")
    require(launches["strain_apply"] > 0, "kernel B was not launched on the main path")
    require(launches["sorted_segment_sum"] > 0, "kernel A was not launched on the main path")

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
    model_cpu = GraphSAGE(SAGEConfig(), generator=torch.Generator().manual_seed(0)).eval()
    for k, (g, pred) in enumerate(zip(graphs, preds)):
        require(pred.shape == (g.num_nodes,) and np.isfinite(pred).all(), f"case {k}: bad pred")
        with torch.no_grad():
            plain = model_cpu(torch.as_tensor(g.x), torch.as_tensor(g.edge_index),
                              torch.as_tensor(g.edge_mask)).numpy()
        diff = np.abs(pred - plain).max()
        require(diff <= 1e-4 * max(1.0, np.abs(plain).max()),
                f"case {k}: kernel-A forward vs plain forward {diff:.3e}")
    m = compute_metrics(preds[0], graphs[0].stress_vm, graphs[0].loss_mask)["masked_nodes"]
    print(f"[surrogate] GraphSAGE(SAGEConfig()) on {batch} graphs "
          f"({graphs[0].num_nodes} nodes, {graphs[0].num_edges} edges each): "
          f"{surrogate_s:.3f} s incl. graph building; equals the plain-aggregation forward "
          f"(1e-4)")
    print(f"[surrogate] UNTRAINED random weights, case 0 vs FEM: MAE {m['mae_pa'] / 1e6:.3f} MPa "
          f"rel {m['rel_mae']:.3f} (meaningless until a checkpoint exists)")
    ka = check_segment_sum(
        dev, [{"N": g.num_nodes, "edge_index": g.edge_index} for g in graphs])

    one = ka[("one graph", 128)]
    return [
        {"name": "sorted_segment_sum", "route": "cuda", "source": "tpufem_torch/csrc/segment_sum.cu",
         "replaces": "tpufem/ops/gather_scatter.py:49", "launches": launches["sorted_segment_sum"],
         "max_abs_err": one["max_abs_err"], "ms": one["ms"], "plain_ms": one["plain_ms"],
         "shapes": {f"{lbl} C={c}": v for (lbl, c), v in ka.items()}},
        {"name": "strain_apply", "route": "cuda", "source": "tpufem_torch/csrc/strain_apply.cu",
         "replaces": "tpufem/fem/stencil.py:249", "launches": launches["strain_apply"],
         "max_abs_err": kb["max_abs_err"], "ms": kb["ms"], "plain_ms": kb["plain_ms"],
         "f32": {"max_abs_err": kb["max_abs_err_f32"], "ms": kb["ms_f32"],
                 "plain_ms": kb["plain_ms_f32"], "coarse_levels": kb["levels_f32"]}},
    ]


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
    card (kernels A and C) against the same model on the CPU (plain path),
    to 1e-4 of each tensor's max |grad|."""
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
    from tpufem_torch.models.train import GraphSet, Trainer

    cfg = SAGEConfig(dropout=0.0)
    grads, losses = {}, {}
    for d in (dev, torch.device("cpu")):
        model = GraphSAGE(cfg, generator=torch.Generator().manual_seed(0), device=d).train()
        loss = Trainer._loss_fn(model, GraphSet(graphs, d).batch(range(len(graphs))))
        loss.backward()
        losses[d.type] = float(loss.detach())
        grads[d.type] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    worst = 0.0
    for name, g_cpu in grads["cpu"].items():
        err = (grads["cuda"][name] - g_cpu).abs().max().item()
        scale = g_cpu.abs().max().item()
        require(err <= 1e-4 * scale, f"grad {name}: card vs CPU {err:.3e} > 1e-4 x {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"[train] gradients of one merged batch ({len(graphs)} graphs, dropout off): "
          f"{len(grads['cpu'])} tensors, card (kernels A+C) vs CPU plain path: worst "
          f"|err|/max|grad| {worst:.3e} (bar 1e-4); loss {losses['cuda']:.6f} vs "
          f"{losses['cpu']:.6f}")
    return worst


def check_segment_gather(dev, batch):
    """Kernel C against segment_gather_plain at the merged batch's shape:
    the ids gather_mean_aggregate sorts, cotangent rows of width 128."""
    from tpufem_torch.ops import gather_scatter as gs

    N = batch.x.shape[0]
    dst = batch.edge_index[1]
    dst_eff = torch.where(batch.edge_mask > 0, dst, torch.full_like(dst, N))
    seg = torch.sort(dst_eff).values.contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn((N, 128), generator=gen, device=dev)
    out = gs.segment_gather(g, seg, N)
    plain = gs.segment_gather_plain(g, seg, N)
    torch.cuda.synchronize()
    require(torch.equal(out, plain), "kernel C differs from its plain version (a copy: bitwise)")
    require(torch.equal(out, gs.segment_gather(g, seg, N)), "kernel C not deterministic")
    ms = median_ms(lambda: gs.segment_gather(g, seg, N))
    plain_ms = median_ms(lambda: gs.segment_gather_plain(g, seg, N))
    print(f"[kernel C] segment_gather merged batch: E={seg.shape[0]} C=128 N={N}: bitwise "
          f"equal to plain, deterministic; {ms:.4f} ms vs plain {plain_ms:.4f} ms (median of 7)")
    return {"max_abs_err": (out - plain).abs().max().item(), "ms": ms, "plain_ms": plain_ms,
            "E": seg.shape[0]}


def run_training_path(dev, kernels):
    """Phase 5: dataset CLIs -> train_gnn -> inference_gnn at DOF100K, then
    the gradient, step-time and kernel C checks. Reuses no state of phases
    1-4. Returns kernel C's report entry (and adds the training launches to
    kernel A's)."""
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.models.dataset import WingStressDataset
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
    from tpufem_torch.models.train import GraphSet
    from tpufem_torch.ops import gather_scatter as gs
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

        cli("geometry", generate_geometry_dataset,
            ["--count", str(N_WINGS), "--seed", "7", "--no_glb"])
        cli("mesh", generate_mesh_dataset,
            ["--n_chord", "64", "--n_span", "80", "--n_thick", "6",
             "--te_floor_frac", "0.006", "--spacing", "le"])
        st.strain_apply.launches = 0
        cli("fem", generate_fem_dataset,
            ["--batched", "--batch_size", "8", "--tol", str(TOL), "--pressure", "5000",
             "--no_glb", "--device", "cuda"])
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
        rels = [r["extra"]["solver"]["rel_residual"] for r in reps]
        iters = sorted({r["extra"]["solver"]["iters"] for r in reps})
        write_s = sum(r["elapsed_ms"] for r in reps) / 1e3
        print(f"[dataset] {N_WINGS} DOF100K wings, {N_WINGS}/{N_WINGS} converged, iters {iters}, "
              f"max TRUE rel {max(rels):.3e} (bar {TOL}); kernel B launches {fem_launches}")
        print(f"[dataset] s/wing: geometry {wall['geometry'] / N_WINGS:.4f}, mesh "
              f"{wall['mesh'] / N_WINGS:.4f}, FEM solve {(wall['fem'] - write_s) / N_WINGS:.4f}, "
              f"writing {write_s / N_WINGS:.4f} (FEM CLI wall {wall['fem']:.3f} s)")

        gs.sorted_segment_sum.launches = 0
        gs.segment_gather.launches = 0
        cli("train", train_gnn, ["--epochs", str(EPOCHS), "--batch_size", "4",
                                 "--device", "cuda"])
        train_launches = {"sorted_segment_sum": gs.sorted_segment_sum.launches,
                          "segment_gather": gs.segment_gather.launches}
        print(f"[train] kernel launches during training: {train_launches}")
        require(train_launches["sorted_segment_sum"] > 0, "kernel A not launched in training")
        require(train_launches["segment_gather"] > 0, "kernel C not launched in training")
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

        gs.sorted_segment_sum.launches = 0
        cli("inference", inference_gnn, ["--split", "test", "--no_glb", "--device", "cuda"])
        require(gs.sorted_segment_sum.launches > 0, "kernel A not launched in inference")
        test_ids = ds.splits["test"]
        require(len(test_ids) == 3, f"test split {test_ids}")
        inf_ms = []
        for cid in test_ids:
            pred = np.load(paths.fem_case(cid) / "pred_results.npz")["pred_pa"]
            require(pred.ndim == 1 and len(pred) > 0 and np.isfinite(pred).all(),
                    f"case {cid}: bad predictions")
            rep = json.loads((paths.fem_case(cid) / "inference_report.json").read_text())
            inf_ms.append(rep["inference_time_ms"])
        summ = json.loads((paths.models / "inference_summary.json").read_text())
        require(summ["num_cases"] == 3, f"inference summary {summ}")
        print(f"[inference] {len(test_ids)} test wings, finite predictions; ms/wing "
              f"{inf_ms} (incl. graph loading); masked MAE "
              f"{summ['mae_mpa_masked_mean']:.3f} MPa after {EPOCHS} epochs")

        graphs = ds.graphs("train")[:4]
        check_gradients(dev, graphs)
        batch = GraphSet(graphs, dev).batch(range(4))
        model = GraphSAGE(SAGEConfig(), generator=torch.Generator().manual_seed(0), device=dev)
        parts = time_step_parts(dev, model, batch)
        print(f"[train] step parts on one merged batch (N={batch.x.shape[0]}, "
              f"E={batch.edge_index.shape[1]}), median of 5: forward {parts['forward_s']:.4f} s, "
              f"backward {parts['backward_s']:.4f} s, optimizer {parts['optimizer_s']:.4f} s")
        kc = check_segment_gather(dev, batch)

    for k in kernels:
        if k["name"] == "sorted_segment_sum":
            k["training_launches"] = train_launches["sorted_segment_sum"]
    return [{"name": "segment_gather", "route": "cuda",
             "source": "tpufem_torch/csrc/segment_sum.cu",
             "replaces": "tpufem/ops/gather_scatter.py:173",
             "launches": train_launches["segment_gather"], "max_abs_err": kc["max_abs_err"],
             "ms": kc["ms"], "plain_ms": kc["plain_ms"], "E": kc["E"],
             "step_parts_s": parts}]


if __name__ == "__main__":
    sys.exit(main())
