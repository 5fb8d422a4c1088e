"""The multi-device dry run — port of ``__graft_entry__.py::dryrun_multichip``.

Five stages on `--ranks` ranks of torch.distributed, each printing a flushed
``[dryrun +t] STAGE k/5 PASSED`` line the moment it passes, so a run cut
short still shows the stages it finished:

  1. the data-parallel training step (one small graph per rank): the loss
     decreases over three steps, and the first step equals the
     single-process step over the same graphs (loss 1e-6, params 1e-5);
  2. the node-sharded Jacobi PCG (parallel.sharded_solver) on COARSE, f64,
     tol 1e-6;
  3. the halo-exchange PCG (parallel.halo_pcg), tet4 on uneven slabs, tol 1e-8;
  4. the same in tet10, tol 1e-8;
  5. the span-sharded multigrid (parallel.shard_stencil), tet10, tol 1e-6,
     under 400 iterations, at 32 x 40 x 4 where the n ranks divide 40 span
     cells, else at tpufem's 32 x 5n x 4. 32 x 40 x 4 is what tpufem's rule
     gives on its 8-device mesh; at n = 2 its rule gives 32 x 10 x 4, whose
     stretched cells (span 0.16 m over chord cells of ~0.0125 m) cost the
     single-device Tet10StencilT itself 455 iterations in f64 (177 at
     32 x 40 x 4), so the bar would measure the wing, not the sharding.

TPUFEM_DRYRUN_RES="n_chord,n_span,n_thick" overrides stage 5's resolution,
as tpufem's. Example (one H100, two ranks sharing it):

    python -m tpufem_torch.scripts.dryrun_multichip --ranks 2 --backend gloo
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpufem_torch.parallel.launch import run_ranks
from tpufem_torch.parallel.meshes import default_backend
from tpufem_torch.scripts import device_arg

WING = (1.2, 0.35, 10.0, 0.10)


def tiny_graph(seed: int = 0, n_pad: int = 256, e_pad: int = 2048):
    """A small real wing graph from the COARSE structured mesh with a
    synthetic stress target (tpufem's __graft_entry__._tiny_graph, on the
    port's mesher and graph builder)."""
    from tpufem_torch.mesher import COARSE, structured_wing_mesh
    from tpufem_torch.models.graph import build_graph, pad_graph
    from tpufem_torch.sets import build_boundary_sets, face_normals_areas

    params = {"span_m": 1.2, "chord_m": 0.35, "sweep_deg": 10.0, "thickness_ratio": 0.10}
    mesh = structured_wing_mesh(params["span_m"], params["chord_m"], params["sweep_deg"],
                                params["thickness_ratio"], COARSE)
    bs = build_boundary_sets(mesh)
    faces = mesh.surf_faces[bs.surf_all_faces]
    surf_nodes = np.unique(faces)
    normals, areas = face_normals_areas(mesh.nodes, faces)
    acc = np.zeros_like(mesh.nodes)
    np.add.at(acc, faces.reshape(-1), np.repeat(normals * areas[:, None], 3, axis=0))
    acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-30)
    rng = np.random.default_rng(seed)
    surface = {
        "node_id": surf_nodes.astype(np.int64),
        "pos": mesh.nodes[surf_nodes].astype(np.float32),
        "normal": acc[surf_nodes].astype(np.float32),
        "stress_vm": rng.uniform(1e5, 5e7, len(surf_nodes)).astype(np.float32),
        "disp": rng.normal(size=(len(surf_nodes), 3)).astype(np.float32),
        "loss_mask": mesh.nodes[surf_nodes, 1] > 0.05 * params["span_m"],
    }
    g = build_graph(surface, faces, params)
    return pad_graph(g, max(n_pad, g.num_nodes), max(e_pad, g.num_edges))


def stacked_graphs(graphs) -> dict:
    """data_parallel.GraphStack's fields of `graphs` as numpy arrays."""
    return {"x": np.stack([g.x for g in graphs]),
            "edge_index": np.stack([g.edge_index for g in graphs]),
            "edge_mask": np.stack([g.edge_mask for g in graphs]),
            "y": np.stack([g.y for g in graphs]),
            "loss_mask": np.stack([g.loss_mask * g.node_mask for g in graphs]),
            "ids": np.arange(len(graphs))}


def require(cond: bool, msg: str) -> None:
    """A stage's check: raise (not an assert, which -O would drop)."""
    if not cond:
        raise RuntimeError(msg)


def params_gap(a: dict, b: dict) -> float:
    """max |a - b| / max |b| over every parameter of two state dicts."""
    return max(float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(b[k]).max()), 1e-30)
               for k in b)


def dp_check(group, cfg, batch: dict, steps: int = 3) -> dict:
    """Stage 1 on one rank: `steps` DP steps, and on every rank the
    single-process step over the whole batch (a world-1 group of its own)
    to hold the first of them to."""
    from tpufem_torch.parallel.data_parallel import dp_train
    from tpufem_torch.parallel.meshes import DeviceGroup

    out = dp_train(group, cfg, batch, steps=steps, seed=0)
    single = dp_train(DeviceGroup(0, 1, group.backend, group.device), cfg, batch, steps=1,
                      seed=0)
    return {"losses": out["losses"], "loss1": out["losses"][0],
            "single_loss": single["losses"][0],
            "params_gap": params_gap(out["params_step1"], single["params"])}


def dryrun_rank(group, n: int, res5) -> dict:
    """The five stages on one rank of `group` (run_ranks' target). Rank 0
    prints the stage lines; every stage's check runs on every rank. The
    record holds each stage's numbers and the rank's kernel launches."""
    from tpufem_torch.fem.tet10_stencil import grid_meta2
    from tpufem_torch.mesher import COARSE, WingMeshResolution
    from tpufem_torch.models.sage import SAGEConfig
    from tpufem_torch.parallel.halo_pcg import halo_solve
    from tpufem_torch.parallel.shard_stencil import sharded_solve
    from tpufem_torch.parallel.sharded_solver import node_sharded_solve

    from tpufem_torch.parallel.launch import kernel_counters

    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    t_start = time.perf_counter()
    say = print if group.rank == 0 else (lambda *a, **k: None)

    def stage(msg: str) -> None:
        say(f"[dryrun +{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)
        sys.stdout.flush()

    stage(f"group: {n} ranks, {group.backend} on {group.device}")
    rec = {}

    # ---- 1: data-parallel training step, one graph per rank
    cfg = SAGEConfig(hidden=32, encoder_hidden=16, decoder_hidden=16, num_layers=2)
    batch = stacked_graphs([tiny_graph(seed=s) for s in range(n)])
    dp = dp_check(group, cfg, batch)
    losses = dp["losses"]
    require(np.isfinite(losses).all(), "dp train step produced a non-finite loss")
    require(losses[-1] < losses[0], f"dp loss did not decrease over 3 steps: {losses}")
    require(abs(dp["loss1"] - dp["single_loss"]) <= 1e-6 * max(1.0, abs(dp["single_loss"])),
            f"dp loss {dp['loss1']} vs single-process {dp['single_loss']}")
    require(dp["params_gap"] <= 1e-5, f"dp params off the single-process step: {dp['params_gap']}")
    rec["dp_losses"] = losses
    stage(f"STAGE 1/5 PASSED: dp train step, losses {', '.join(f'{v:.6f}' for v in losses)} "
          f"(decreasing); step 1 = single-process (loss {dp['single_loss']:.6f}, params "
          f"within {dp['params_gap']:.1e})")

    # ---- 2: node-sharded Jacobi PCG, COARSE tet4, f64
    stage("STAGE 2/5 starting: node-sharded PCG (COARSE tet4, tol 1e-6)")
    out = node_sharded_solve(group, COARSE, WING, pressure=100.0, tol=1e-6, maxiter=20000)
    require(np.isfinite(out["u"]).all(), "sharded PCG produced a non-finite solution")
    require(out["rel"] <= 1e-6, f"node-sharded PCG did not converge: rel {out['rel']:.2e}")
    rec["node_sharded"] = (out["iters"], out["rel"])
    stage(f"STAGE 2/5 PASSED: node-sharded pcg CONVERGED {out['iters']} iters "
          f"rel {out['rel']:.2e}")

    # ---- 3, 4: halo-exchange PCG, uneven slabs (span stations not a multiple of n)
    res = WingMeshResolution(12, 2 * n + 1, 2)
    for k, element in ((3, "tet4"), (4, "tet10")):
        stage(f"STAGE {k}/5 starting: halo-exchange PCG ({element}, uneven slabs)")
        out = halo_solve(group, res, WING, element=element, pressure=100.0, tol=1e-8,
                         maxiter=30000)
        require(np.isfinite(out["u"]).all(), f"halo PCG {element} produced a non-finite solution")
        require(out["rel"] <= 1e-8, f"halo PCG {element} did not converge: rel {out['rel']:.2e}")
        rec[f"halo_{element}"] = (out["iters"], out["rel"])
        stage(f"STAGE {k}/5 PASSED: halo {element} (uneven slabs) CONVERGED {out['iters']} "
              f"iters rel {out['rel']:.2e}")

    # ---- 5: the sharded multigrid, tet10
    res_fs = res5 or WingMeshResolution(32, 40 if 40 % n == 0 else 5 * n, 4, 0.006, "le")
    dof = 3 * grid_meta2(res_fs)["num_nodes"]
    tag = f"{dof} DOF, {res_fs.n_chord}x{res_fs.n_span}x{res_fs.n_thick}"
    stage(f"STAGE 5/5 starting: sharded-MG tet10 ({tag})")
    out = sharded_solve(group, res_fs, "tet10", torch.float64, (1.6, 0.4, 20.0, 0.10),
                        pressure=5e3, tol=1e-6, maxiter=600)
    require(np.isfinite(out["u"]).all(), "sharded-MG tet10 produced a non-finite solution")
    require(out["rel"] <= 1e-6, f"sharded-MG tet10 did not converge: rel {out['rel']:.2e}")
    require(out["iters"] < 400, f"sharded-MG tet10 lost MG-class convergence: {out['iters']}")
    rec["sharded_mg_tet10"] = (out["iters"], out["rel"], dof)
    stage(f"STAGE 5/5 PASSED: SHARDED-MG tet10 ({tag}) CONVERGED {out['iters']} iters "
          f"rel {out['rel']:.2e}")
    rec["launches"] = {k: f.launches for k, f in counters.items()}
    return rec


def dryrun_multichip(n: int, backend: str | None = None, device="cuda",
                     timeout_s: float = 900.0) -> dict:
    """The five stages on n ranks (spawned by run_ranks); returns rank 0's
    record. Raises on the first stage that fails."""
    env = os.environ.get("TPUFEM_DRYRUN_RES")
    res5 = None
    if env:
        from tpufem_torch.mesher import WingMeshResolution

        nc, ns, nt = (int(v) for v in env.split(","))
        res5 = WingMeshResolution(nc, ns, nt, 0.006, "le")
    dev = device_arg(device)
    outs = run_ranks(dryrun_rank, n, backend or default_backend(dev), dev.type,
                     args=(n, res5), timeout_s=timeout_s)
    rec = outs[0]
    print(f"dryrun_multichip({n}) ok: dp losses {rec['dp_losses']}; "
          f"node-sharded pcg {rec['node_sharded']}; halo tet4 {rec['halo_tet4']}; "
          f"halo tet10 {rec['halo_tet10']}; sharded-MG tet10 {rec['sharded_mg_tet10']}",
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks (default cuda; raises without one)")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.backend, args.device, args.timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
