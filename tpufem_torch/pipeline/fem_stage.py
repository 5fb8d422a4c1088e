"""FEM stage driver — port of ``tpufem/pipeline/fem_stage.py`` (reference
fem.py:427-762, ``run_fem_case``).

Artifacts in data/raw/fem/{case_id}/:
  surface_results.npz    — node_id/pos/normal/stress_vm/disp/loss_mask
  wing_result.glb        — viridis-colored stress GLB
  wing_result_arrows.glb — result + sampled pressure arrows
  fem_report.json        — StepReport with solver info + all/masked percentile
                           stress stats (fem.py:695-751)

The solve goes down tpufem's ladder, every rung on `device`: "stencil" (the
port's WingStencilT at B=1, f64-outer MG-PCG with kernel B, for structured
meshes when engine is auto or stencil), then the gather path
(``solve_wing_case``: kernel D, one launch per CG iteration) as "primary"
(the config's dtype, line + RBM or Jacobi PCG), "refined" (f32 CG with f64
residual refinement) and "float64". A rung that does not converge, or whose
solution is not finite, hands over to the next: a numerical recovery, not a
device fallback. A kernel that fails to build or launch raises.
"""

from __future__ import annotations

import dataclasses
import json
from functools import lru_cache

import numpy as np
import torch

from tpufem_torch.fem.driver import FemSolution, WingSolveConfig, solve_wing_case, surface_results
from tpufem_torch.fem.material import Material
from tpufem_torch.fem.precond import NotPositiveDefiniteError
from tpufem_torch.fem.stencil_mg import WingStencilT, hierarchy_resolutions
from tpufem_torch.mesher import WingMeshResolution, wing_topology
from tpufem_torch.pipeline.config import Paths
from tpufem_torch.pipeline.mesh_stage import load_mesh_npz
from tpufem_torch.pipeline.reports import timed, write_report
from tpufem_torch.pipeline.types import StepReport, WingParams
from tpufem_torch.sets import BoundarySets
from tpufem_torch.utils.profiling import StageTimer, solver_stats
from tpufem_torch.viz.arrows import make_pressure_arrows
from tpufem_torch.viz.glb import GLBMesh
from tpufem_torch.viz.results import surface_results_to_glb, surface_results_to_glb_with_extras


def _stats(values: np.ndarray) -> dict:
    """min/max/mean/std/p50/p95/p99 block (reference fem.py:724-743)."""
    if len(values) == 0:
        return {k: 0.0 for k in ("min", "max", "mean", "std", "p50", "p95", "p99")}
    return {
        "min": float(values.min()),
        "max": float(values.max()),
        "mean": float(values.mean()),
        "std": float(values.std()),
        "p50": float(np.percentile(values, 50)),
        "p95": float(np.percentile(values, 95)),
        "p99": float(np.percentile(values, 99)),
    }


def _stencil_resolution(paths: Paths, case_id: str):
    """WingMeshResolution recorded by the mesh stage, if the stencil MG
    engine supports it (a real coarsening hierarchy with a small dense
    coarsest); None otherwise."""
    rep_path = paths.mesh_case(case_id) / "mesh_report.json"
    try:
        rep = json.loads(rep_path.read_text())
        res = WingMeshResolution(*rep["extra"]["resolution"])
    except (OSError, KeyError, TypeError, ValueError):
        return None
    levels = hierarchy_resolutions(res)
    if len(levels) < 2 or wing_topology(levels[-1]).num_nodes > 2000:
        return None  # dense coarsest would be the whole system
    return res


@lru_cache(maxsize=4)
def stencil_engine(res: WingMeshResolution, device: str) -> WingStencilT:
    """The stencil engine for one resolution on one device, built once."""
    return WingStencilT(res, device=device)


def solve_structured_stencil(
    params: WingParams, res: WingMeshResolution, config: WingSolveConfig, device: str
) -> FemSolution:
    """Single-case solve through the stencil-grid MG engine (B=1) on `device`."""
    p4 = np.array(
        [[params.span_m, params.chord_m, params.sweep_deg, params.thickness_ratio]],
        dtype=np.float64,  # exact params: solve() derives its f64 system from these
    )
    out = stencil_engine(res, str(device)).solve(
        p4, pressure=config.pressure, material=config.material,
        tol=config.tol, maxiter=config.maxiter,
    )
    return FemSolution(
        u=out.u[:, :, 0].cpu().numpy(),
        stress6=out.stress6[:, :, 0].cpu().numpy(),
        vm=out.vm[:, 0].cpu().numpy(),
        iters=int(out.iters),
        rel_residual=float(out.rel_residual[0]),
        converged=bool(out.converged[0]),
    )


def write_case_artifacts(
    case_dir,
    case_id: str,
    surf: dict,
    faces_global: np.ndarray,
    upper_faces_global: np.ndarray,
    nodes: np.ndarray,
    make_glb: bool = True,
) -> dict:
    """Write the per-case FEM artifact set and return the report blocks: the
    one writer the sequential and the batched paths both call, so every case
    dir carries the same artifacts and stats schema (fem.py:642-751)."""
    np.savez_compressed(case_dir / "surface_results.npz", **surf)
    extra: dict = {}
    if make_glb:
        vmin, vmax = surface_results_to_glb(case_dir / "wing_result.glb", surf, faces_global)
        av, af = make_pressure_arrows(nodes, upper_faces_global, case_id)
        arrow_colors = np.tile(np.array([0.9, 0.45, 0.1, 1.0]), (len(av), 1))
        surface_results_to_glb_with_extras(
            case_dir / "wing_result_arrows.glb",
            surf,
            faces_global,
            [GLBMesh(av, af, arrow_colors, name="pressure_arrows")],
            vmin=vmin,
            vmax=vmax,
        )
        extra["color_range"] = [vmin, vmax]
    masked = surf["stress_vm"][surf["loss_mask"]]
    extra["stress_stats"] = {
        "all_nodes": _stats(surf["stress_vm"]),
        "masked_nodes": _stats(masked),
    }
    extra["disp_stats"] = {
        "max_abs_mm": float(np.abs(surf["disp"]).max() * 1e3),
        "mean_z_mm": float(surf["disp"][:, 2].mean() * 1e3),
    }
    return extra


def case_artifacts(case_dir) -> dict:
    """The report's artifacts block: the FEM files that exist in case_dir."""
    return {
        k: str(p)
        for k, p in {
            "surface_results": case_dir / "surface_results.npz",
            "wing_result_glb": case_dir / "wing_result.glb",
            "wing_result_arrows_glb": case_dir / "wing_result_arrows.glb",
        }.items()
        if p.exists()
    }


def solve_ladder(params: WingParams, mesh, bs: BoundarySets, cfg: WingSolveConfig,
                 stencil_res, device, timer: StageTimer):
    """tpufem's recovery ladder (its version of the spec'd retry policy,
    docs/spec.md:240-250): stencil (when `stencil_res`), primary, then for a
    non-f64 config refined and float64. Returns (solution of the last
    attempt, attempts)."""
    ladder = []
    if stencil_res is not None:
        ladder.append(("stencil", cfg,
                       lambda c: solve_structured_stencil(params, stencil_res, c, device)))

    def gather(c):
        return solve_wing_case(mesh, bs, c, device)

    ladder.append(("primary", cfg, gather))
    if cfg.dtype != torch.float64:
        ladder.append(("refined",
                       dataclasses.replace(cfg, refine_steps=max(cfg.refine_steps, 2)), gather))
        ladder.append(("float64", dataclasses.replace(cfg, dtype=torch.float64, refine_steps=0),
                       gather))
    attempts = []
    sol = None
    for name, c, solve_fn in ladder:
        error = None
        with timer.span(f"solve_{name}"):
            try:
                sol = solve_fn(c)
            except NotPositiveDefiniteError as e:  # the preconditioner broke down
                error = str(e)
        if error is None:
            ok = bool(np.isfinite(sol.u).all() and np.isfinite(sol.vm).all() and sol.converged)
            stats = solver_stats(sol.iters, sol.rel_residual, sol.converged)
        else:
            sol = None
            ok = False
            # no CG step was taken: x = 0, so the residual is b itself
            stats = {**solver_stats(0, 1.0, False), "error": error}
        attempts.append({"attempt": name, "dtype": str(c.dtype).removeprefix("torch."),
                         "ok": ok, **stats})
        if ok:
            break
    return sol, attempts


def run_fem_case(
    params: WingParams,
    case_id: str,
    paths: Paths,
    pressure: float = 5e3,
    material: Material = Material(),
    solve_config: WingSolveConfig | None = None,
    force: bool = False,
    make_glb: bool = True,
    device: str = "cuda",
) -> StepReport:
    mesh_dir = paths.mesh_case(case_id)
    case_dir = paths.fem_case(case_id)
    case_dir.mkdir(parents=True, exist_ok=True)
    npz_path = case_dir / "surface_results.npz"
    extra: dict = {"pressure_pa": pressure, "E": material.E, "nu": material.nu}

    with timed() as t:
        try:
            if npz_path.exists() and not force:
                extra["cache_hit"] = True
            else:
                mesh = load_mesh_npz(mesh_dir / "mesh.npz")
                sets_data = json.loads((mesh_dir / "boundary_sets.json").read_text())
                bs = BoundarySets(
                    nroot_nodes=np.asarray(sets_data["nroot_nodes"], dtype=np.int32),
                    surf_all_faces=np.asarray(sets_data["surf_all_faces"], dtype=np.int32),
                    surf_upper_faces=np.asarray(sets_data["surf_upper_faces"], dtype=np.int32),
                    nz_min_used=sets_data["nz_min_used"],
                    upper_area_ratio=sets_data["upper_area_ratio"],
                )
                if len(bs.nroot_nodes) == 0 or len(bs.surf_upper_faces) == 0:
                    raise ValueError("empty NROOT or SURF_UPPER set")

                cfg = solve_config or WingSolveConfig(pressure=pressure, material=material)
                stencil_res = (_stencil_resolution(paths, case_id)
                               if cfg.engine in ("auto", "stencil") else None)
                if stencil_res is not None and (
                        "station_id" not in mesh.meta
                        or wing_topology(stencil_res).num_nodes != mesh.num_nodes):
                    # a user mesh: the stencil engine would solve the
                    # parametric wing of `params`, not this mesh (tpufem
                    # checks the node count alone)
                    stencil_res = None
                timer = StageTimer()
                sol, attempts = solve_ladder(params, mesh, bs, cfg, stencil_res, device, timer)
                if len(attempts) > 1:
                    extra["solve_ladder"] = attempts
                if sol is None:
                    raise ValueError(f"preconditioner breakdown: {attempts[-1]['error']} "
                                     f"(after {len(attempts)} ladder attempts)")
                if not np.isfinite(sol.u).all() or not np.isfinite(sol.vm).all():
                    raise ValueError("nan/inf in solution")  # fem.py:620-631 parity
                if not sol.converged:
                    raise ValueError(
                        f"PCG not converged: rel_res {sol.rel_residual:.2e} after {sol.iters} "
                        f"iters (after {len(attempts)} ladder attempts)"
                    )

                surf = surface_results(mesh, bs, sol, span_m=params.span_m)
                extra.update(
                    write_case_artifacts(
                        case_dir,
                        case_id,
                        surf,
                        mesh.surf_faces[bs.surf_all_faces],
                        mesh.surf_faces[bs.surf_upper_faces],
                        mesh.nodes,
                        make_glb=make_glb,
                    )
                )
                extra["solver"] = solver_stats(sol.iters, sol.rel_residual, sol.converged)
                extra["spans"] = timer.report()
            status, reason = "success", None
        except Exception as e:  # noqa: BLE001 — stage reports failures, never raises
            status, reason = "failed", f"{type(e).__name__}: {e}"

    report = StepReport(
        case_id=case_id,
        step="fem",
        status=status,
        failure_reason=reason,
        elapsed_ms=t["elapsed_ms"],
        artifacts=case_artifacts(case_dir),
        extra=extra,
    )
    write_report(case_dir, report)
    return report
