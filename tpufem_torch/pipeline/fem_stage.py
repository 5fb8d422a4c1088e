"""FEM stage driver — port of ``tpufem/pipeline/fem_stage.py`` (reference
fem.py:427-762), stencil engine.

Artifacts in data/raw/fem/{case_id}/:
  surface_results.npz  — node_id/pos/normal/stress_vm/disp/loss_mask
  fem_report.json      — StepReport with solver info + all/masked percentile
                         stress stats (fem.py:695-751)

The solve is the port's WingStencilT (f64-outer MG-PCG, kernel B on the
card) at B=1. Not ported yet: the result/arrow GLBs (the CLIs refuse to run
without --no_glb) and the non-stencil rungs of tpufem's solve ladder (the
gather driver, its refined and float64 retries; ROADMAP Queue 1 item 8). A
case that would take one of those rungs fails with a reason that says so; it
never falls back silently.
"""

from __future__ import annotations

import json
import time
from functools import lru_cache

import numpy as np

from tpufem_torch.fem.driver import FemSolution, WingSolveConfig, surface_results
from tpufem_torch.fem.material import Material
from tpufem_torch.fem.stencil_mg import WingStencilT, hierarchy_resolutions
from tpufem_torch.mesher import WingMeshResolution, wing_topology
from tpufem_torch.pipeline.config import Paths
from tpufem_torch.pipeline.mesh_stage import load_mesh_npz
from tpufem_torch.pipeline.reports import timed, write_report
from tpufem_torch.pipeline.types import StepReport, WingParams
from tpufem_torch.sets import BoundarySets

LADDER_NOT_PORTED = ("the gather-driver rungs of the solve ladder (tpufem/fem/driver.py) "
                     "are not ported to tpufem_torch yet")


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


def solver_stats(iters: int, rel_residual: float, converged: bool) -> dict:
    return {"iters": int(iters), "rel_residual": float(rel_residual),
            "converged": bool(converged)}


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


def write_case_artifacts(case_dir, surf: dict) -> dict:
    """Write surface_results.npz and return the report's stats blocks — the
    one writer the sequential and the batched paths both call, so every case
    dir carries the same artifact and stats schema (fem.py:642-751)."""
    np.savez_compressed(case_dir / "surface_results.npz", **surf)
    masked = surf["stress_vm"][surf["loss_mask"]]
    return {
        "stress_stats": {
            "all_nodes": _stats(surf["stress_vm"]),
            "masked_nodes": _stats(masked),
        },
        "disp_stats": {
            "max_abs_mm": float(np.abs(surf["disp"]).max() * 1e3),
            "mean_z_mm": float(surf["disp"][:, 2].mean() * 1e3),
        },
    }


def run_fem_case(
    params: WingParams,
    case_id: str,
    paths: Paths,
    pressure: float = 5e3,
    material: Material = Material(),
    solve_config: WingSolveConfig | None = None,
    force: bool = False,
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
                # the ladder's first rung: the stencil-grid MG engine (B=1)
                # for structured wing meshes; every later rung is not ported
                res = _stencil_resolution(paths, case_id)
                if res is not None and wing_topology(res).num_nodes != mesh.num_nodes:
                    res = None  # user mesh under a stale report
                if res is None:
                    raise NotImplementedError(
                        f"case needs a non-stencil solve: {LADDER_NOT_PORTED}")
                t0 = time.perf_counter()
                sol = solve_structured_stencil(params, res, cfg, device)
                extra["spans"] = {"solve_stencil_ms": round((time.perf_counter() - t0) * 1e3, 3)}
                if not np.isfinite(sol.u).all() or not np.isfinite(sol.vm).all():
                    raise ValueError(f"nan/inf in solution; {LADDER_NOT_PORTED}")
                if not sol.converged:
                    raise ValueError(
                        f"PCG not converged: rel_res {sol.rel_residual:.2e} after "
                        f"{sol.iters} iters; {LADDER_NOT_PORTED}"
                    )
                surf = surface_results(mesh, bs, sol, span_m=params.span_m)
                extra.update(write_case_artifacts(case_dir, surf))
                extra["solver"] = solver_stats(sol.iters, sol.rel_residual, sol.converged)
            status, reason = "success", None
        except Exception as e:  # noqa: BLE001 — stage reports failures, never raises
            status, reason = "failed", f"{type(e).__name__}: {e}"

    report = StepReport(
        case_id=case_id,
        step="fem",
        status=status,
        failure_reason=reason,
        elapsed_ms=t["elapsed_ms"],
        artifacts={"surface_results": str(npz_path)} if npz_path.exists() else {},
        extra=extra,
    )
    write_report(case_dir, report)
    return report
