"""Mesh stage driver — port of ``tpufem/pipeline/mesh_stage.py`` (reference
meshing.py:602-753), structured path.

Artifacts in data/raw/mesh/{case_id}/:
  mesh.npz            — nodes/tets/surf_faces (+ thickness-line structure)
  boundary_sets.json  — NROOT / SURF_ALL / SURF_UPPER (+ tuning info)
  mesh_report.json    — StepReport with node/tet counts, quality stats and
                        extra.resolution (the FEM stage reads it)

Guardrails preserved (meshing.py:597-599): fail if >500k nodes or >2.5M tets,
warn if quality_ok_ratio < 0.8. Not ported yet: the debug ``surf_sets.glb``
and the ingestion of a user Gmsh MSH2 file (tpufem/msh2.py).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpufem_torch.mesh_types import Mesh
from tpufem_torch.mesher import (
    MEDIUM,
    WingMeshResolution,
    compute_tet_quality,
    structured_wing_mesh,
    wing_topology,
)
from tpufem_torch.pipeline.config import Paths
from tpufem_torch.pipeline.reports import timed, write_report
from tpufem_torch.pipeline.types import StepReport, WingParams
from tpufem_torch.sets import build_boundary_sets

MAX_NODES = 500_000
MAX_TETS = 2_500_000
QUALITY_WARN_RATIO = 0.8


def save_mesh_npz(path: Path, mesh: Mesh) -> None:
    extra = {}
    meta = mesh.meta or {}
    if "station_id" in meta:  # thickness-line structure for the preconditioner
        extra = {
            "station_id": meta["station_id"],
            "slot": meta["slot"],
            "station_dims": np.array(
                [meta["num_stations"], meta["slots_per_station"]], dtype=np.int64
            ),
        }
    np.savez_compressed(
        path, nodes=mesh.nodes, tets=mesh.tets, surf_faces=mesh.surf_faces, **extra
    )


def load_mesh_npz(path: Path) -> Mesh:
    z = np.load(path)
    meta = {}
    if "station_id" in z.files:
        meta = {
            "station_id": z["station_id"],
            "slot": z["slot"],
            "num_stations": int(z["station_dims"][0]),
            "slots_per_station": int(z["station_dims"][1]),
        }
    return Mesh(nodes=z["nodes"], tets=z["tets"], surf_faces=z["surf_faces"], meta=meta)


def run_mesh_case(
    params: WingParams,
    case_id: str,
    paths: Paths,
    resolution: WingMeshResolution = MEDIUM,
    force: bool = False,
    y_tol: float = 1e-4,
    nz_min: float = 0.2,
) -> StepReport:
    """Mesh stage: the structured parametric wing mesh at `resolution`."""
    case_dir = paths.mesh_case(case_id)
    case_dir.mkdir(parents=True, exist_ok=True)
    mesh_path = case_dir / "mesh.npz"
    sets_path = case_dir / "boundary_sets.json"
    extra: dict = {}

    with timed() as t:
        try:
            cached = None
            if mesh_path.exists() and sets_path.exists() and not force:
                cached = load_mesh_npz(mesh_path)
                # a cached mesh is a hit only at the REQUESTED resolution:
                # structured node counts are a function of the resolution
                # alone, so a mismatch means a different-resolution mesh
                expected = wing_topology(resolution).num_nodes
                if "station_id" in cached.meta and expected != cached.num_nodes:
                    extra["cache_invalidated"] = (
                        f"cached mesh has {cached.num_nodes} nodes; "
                        f"resolution {resolution.key} expects {expected}"
                    )
                    cached = None
            if cached is not None:
                extra["cache_hit"] = True
                mesh = cached
                quality = compute_tet_quality(mesh)
            else:
                mesh = structured_wing_mesh(
                    params.span_m,
                    params.chord_m,
                    params.sweep_deg,
                    params.thickness_ratio,
                    resolution,
                )
                if mesh.num_nodes > MAX_NODES:
                    raise ValueError(f"mesh too large: {mesh.num_nodes} nodes > {MAX_NODES}")
                if mesh.num_tets > MAX_TETS:
                    raise ValueError(f"mesh too large: {mesh.num_tets} tets > {MAX_TETS}")
                mesh.validate()
                quality = compute_tet_quality(mesh)
                bs = build_boundary_sets(mesh, y_tol=y_tol, nz_min=nz_min)
                save_mesh_npz(mesh_path, mesh)
                sets_path.write_text(json.dumps(bs.to_json_dict(mesh)))
                extra["boundary"] = {
                    "nroot_count": int(len(bs.nroot_nodes)),
                    "upper_face_count": int(len(bs.surf_upper_faces)),
                    "upper_area_ratio": bs.upper_area_ratio,
                    "nz_min_used": bs.nz_min_used,
                }
            extra["num_nodes"] = mesh.num_nodes
            extra["num_tets"] = mesh.num_tets
            extra["num_surf_faces"] = mesh.num_surf_faces
            extra["quality"] = quality
            extra["quality_warning"] = quality["quality_ok_ratio"] < QUALITY_WARN_RATIO
            extra["resolution"] = list(resolution.key)
            status, reason = "success", None
        except Exception as e:  # noqa: BLE001
            status, reason = "failed", f"{type(e).__name__}: {e}"

    artifacts = {
        k: str(p)
        for k, p in {"mesh_npz": mesh_path, "boundary_sets": sets_path}.items()
        if p.exists()
    }
    report = StepReport(
        case_id=case_id,
        step="mesh",
        status=status,
        failure_reason=reason,
        elapsed_ms=t["elapsed_ms"],
        artifacts=artifacts,
        extra=extra,
    )
    write_report(case_dir, report)
    return report
