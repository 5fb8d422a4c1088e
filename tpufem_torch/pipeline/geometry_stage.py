"""Geometry stage driver — port of ``tpufem/pipeline/geometry_stage.py``
(reference geometry.py:110-228, pipeline_geometry.py:19-88).

Artifacts in data/raw/geometry/{case_id}/:
  wing.stl           — watertight wing surface (numpy loft)
  params.json        — ParamsFile (case id, params, pipeline version, source)
  geometry_report.json
  wing_viz.glb       — gray preview GLB

Cache semantics preserved: wing.stl+params.json present -> short-circuit;
the GLB has its own cache hit; `force` rebuilds; a user-supplied STL can be
ingested instead of the loft (geometry.py:159-174).
"""

from __future__ import annotations

import shutil
from pathlib import Path

from tpufem_torch.geometry import generate_wing_surface, surface_is_watertight
from tpufem_torch.pipeline.case_id import compute_case_id
from tpufem_torch.pipeline.config import PIPELINE_VERSION, Paths
from tpufem_torch.pipeline.reports import timed, write_report
from tpufem_torch.pipeline.types import ParamsFile, StepReport, WingParams
from tpufem_torch.utils.stl import write_stl
from tpufem_torch.viz.results import stl_to_glb


def run_geometry_case(
    params: WingParams,
    paths: Paths,
    case_id: str | None = None,
    force: bool = False,
    user_stl: Path | None = None,
    n_chord: int = 48,
    n_span: int = 16,
    make_glb: bool = True,
) -> StepReport:
    case_id = case_id or compute_case_id(params.as_dict())
    case_dir = paths.geometry_case(case_id)
    case_dir.mkdir(parents=True, exist_ok=True)
    stl_path = case_dir / "wing.stl"
    params_path = case_dir / "params.json"
    glb_path = case_dir / "wing_viz.glb"

    with timed() as t:
        try:
            cache_hit = stl_path.exists() and params_path.exists() and not force
            if not cache_hit:
                if user_stl is not None:
                    shutil.copyfile(user_stl, stl_path)
                    source = "user_stl"
                else:
                    surf = generate_wing_surface(
                        params.span_m,
                        params.chord_m,
                        params.sweep_deg,
                        params.thickness_ratio,
                        n_chord=n_chord,
                        n_span=n_span,
                    )
                    if not surface_is_watertight(surf):
                        raise ValueError("generated loft is not watertight")
                    write_stl(stl_path, surf.vertices, surf.faces)
                    source = "tpufem_loft"  # the same loft as tpufem's, so the same name
                pf = ParamsFile(
                    case_id=case_id,
                    params=params,
                    pipeline_version=PIPELINE_VERSION,
                    source=source,
                )
                params_path.write_text(pf.to_json())
            if make_glb and (force or not glb_path.exists()):
                stl_to_glb(stl_path, glb_path)
            status, reason = "success", None
        except Exception as e:  # noqa: BLE001 — stage reports failures, never raises
            status, reason = "failed", f"{type(e).__name__}: {e}"

    artifacts = {
        k: str(p)
        for k, p in {
            "wing_stl": stl_path,
            "params_json": params_path,
            "wing_viz_glb": glb_path,
        }.items()
        if p.exists()
    }
    report = StepReport(
        case_id=case_id,
        step="geometry",
        status=status,
        failure_reason=reason,
        elapsed_ms=t["elapsed_ms"],
        artifacts=artifacts,
        extra={"cache_hit": bool(stl_path.exists() and not force)},
    )
    write_report(case_dir, report)
    return report
