"""Dataset QA / validation — port of ``tpufem/pipeline/validate.py``
(parity with reference validate_dataset.py).

Per-case cross-stage checks (reference :255-384): reports present + success,
mesh size/quality bounds, root-node count 10-500, upper area ratio 0.3-0.7,
stress <= 1000 MPa, displacement <= 1 m, npz nan/inf re-scan. Aggregate stats +
a PRD checklist (:497-520); writes validation_report.json and merges a summary
into manifest.json (:547-603). Tool-version probes become environment probes
(torch, CUDA and the card's name) since there are no external binaries to
probe.

CLI: ``python -m tpufem_torch.scripts.validate_dataset`` exits nonzero if any
checklist item fails (reference :669-680).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, asdict

import numpy as np

from tpufem_torch.pipeline.config import Paths
from tpufem_torch.pipeline.reports import read_csv_rows, update_manifest


@dataclass
class ValidationThresholds:
    """Reference validate_dataset.py:178-192."""

    min_solved_cases: int = 200
    min_root_nodes: int = 10
    max_root_nodes: int = 2000
    min_upper_ratio: float = 0.3
    max_upper_ratio: float = 0.7
    min_quality_ok_ratio: float = 0.0  # structured anisotropic mesh: report-only
    max_stress_mpa: float = 1000.0
    max_disp_m: float = 1.0
    min_nodes: int = 300
    max_nodes: int = 500_000
    min_tets: int = 1_000
    max_tets: int = 2_500_000


def probe_environment() -> dict:
    """Environment probes (replaces gmsh/ccx/blender version probes,
    reference validate_dataset.py:48-169): torch, its CUDA and the cards."""
    import torch

    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
           if torch.cuda.is_available() else [],
           "numpy": np.__version__}
    return out


def validate_case(case_id: str, paths: Paths, thr: ValidationThresholds) -> dict:
    """Cross-stage validation of one case; returns {'ok': bool, 'issues': [...]}."""
    issues: list[str] = []
    info: dict = {"case_id": case_id}

    geo_dir = paths.geometry_case(case_id)
    mesh_dir = paths.mesh_case(case_id)
    fem_dir = paths.fem_case(case_id)

    for stage, d, fname in (
        ("geometry", geo_dir, "geometry_report.json"),
        ("mesh", mesh_dir, "mesh_report.json"),
        ("fem", fem_dir, "fem_report.json"),
    ):
        p = d / fname
        if not p.exists():
            issues.append(f"{stage}: report missing")
            continue
        rep = json.loads(p.read_text())
        if rep.get("status") != "success":
            issues.append(f"{stage}: status={rep.get('status')} ({rep.get('failure_reason')})")
        info[f"{stage}_report"] = {
            "status": rep.get("status"),
            "elapsed_ms": rep.get("elapsed_ms"),
        }

    mesh_rep_p = mesh_dir / "mesh_report.json"
    if mesh_rep_p.exists():
        extra = json.loads(mesh_rep_p.read_text()).get("extra", {})
        n, t = extra.get("num_nodes", 0), extra.get("num_tets", 0)
        if not (thr.min_nodes <= n <= thr.max_nodes):
            issues.append(f"mesh: node count {n} outside [{thr.min_nodes},{thr.max_nodes}]")
        if not (thr.min_tets <= t <= thr.max_tets):
            issues.append(f"mesh: tet count {t} outside [{thr.min_tets},{thr.max_tets}]")
        q = extra.get("quality", {}).get("quality_ok_ratio")
        if q is not None and q < thr.min_quality_ok_ratio:
            issues.append(f"mesh: quality_ok_ratio {q:.2f} < {thr.min_quality_ok_ratio}")
        b = extra.get("boundary", {})
        nroot = b.get("nroot_count")
        if nroot is not None and not (thr.min_root_nodes <= nroot <= thr.max_root_nodes):
            issues.append(f"mesh: NROOT count {nroot} outside bounds")
        ratio = b.get("upper_area_ratio")
        if ratio is not None and not (thr.min_upper_ratio <= ratio <= thr.max_upper_ratio):
            issues.append(f"mesh: upper area ratio {ratio:.2f} outside bounds")
        info["mesh"] = {"num_nodes": n, "num_tets": t, "quality_ok_ratio": q}

    npz_p = fem_dir / "surface_results.npz"
    if npz_p.exists():
        z = np.load(npz_p)
        vm = z["stress_vm"]
        disp = z["disp"]
        if not np.isfinite(vm).all() or not np.isfinite(disp).all():
            issues.append("fem: nan/inf in surface_results.npz")
        max_mpa = float(vm.max()) / 1e6 if len(vm) else 0.0
        max_disp = float(np.abs(disp).max()) if len(disp) else 0.0
        if max_mpa > thr.max_stress_mpa:
            issues.append(f"fem: max stress {max_mpa:.1f} MPa > {thr.max_stress_mpa}")
        if max_disp > thr.max_disp_m:
            issues.append(f"fem: max |disp| {max_disp:.3f} m > {thr.max_disp_m}")
        info["fem"] = {"max_stress_mpa": max_mpa, "max_disp_m": max_disp}
    else:
        issues.append("fem: surface_results.npz missing")

    info["ok"] = not issues
    info["issues"] = issues
    return info


def run_validation(paths: Paths, thr: ValidationThresholds | None = None) -> dict:
    """Validate every case that reached the FEM stage; write validation_report.json."""
    thr = thr or ValidationThresholds()
    fem_rows = read_csv_rows(paths.data / "fem.csv")
    solved = sorted({r["case_id"] for r in fem_rows if r["status"] == "success"})
    cases = [validate_case(cid, paths, thr) for cid in solved]
    ok = [c for c in cases if c["ok"]]

    stress = [c["fem"]["max_stress_mpa"] for c in cases if "fem" in c]
    checklist = {
        "enough_solved_cases": len(ok) >= thr.min_solved_cases,
        "all_reports_success": all(c["ok"] for c in cases) if cases else False,
        "no_nan_inf": not any("nan/inf" in i for c in cases for i in c["issues"]),
        "stress_in_bounds": not any("max stress" in i for c in cases for i in c["issues"]),
        "disp_in_bounds": not any("max |disp|" in i for c in cases for i in c["issues"]),
        "mesh_sizes_in_bounds": not any(
            "count" in i and "mesh" in i for c in cases for i in c["issues"]
        ),
        "boundary_sets_in_bounds": not any(
            ("NROOT" in i) or ("upper area" in i) for c in cases for i in c["issues"]
        ),
    }
    report = {
        "environment": probe_environment(),
        "thresholds": asdict(thr),
        "num_cases": len(cases),
        "num_ok": len(ok),
        "checklist": checklist,
        "all_passed": all(checklist.values()),
        "aggregate": {
            "max_stress_mpa_p50": float(np.percentile(stress, 50)) if stress else 0.0,
            "max_stress_mpa_max": float(max(stress)) if stress else 0.0,
        },
        "cases": cases,
    }
    out = paths.data / "validation_report.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    update_manifest(
        paths.manifest,
        "validation",
        {
            "num_cases": len(cases),
            "num_ok": len(ok),
            "checklist": checklist,
            "all_passed": report["all_passed"],
        },
    )
    return report
