"""E2E pipeline verification — port of ``tpufem/pipeline/verify.py``: parity
with reference verify_pipeline.py:15-109 plus the two extra spec validation
cases (docs/spec.md:309-353).

    python -m tpufem_torch.pipeline.verify [--data_root DIR] [--easy_only] [--device cuda]

Runs each case geometry -> mesh -> FEM at a small pressure, asserts artifact
existence, prints stress/disp ranges, checks nan/inf, and applies the spec's
physics judgments: downward -Z deflection under upper pressure, root stress
concentration decaying along span. The hard case (max sweep, thinnest section)
is allowed to fail but must record failure_reason (spec.md:341-348).
"""

from __future__ import annotations

import json
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpufem_torch.mesher import MEDIUM, WingMeshResolution
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.fem_stage import run_fem_case
from tpufem_torch.pipeline.geometry_stage import run_geometry_case
from tpufem_torch.pipeline.mesh_stage import run_mesh_case
from tpufem_torch.pipeline.types import WingParams

# Spec validation cases (reference docs/spec.md:309-353).
SPEC_CASES = [
    ("easy", WingParams(span_m=1.2, chord_m=0.35, sweep_deg=0.0, thickness_ratio=0.10), False),
    ("sweep_thin", WingParams(span_m=1.5, chord_m=0.30, sweep_deg=20.0, thickness_ratio=0.08), False),
    ("hard", WingParams(span_m=2.0, chord_m=0.25, sweep_deg=30.0, thickness_ratio=0.05), True),
]


@dataclass
class VerifyResult:
    name: str
    case_id: str
    passed: bool
    allowed_fail: bool
    details: dict


def verify_case(
    name: str,
    params: WingParams,
    paths,
    pressure: float = 100.0,
    resolution: WingMeshResolution = MEDIUM,
    allowed_fail: bool = False,
    device: str = "cuda",
) -> VerifyResult:
    case_id = f"verify_{name}"
    details: dict = {}
    g = run_geometry_case(params, paths, case_id=case_id)
    details["geometry"] = g.status
    if g.status != "success":
        return VerifyResult(name, case_id, False, allowed_fail, details | {"reason": g.failure_reason})
    m = run_mesh_case(params, case_id, paths, resolution=resolution)
    details["mesh"] = m.status
    if m.status != "success":
        return VerifyResult(name, case_id, False, allowed_fail, details | {"reason": m.failure_reason})
    f = run_fem_case(params, case_id, paths, pressure=pressure, device=device)
    details["fem"] = f.status
    if f.status != "success":
        return VerifyResult(name, case_id, False, allowed_fail, details | {"reason": f.failure_reason})

    z = np.load(paths.fem_case(case_id) / "surface_results.npz")
    vm, disp, pos = z["stress_vm"], z["disp"], z["pos"]
    details["stress_range_mpa"] = [float(vm.min()) / 1e6, float(vm.max()) / 1e6]
    details["max_disp_mm"] = float(np.abs(disp).max() * 1e3)
    checks = {
        "finite": bool(np.isfinite(vm).all() and np.isfinite(disp).all()),
        # pressure pushes down on the upper skin -> mean Z displacement negative
        # (spec.md:327-329: ~zero or flipped means a load-direction/sign bug)
        "deflects_down": bool(disp[:, 2].mean() < 0),
    }
    y = pos[:, 1]
    vm_root = vm[y < 0.25 * y.max()].mean()
    vm_tip = vm[y > 0.75 * y.max()].mean()
    checks["root_concentration"] = bool(vm_root > vm_tip)
    details["checks"] = checks
    details["solver"] = f.extra.get("solver", {})
    return VerifyResult(name, case_id, all(checks.values()), allowed_fail, details)


def verify_pipeline(
    data_root: Path | str | None = None,
    pressure: float = 100.0,
    resolution: WingMeshResolution = MEDIUM,
    cases: list | None = None,
    device: str = "cuda",
) -> list[VerifyResult]:
    tmp = None
    if data_root is None:
        tmp = tempfile.mkdtemp(prefix="tpufem_verify_")
        data_root = tmp
    paths = get_paths(data_root).ensure()
    results = []
    for name, params, allowed in cases or SPEC_CASES:
        r = verify_case(name, params, paths, pressure=pressure, resolution=resolution,
                        allowed_fail=allowed, device=device)
        status = "PASS" if r.passed else ("ALLOWED-FAIL" if r.allowed_fail else "FAIL")
        print(f"[{status}] {name}: {json.dumps(r.details, default=str)}")
        results.append(r)
    return results


def main(argv: list[str] | None = None) -> int:
    import argparse

    from tpufem_torch.scripts import device_arg

    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--pressure", type=float, default=100.0)
    ap.add_argument("--easy_only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the FEM solves (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg(args.device)
    cases = SPEC_CASES[:1] if args.easy_only else SPEC_CASES
    results = verify_pipeline(args.data_root, pressure=args.pressure, cases=cases,
                              device=device)
    hard_fail = any(not r.passed and not r.allowed_fail for r in results)
    return 1 if hard_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
