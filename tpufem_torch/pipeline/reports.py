"""Report/CSV/manifest plumbing — the observability contract of the pipeline;
port of ``tpufem/pipeline/reports.py``.

Parity with the reference's artifact telemetry (SURVEY.md §5): per-case
``*_report.json`` StepReports, append-only CSV indexes (params.csv / mesh.csv /
fem.csv) that gate which cases flow to the next stage
(generate_mesh_dataset.py:23-37), and a global manifest.json accumulating stage
indexes, last-run summaries and validation results
(generate_geometry_dataset.py:50-65,153-178).
"""

from __future__ import annotations

import csv
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator

from tpufem_torch.pipeline.types import StepReport


@contextmanager
def timed() -> Iterator[dict]:
    """Context manager yielding a dict that gains 'elapsed_ms' on exit."""
    box: dict = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box["elapsed_ms"] = (time.perf_counter() - t0) * 1e3


def write_report(case_dir: Path, report: StepReport) -> Path:
    case_dir.mkdir(parents=True, exist_ok=True)
    path = case_dir / f"{report.step}_report.json"
    path.write_text(report.to_json())
    return path


def read_report(case_dir: Path, step: str) -> StepReport | None:
    path = case_dir / f"{step}_report.json"
    if not path.exists():
        return None
    return StepReport.from_json(path.read_text())


# ------------------------------------------------------------------ CSV index


def append_csv(path: Path, row: dict[str, Any]) -> None:
    """Append-only CSV index (reference generate_geometry_dataset.py:68-81)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    exists = path.exists()
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            w.writeheader()
        w.writerow({k: _csv_cell(v) for k, v in row.items()})


def read_csv_rows(path: Path) -> list[dict[str, str]]:
    if not path.exists():
        return []
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def success_case_ids(path: Path) -> list[str]:
    """Case ids of success rows — the stage gate (generate_mesh_dataset.py:23-37)."""
    seen: dict[str, str] = {}
    for row in read_csv_rows(path):
        seen[row["case_id"]] = row.get("status", "")
    return [cid for cid, status in seen.items() if status == "success"]


def _csv_cell(v: Any) -> Any:
    if isinstance(v, float):
        return repr(v)
    return v


# ------------------------------------------------------------------- manifest


def update_manifest(manifest_path: Path, section: str, payload: dict) -> dict:
    """Merge a section into manifest.json (reference validate_dataset.py:547-588)."""
    manifest: dict = {}
    if manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
    manifest[section] = payload
    manifest["updated_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    manifest_path.parent.mkdir(parents=True, exist_ok=True)
    manifest_path.write_text(json.dumps(manifest, indent=2))
    return manifest


def append_manifest_index(manifest_path: Path, index_name: str, entries: list[dict]) -> dict:
    manifest: dict = {}
    if manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
    idx = manifest.setdefault(index_name, [])
    known = {e.get("case_id") for e in idx}
    for e in entries:
        if e.get("case_id") not in known:
            idx.append(e)
    manifest["updated_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    manifest_path.write_text(json.dumps(manifest, indent=2))
    return manifest
