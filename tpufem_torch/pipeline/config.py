"""Project paths and pipeline version — copy of ``tpufem/pipeline/config.py``.

Parity with reference src/deep_fem_uav_wing/config.py:7-36: a project-root-relative
data layout ``data/raw/{geometry,mesh,fem}/{case_id}/`` plus processed/model dirs,
and a PIPELINE_VERSION constant baked into case ids.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

# Baked into every case id (reference config.py:7). Bump on any change that
# invalidates previously generated artifacts.
PIPELINE_VERSION = "tpu-v0.1.0"


def _project_root() -> Path:
    env = os.environ.get("TPUFEM_DATA_ROOT")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Paths:
    """Data directory layout (reference config.py:11-32)."""

    root: Path = field(default_factory=_project_root)

    @property
    def data(self) -> Path:
        return self.root / "data"

    @property
    def raw(self) -> Path:
        return self.data / "raw"

    @property
    def geometry(self) -> Path:
        return self.raw / "geometry"

    @property
    def mesh(self) -> Path:
        return self.raw / "mesh"

    @property
    def fem(self) -> Path:
        return self.raw / "fem"

    @property
    def processed(self) -> Path:
        return self.data / "processed"

    @property
    def models(self) -> Path:
        return self.data / "models"

    @property
    def manifest(self) -> Path:
        return self.data / "manifest.json"

    def geometry_case(self, case_id: str) -> Path:
        return self.geometry / case_id

    def mesh_case(self, case_id: str) -> Path:
        return self.mesh / case_id

    def fem_case(self, case_id: str) -> Path:
        return self.fem / case_id

    def ensure(self) -> "Paths":
        for p in (self.geometry, self.mesh, self.fem, self.processed, self.models):
            p.mkdir(parents=True, exist_ok=True)
        return self


def get_paths(root: Path | str | None = None) -> Paths:
    """Return the path layout, optionally anchored at an explicit root."""
    if root is None:
        return Paths()
    return Paths(root=Path(root))
