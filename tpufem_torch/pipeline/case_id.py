"""Content-addressed case identity — copy of ``tpufem/pipeline/case_id.py``
(the port's ids equal tpufem's).

Parity with reference src/deep_fem_uav_wing/case_id.py:15-30: wing parameters are
quantized (lengths to 1e-3 m, sweep to 0.1 deg, thickness ratio to 1e-4) so that
float jitter does not fork case directories, then hashed together with the
pipeline version to a sha256[:16] hex id.
"""

from __future__ import annotations

import hashlib
import json
from typing import Mapping

from tpufem_torch.pipeline.config import PIPELINE_VERSION


def normalize_params(params: Mapping[str, float]) -> dict[str, float]:
    """Quantize wing parameters to canonical precision (reference case_id.py:15-21)."""
    return {
        "span_m": round(float(params["span_m"]), 3),
        "chord_m": round(float(params["chord_m"]), 3),
        "sweep_deg": round(float(params["sweep_deg"]), 1),
        "thickness_ratio": round(float(params["thickness_ratio"]), 4),
    }


def compute_case_id(params: Mapping[str, float], version: str = PIPELINE_VERSION) -> str:
    """sha256(json(normalized params) + version)[:16] (reference case_id.py:24-30)."""
    norm = normalize_params(params)
    payload = json.dumps({"params": norm, "version": version}, sort_keys=True)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]
