"""Schemas for wing parameters and stage reports — port of
``tpufem/pipeline/types.py`` without pydantic.

``WingParams``, ``ParamsFile`` and ``StepReport`` are dataclasses with the
same fields, defaults and range checks (``gt=0`` / ``ge=0`` raise
``ValueError``). ``to_json()`` writes exactly the text of pydantic's
``model_dump_json(indent=2)``, so tpufem's models parse the port's
``params.json`` / ``*_report.json`` and ``from_json`` parses tpufem's.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, fields
from decimal import Decimal
from typing import Any, Optional

# PRD sampling ranges (reference generate_geometry_dataset.py:25-30, docs/prd.md).
PRD_RANGES: dict[str, tuple[float, float]] = {
    "span_m": (1.0, 2.0),
    "chord_m": (0.2, 0.5),
    "sweep_deg": (0.0, 30.0),
    "thickness_ratio": (0.05, 0.15),
}


def _float_json(x: float) -> str:
    """A float as pydantic-core (serde_json, ryu) writes it: the shortest
    round-trip digits, which Python's repr also gives, laid out by ryu's
    rules (plain notation for decimal exponents -5 < kk <= 16, else
    ``d.ddde<exp>`` with no '+'); inf and nan become null."""
    if not math.isfinite(x):
        return "null"
    sign, digits, exp = Decimal(repr(x)).as_tuple()
    ds = "".join(map(str, digits)).rstrip("0")
    exp += len(digits) - len(ds)
    if not ds:  # zero
        return "-0.0" if sign else "0.0"
    n = len(ds)
    kk = n + exp  # 10**(kk-1) <= |x| < 10**kk
    if 0 <= exp and kk <= 16:
        body = ds + "0" * exp + ".0"
    elif 0 < kk <= 16:
        body = ds[:kk] + "." + ds[kk:]
    elif -5 < kk <= 0:
        body = "0." + "0" * -kk + ds
    elif n == 1:
        body = f"{ds}e{kk - 1}"
    else:
        body = f"{ds[0]}.{ds[1:]}e{kk - 1}"
    return ("-" if sign else "") + body


def _dump(v: Any, indent: str) -> str:
    """JSON text of v with pydantic's indent=2 layout."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(int(v))
    if isinstance(v, float):
        return _float_json(float(v))
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    inner = indent + "  "
    if isinstance(v, dict):
        if not v:
            return "{}"
        items = [f"{inner}{json.dumps(str(k), ensure_ascii=False)}: {_dump(x, inner)}"
                 for k, x in v.items()]
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(v, (list, tuple)):
        if not v:
            return "[]"
        return "[\n" + ",\n".join(inner + _dump(x, inner) for x in v) + "\n" + indent + "]"
    if hasattr(v, "tolist"):  # numpy arrays and scalars
        return _dump(v.tolist(), indent)
    raise TypeError(f"cannot serialize {type(v).__name__} to JSON")


class _Schema:
    """as_json_dict / to_json / from_json for the dataclasses below."""

    def as_json_dict(self) -> dict:
        return {f.name: (getattr(self, f.name).as_json_dict()
                         if isinstance(getattr(self, f.name), _Schema)
                         else getattr(self, f.name))
                for f in fields(self)}

    def to_json(self) -> str:
        """The text of pydantic's ``model_dump_json(indent=2)``."""
        return _dump(self.as_json_dict(), "")

    @classmethod
    def from_json(cls, text: str):
        return cls(**json.loads(text))


@dataclass
class WingParams(_Schema):
    """Wing design parameters (reference types.py:9-13, validated ranges)."""

    span_m: float
    chord_m: float
    sweep_deg: float
    thickness_ratio: float

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, float(getattr(self, f.name)))
        for name in ("span_m", "chord_m", "thickness_ratio"):
            if not getattr(self, name) > 0:
                raise ValueError(f"{name} must be > 0, got {getattr(self, name)}")
        if not self.sweep_deg >= 0:
            raise ValueError(f"sweep_deg must be >= 0, got {self.sweep_deg}")

    def as_dict(self) -> dict[str, float]:
        return {
            "span_m": self.span_m,
            "chord_m": self.chord_m,
            "sweep_deg": self.sweep_deg,
            "thickness_ratio": self.thickness_ratio,
        }


@dataclass
class ParamsFile(_Schema):
    """params.json schema written into every geometry case dir."""

    case_id: str
    params: WingParams
    pipeline_version: str
    source: str = "tpufem"  # geometry backend that produced wing.stl

    def __post_init__(self):
        if isinstance(self.params, dict):
            self.params = WingParams(**self.params)


@dataclass
class StepReport(_Schema):
    """Uniform per-stage report (reference types.py:33-39); every stage emits
    one as ``*_report.json``. ``stdout_tail``-style fields are kept for
    schema parity."""

    case_id: str
    step: str
    status: str  # "success" | "failed"
    failure_reason: Optional[str] = None
    elapsed_ms: float = 0.0
    stdout_tail: str = ""
    stderr_tail: str = ""
    artifacts: dict[str, str] = field(default_factory=dict)
    extra: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.status not in ("success", "failed"):
            raise ValueError(f"status must be 'success' or 'failed', got {self.status!r}")
        self.elapsed_ms = float(self.elapsed_ms)
