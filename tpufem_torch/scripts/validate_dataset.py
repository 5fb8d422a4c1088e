"""Dataset validation CLI — port of ``scripts/validate_dataset.py`` (parity
with reference validate_dataset.py:611-680): runs the full checklist and
exits nonzero if any item fails.

    python -m tpufem_torch.scripts.validate_dataset --data_root DIR
"""

from __future__ import annotations

import argparse

from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.validate import ValidationThresholds, run_validation


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--min_solved", type=int, default=200)
    args = ap.parse_args(argv)

    paths = get_paths(args.data_root)
    thr = ValidationThresholds(min_solved_cases=args.min_solved)
    report = run_validation(paths, thr)
    print(f"cases: {report['num_cases']}  ok: {report['num_ok']}")
    for item, passed in report["checklist"].items():
        print(f"  [{'PASS' if passed else 'FAIL'}] {item}")
    print("validation_report.json written to", paths.data / "validation_report.json")
    return 0 if report["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
