"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository root. Tests marked gpu need a CUDA card and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
