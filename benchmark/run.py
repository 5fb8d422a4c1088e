"""Entry point of the benchmark (see benchmark/harness.py):

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1
"""

import time

T_START = time.perf_counter()  # setup_s counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
