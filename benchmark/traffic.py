"""The one traffic generator: batches of wing parameters drawn from the seed.

A traffic file (benchmark/workloads/<traffic>.json) gives the batch size and
the dtype the parameters are handed over in. Each wing is drawn as dataset
generation draws it (`generate_geometry_dataset.sample_params`): span,
chord, sweep and thickness ratio, each independent and uniform over the
configuration's `prd_ranges`. Batch k of a run is a function of (seed, k)
alone, and the warm-up batch is drawn from a stream of its own, so every run
of one seed solves the same wings in the same order however many batches
its window holds.
"""

from __future__ import annotations

import numpy as np

PARAMS = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
WARMUP = -1  # the index of the warm-up batch


class Traffic:
    def __init__(self, traffic: dict, cfg: dict, seed: int):
        self.batch_size = int(traffic["batch"])
        self.dtype = np.dtype(traffic["params_dtype"])
        self.ranges = np.array([cfg["prd_ranges"][k] for k in PARAMS], np.float64)  # (4, 2)
        self.seed = int(seed)

    def batch(self, index: int) -> np.ndarray:
        """(B, 4) parameters of batch `index` (WARMUP: the warm-up batch)."""
        rng = np.random.default_rng(
            [abs(self.seed), int(self.seed < 0), int(index == WARMUP), max(index, 0)])
        lo, hi = self.ranges[:, 0], self.ranges[:, 1]
        return (lo + (hi - lo) * rng.random((self.batch_size, 4))).astype(self.dtype)
