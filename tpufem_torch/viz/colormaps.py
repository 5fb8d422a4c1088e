"""Colormaps: piecewise-linear viridis and 'hot', pure numpy — copy of
``tpufem/viz/colormaps.py``.

The reference hand-rolls the same viridis table twice (viz_results.py:72-102 and
inference_gnn.py:62-88) and pulls 'hot' from matplotlib for error maps
(inference_gnn.py:201-215). tpufem keeps one vectorized implementation of each.
"""

from __future__ import annotations

import numpy as np

# viridis anchor colors (matplotlib's endpoints + interior anchors)
_VIRIDIS = np.array(
    [
        (0.267004, 0.004874, 0.329415),
        (0.282623, 0.140926, 0.457517),
        (0.253935, 0.265254, 0.529983),
        (0.206756, 0.371758, 0.553117),
        (0.163625, 0.471133, 0.558148),
        (0.127568, 0.566949, 0.550556),
        (0.134692, 0.658636, 0.517649),
        (0.266941, 0.748751, 0.440573),
        (0.477504, 0.821444, 0.318195),
        (0.741388, 0.873449, 0.149561),
        (0.993248, 0.906157, 0.143936),
    ]
)


def _interp_table(t: np.ndarray, table: np.ndarray) -> np.ndarray:
    t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
    n = len(table) - 1
    x = t * n
    i = np.minimum(x.astype(np.int64), n - 1)
    f = (x - i)[..., None]
    return table[i] * (1 - f) + table[i + 1] * f


def viridis(t: np.ndarray) -> np.ndarray:
    """(...,) in [0,1] -> (..., 3) RGB floats."""
    return _interp_table(t, _VIRIDIS)


def hot(t: np.ndarray) -> np.ndarray:
    """matplotlib-style 'hot': black -> red -> yellow -> white."""
    t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
    r = np.clip(t / 0.365079, 0, 1)
    g = np.clip((t - 0.365079) / (0.746032 - 0.365079), 0, 1)
    b = np.clip((t - 0.746032) / (1.0 - 0.746032), 0, 1)
    return np.stack([r, g, b], axis=-1)


def normalize_range(values: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    span = max(vmax - vmin, 1e-30)
    return np.clip((np.asarray(values, dtype=np.float64) - vmin) / span, 0.0, 1.0)
