"""The yardstick's arithmetic: the card's published peaks, the bytes and
operations of one launch of the operator kernel B from its shape and dtype,
the per-iteration cost of the solver's CG step, and the busy time of a set of
device activities.

A bound is the least time the card could take: the larger of the bytes
(each operand read once, each result written once, whatever implements it)
over the memory rate and the operations over the rate of their dtype outside
the tensor cores. Peaks: NVIDIA H100 SXM data sheet (dense, no sparsity).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}

# kernel B, per Kuhn tet: H = sum_a g_a (x) u_a (36 FMA), sigma * vol (~36),
# 4 corner forces sigma . g_a (60)
B_FLOPS_PER_TET = 170


class Cost:
    """Bytes and operations of some work, the operations kept by dtype."""

    def __init__(self, nbytes: float = 0.0, flops: dict | None = None):
        self.nbytes = float(nbytes)
        self.flops = dict(flops or {})

    def __add__(self, other: "Cost") -> "Cost":
        flops = dict(self.flops)
        for k, v in other.flops.items():
            flops[k] = flops.get(k, 0.0) + v
        return Cost(self.nbytes + other.nbytes, flops)

    def __mul__(self, n: float) -> "Cost":
        return Cost(self.nbytes * n, {k: v * n for k, v in self.flops.items()})

    __rmul__ = __mul__

    def bound_s(self) -> float:
        """Seconds: the larger of the byte time and the operation time."""
        t_ops = sum(v / PEAK_FLOPS[k] for k, v in self.flops.items())
        return max(self.nbytes / HBM_BYTES_PER_S, t_ops)


def b_apply(nc: int, nt: int, ns: int, lanes: int, dtype: str) -> Cost:
    """One kernel-B apply on a (nc, nt, ns)-cell grid of `lanes` wings: g
    (6,4,3,B,cells), vol (6,B,cells), u (3,B,nodes) and the span mask read
    once, y (u's shape) written once; B_FLOPS_PER_TET per Kuhn tet."""
    cells = nc * nt * ns * lanes
    nodes = (nc + 1) * (nt + 1) * (ns + 1) * lanes
    items = 6 * 4 * 3 * cells + 6 * cells + 2 * 3 * nodes + (ns + 1)
    return Cost(items * ITEMSIZE[dtype], {dtype: B_FLOPS_PER_TET * 6 * cells})


def line_solve(stations: int, D: int, lanes: int, dtype: str) -> Cost:
    """One thickness-line block solve: the inverted (D, D) block of each
    station and lane read once, the vector read and written once."""
    items = stations * lanes * (D * D + 2 * D)
    return Cost(items * ITEMSIZE[dtype], {dtype: 2.0 * D * D * stations * lanes})


def vectors(n: int, count: int, dtype: str) -> Cost:
    """`count` passes over a vector of n entries."""
    return Cost(n * count * ITEMSIZE[dtype])


def kernel_bound_s(launches: list, cost_of) -> float:
    """Sum of the bounds of the recorded launches; `cost_of(launch)` -> Cost."""
    return sum(cost_of(a).bound_s() for a in launches)


def busy_s(intervals) -> float:
    """Seconds of the union of [start, end) intervals, in nanoseconds."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9
