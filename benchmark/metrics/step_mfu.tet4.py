"""step_mfu.tet4: the whole CG iteration's share of the card's peak, %:
its bound (the driver's step_cost: bytes over 3.35 TB/s or operations over
the rate of their dtype, the larger) over its wall time (the program's
solve seconds over its iterations)."""

from benchmark import readers


def read(run):
    return readers.step_mfu(run)
