"""tet4_wings_per_s: certified tet4 wings (the lane converged, the
reference's TRUE f64 relative residual within the guarantee, von Mises
within its limit) over the window's seconds (host clock)."""

from benchmark import readers


def read(run):
    return readers.wings_per_s(run)
