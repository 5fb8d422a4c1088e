"""cg_iters.tet4: CG iterations a batch (the result's iteration count,
mean over the window's batches)."""

from benchmark import readers


def read(run):
    return readers.cg_iters(run)
