"""solver_setup_ms.tet4: the program's setup of a batch, ms (its
last_timing["setup_s"], mean over the window's batches)."""

from benchmark import readers


def read(run):
    return readers.setup_ms(run)
