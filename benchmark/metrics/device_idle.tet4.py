"""device_idle.tet4: share of the traced window in which no device
activity ran, % (torch.profiler)."""

from benchmark import readers


def read(run):
    return readers.device_idle(run)
