"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the program's construction, the kernels' build
or load, and the warm-up batch (host clock)."""


def read(run):
    return run.setup_s
