"""kernel_b_roofline.tet4: kernel B's (strain_apply, csrc/strain_apply.cu)
share of its roofline in the traced window, %: the bounds of its launches,
from each launch's shape and dtype, over its device time."""

from benchmark import readers

ENTRIES = {"tpufem_strain_apply_f64": "float64", "tpufem_strain_apply_f32": "float32"}


def read(run):
    return readers.roofline(run, ENTRIES, "strain_apply_kernel", readers.b_cost)
