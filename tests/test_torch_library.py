"""The library yardsticks of profile_library on the CPU: each assembled
matrix times a seeded vector equals the kernel's plain version to 1e-12 of
its largest entry (f64), at small grids with a floored and a sharp trailing
edge (the welds), for kernels B, F, G, I and K (probed through the plain
version by grid_probe_csr), D (assembled_csr from its element matrices) and
O (D's assembly per lane, as one block-diagonal matrix, B = 3); for B, D,
F, G and O also the matrix cast to f32 against the f32 plain version (1e-5
of its largest entry, library_record raises beyond); and the probe refuses
a function that reads past the colouring's reach."""

import pytest
import torch

from tpufem_torch import profile_library as pl
from tpufem_torch.mesher import WingMeshResolution

GRIDS = {"floored": WingMeshResolution(7, 5, 2, 0.006, "le"),
         "sharp TE": WingMeshResolution(7, 5, 2, 0.0, "le")}
CASES = {"B": lambda res: pl.case_B("cpu", res, B=2), "F": lambda res: pl.case_F("cpu", res, 2),
         "G": lambda res: pl.case_G("cpu", res, 2), "I": lambda res: pl.case_I("cpu", res),
         "K": lambda res: pl.case_K("cpu", res, B=2), "D": lambda res: pl.case_D("cpu", res),
         "O": lambda res: pl.case_O("cpu", res, B=3)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("kernel", list(CASES))
def test_library_matrix_computes_the_kernels_function(kernel, grid):
    case = CASES[kernel](GRIDS[grid])
    rec = pl.library_record(case, timed=False)  # raises beyond 1e-12
    assert rec["max_abs_err"] <= 1e-12 * rec["scale"] and rec["scale"] > 0
    assert rec["nnz"] > 0 and rec["rows"] == sum(o.numel() for o in case["plain"](case["x"]))
    if "f32" in case:
        assert rec["f32"]["max_abs_err"] <= 1e-5 * rec["f32"]["scale"]


def test_probe_refuses_a_reach_past_one_node():
    shape = (3, 1, 7, 3, 6)

    def two_over(x):  # reads the node two columns along i
        return (torch.roll(x, 2, dims=2),)

    with pytest.raises(RuntimeError, match="outside"):
        pl.grid_probe_csr(two_over, shape, (False,), device="cpu")
