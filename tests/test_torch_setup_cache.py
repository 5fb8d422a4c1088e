"""WingStencilT's setup cache, as tpufem's (tpufem/fem/stencil_mg.py:677-687):
the last batch's setup state, keyed by its params, Lame constants and
pressure, on the CPU at 8x12x2, B=2.

- a repeated solve of the same batch skips setup (last_timing["setup_s"]
  is 0), gives the same bits and writes into no cached tensor;
- a changed pressure, params or material rebuilds the state and gives a
  fresh solver's bits, and the first batch solved again rebuilds it back.
"""

import numpy as np
import pytest
import torch

from tpufem_torch.fem.material import Material
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import WingMeshResolution

RES = WingMeshResolution(8, 12, 2, te_floor_frac=0.006, spacing="le")
P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])
PRESSURE = 5e3
KW = {"tol": 1e-8, "maxiter": 2000, "outer_f64": True}
# what each case changes in (params4, pressure, material)
CHANGES = {
    "pressure": (P4, 2 * PRESSURE, Material()),
    "params": (P4 * np.array([1.0, 1.0, 1.0, 1.05]), PRESSURE, Material()),
    "material": (P4, PRESSURE, Material(E=0.9 * Material().E)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    solver = WingStencilT(RES, device="cpu")
    out = solver.solve(P4, pressure=PRESSURE, **KW)
    assert solver.last_timing["setup_s"] > 0
    return solver, out


def _same(a, b) -> bool:
    """Two solve results (BatchTSolveResult) field for field, bit for bit."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b, strict=True))


def _tensors(tree):
    """Every tensor of a setup state (nested dicts, lists and tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_repeated_solve_hits_the_cache(solved):
    solver, out = solved
    state = solver._setup_cache[1]
    before = [t.clone() for t in _tensors(state)]
    assert len(before) > 5
    again = solver.solve(P4.copy(), pressure=PRESSURE, **KW)
    assert solver.last_timing["setup_s"] == 0
    assert solver._setup_cache[1] is state
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(state), strict=True))
    assert _same(again, out) and bool(again.converged.all())
    again.nodes.zero_()  # a caller's write into a result reaches no cached tensor
    assert torch.equal(solver.solve(P4, pressure=PRESSURE, **KW).nodes, out.nodes)
    assert solver.last_timing["setup_s"] == 0


@pytest.mark.parametrize("change", list(CHANGES))
def test_changed_key_rebuilds(solved, change):
    solver, out = solved
    p4, pressure, material = CHANGES[change]
    got = solver.solve(p4, pressure=pressure, material=material, **KW)
    assert solver.last_timing["setup_s"] > 0
    fresh = WingStencilT(RES, device="cpu").solve(p4, pressure=pressure, material=material,
                                                  **KW)
    assert _same(got, fresh) and bool(got.converged.all())
    assert not torch.equal(got.u, out.u)
    back = solver.solve(P4, pressure=PRESSURE, **KW)
    assert solver.last_timing["setup_s"] > 0
    assert _same(back, out)
