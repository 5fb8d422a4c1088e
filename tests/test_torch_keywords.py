"""tpufem's keyword arguments at the port's stencil entry points: the exact
calls tpufem makes (tpufem/pipeline/fem_stage.py:98-112,
tpufem/fem/buckling.py:139-141, tpufem/fem/nonlinear.py:287-290,
scripts/generate_fem_dataset.py:195-204) run, on the CPU at 8x12x2, B=2.

- WingStencilT(res, dtype=...) with tpufem's float32 spelled every way, and
  .solve(..., outer_f64=True, chunk_iters=250, inner_tol=...), give the
  bits of the call without those keywords;
- the branches that are not ported (a V-cycle dtype other than float32,
  outer_f64=False, refine_steps > 0, warm_f32, dd_main) raise
  NotImplementedError;
- WingSolveConfig has tpufem's fields, chunk_iters among them, and
  generate_fem_dataset's parser takes --chunk_iters 200.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem_torch.fem.driver import WingSolveConfig
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.scripts import generate_fem_dataset

RES = WingMeshResolution(8, 12, 2, te_floor_frac=0.006, spacing="le")
P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])
KW = {"pressure": 5e3, "tol": 1e-8, "maxiter": 2000}
F32 = {"torch": torch.float32, "jnp": jnp.float32, "numpy": np.float32,
       "numpy dtype": np.dtype("float32"), "name": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain():
    """The solve without tpufem's keywords."""
    return WingStencilT(RES, device="cpu").solve(P4, **KW)


@pytest.mark.parametrize("spelling", list(F32))
def test_tpufem_keywords_give_the_same_bits(plain, spelling):
    out = WingStencilT(RES, device="cpu", dtype=F32[spelling]).solve(
        P4, outer_f64=True, chunk_iters=250, inner_tol=1e-4, **KW)
    assert bool(out.converged.all())
    for a, b in zip(out, plain, strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("call", ["dtype float64", "dtype bfloat16", "outer_f64=False",
                                  "refine_steps=2", "warm_f32=True", "dd_main=True"])
def test_unported_branches_raise(call):
    if call.startswith("dtype"):
        with pytest.raises(NotImplementedError, match="not ported"):
            WingStencilT(RES, device="cpu", dtype=call.split()[1])
        return
    key, value = call.split("=")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2d"):
        WingStencilT(RES, device="cpu").solve(P4, **{key: eval(value)}, **KW)


def test_wing_solve_config_takes_tpufem_fields():
    from tpufem.fem.driver import WingSolveConfig as TpufemConfig

    names = [f.name for f in dataclasses.fields(WingSolveConfig)]
    assert [f.name for f in dataclasses.fields(TpufemConfig)] == names
    assert WingSolveConfig(chunk_iters=200).chunk_iters == 200
    assert WingSolveConfig().chunk_iters == TpufemConfig().chunk_iters == 0


def test_generate_fem_dataset_takes_chunk_iters():
    args = generate_fem_dataset.build_parser().parse_args(["--chunk_iters", "200", "--batched"])
    assert args.chunk_iters == 200 and args.batched
