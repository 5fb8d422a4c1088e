"""tpufem's keyword arguments at the port's stencil entry points: the exact
calls tpufem makes (tpufem/pipeline/fem_stage.py:98-112,
tpufem/fem/buckling.py:139-141, tpufem/fem/nonlinear.py:287-290,
scripts/generate_fem_dataset.py:195-204) run, on the CPU at 8x12x2, B=2.

- WingStencilT(res, dtype=...) with tpufem's float32 spelled every way, and
  .solve(..., outer_f64=True, chunk_iters=250, inner_tol=...), give the
  bits of the call without chunk_iters and inner_tol;
- a V-cycle dtype other than float32 or float64 raises NotImplementedError;
- WingStencilT(res, dtype=float64) gives tpufem's WingStencilT(dtype=
  jnp.float64) at 16x16x2 (the solver tpufem's span-sharded tet4 is held
  to), tol 1e-8, on both outer_f64 values: iterations within 2, u within
  1e-8 of the largest displacement;
- the f32-only CG (outer_f64=False, tpufem's default) and refine_steps=2
  give tpufem's same branch at tpufem's test grid 12x10x3 (two wings, tol
  1e-6): refine's f64 u within 1e-7 of the largest displacement (measured
  3.6e-9) and the same converged flags; the f32 u within 5e-5 (the two f32
  CGs round differently: measured 7.3e-6), both converged on their recurred
  residual; outer_f64 with tpufem's A/B variants warm_f32, dd_main and both
  (bench.py --warm_f32 / --dd_main) give tpufem's f64 u within 1e-7, the
  same converged flags, a TRUE residual <= tol recomputed in numpy (scipy's
  assembled K and numpy loads) and tpufem's reported residual within
  rtol 0.5;
- WingStencilT.solve's keyword defaults are tpufem's;
- WingSolveConfig has tpufem's fields, chunk_iters among them, and
  generate_fem_dataset's parser takes --chunk_iters 200.
"""

import dataclasses
import inspect

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
KW = {"pressure": 5e3, "tol": 1e-8, "maxiter": 2000, "outer_f64": True}
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
        P4, chunk_iters=250, inner_tol=1e-4, **KW)
    assert bool(out.converged.all())
    for a, b in zip(out, plain, strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("call", ["dtype bfloat16"])
def test_unported_branches_raise(call):
    with pytest.raises(NotImplementedError, match="not ported"):
        WingStencilT(RES, device="cpu", dtype=call.split()[1])


F64_RES = WingMeshResolution(16, 16, 2, te_floor_frac=0.006, spacing="le")
F64_P4 = np.array([[1.2, 0.35, 10.0, 0.10]])


@pytest.fixture(scope="module")
def tpufem_f64():
    """tpufem's f64 WingStencilT at 16x16x2 (one solver: its jit cache serves
    both branches)."""
    from tpufem.fem.stencil_mg import WingStencilT as JWingStencilT
    from tpufem.mesher import WingMeshResolution as JRes

    return JWingStencilT(JRes(16, 16, 2, te_floor_frac=0.006, spacing="le"),
                         dtype=jnp.float64)


@pytest.mark.parametrize("outer_f64", [False, True])
@pytest.mark.parametrize("spelling", ["torch", "jnp"])
def test_float64_matches_tpufem(tpufem_f64, outer_f64, spelling):
    args = {"pressure": 5e3, "tol": 1e-8, "maxiter": 400, "outer_f64": outer_f64}
    dtype = {"torch": torch.float64, "jnp": jnp.float64}[spelling]
    out = WingStencilT(F64_RES, device="cpu", dtype=dtype).solve(F64_P4, **args)
    ref = tpufem_f64.solve(F64_P4, chunk_iters=400, **args)
    u, ur = out.u.numpy(), np.asarray(ref.u)
    assert u.dtype == ur.dtype == np.float64
    assert abs(out.iters - int(ref.iters)) <= 2, (out.iters, ref.iters)
    assert bool(out.converged.all()) and bool(np.asarray(ref.converged).all())
    assert np.abs(u - ur).max() <= 1e-8 * np.abs(ur).max()


BRANCH_RES = WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le")
BRANCH_P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])


BRANCH_CALLS = {
    "outer_f64=False": {"outer_f64": False},
    "refine_steps=2": {"refine_steps": 2, "inner_tol": 1e-3},
    "warm_f32=True": {"outer_f64": True, "warm_f32": True},
    "dd_main=True": {"outer_f64": True, "dd_main": True},
    "warm_f32=True dd_main=True": {"outer_f64": True, "warm_f32": True, "dd_main": True},
}


@pytest.fixture(scope="module")
def tpufem_branches():
    """tpufem's f32 WingStencilT at 12x10x3 (one solver: its jit cache
    serves every branch)."""
    from tpufem.fem.stencil_mg import WingStencilT as JWingStencilT
    from tpufem.mesher import WingMeshResolution as JRes

    return JWingStencilT(JRes(12, 10, 3, te_floor_frac=0.006, spacing="le"),
                         dtype=jnp.float32)


def numpy_true_rel(jsolver, p4, u):
    """Per-lane TRUE relative residual of u (N,3,B) on the free DOFs, from
    tpufem's numpy/scipy reference: the assembled K and numpy pressure loads
    on tpufem's mesh of each wing (the port's node numbering)."""
    from tpufem.fem.material import Material
    from tpufem.fem.refsolve import assemble_K, pressure_loads_np
    from tpufem.mesher import structured_wing_mesh

    sets, rels = jsolver.bt.sets, []
    for k, p in enumerate(p4):
        mesh = structured_wing_mesh(*p, res=jsolver.res)
        K = assemble_K(mesh.nodes.astype(np.float64), mesh.tets, Material())
        b = pressure_loads_np(mesh.nodes.astype(np.float64),
                              mesh.surf_faces[sets.surf_upper_faces], 5e3).reshape(-1)
        free = np.ones(b.size, bool)
        free[(3 * sets.nroot_nodes[:, None] + np.arange(3)).reshape(-1)] = False
        r = (b - K @ u[:, :, k].reshape(-1))[free]
        rels.append(np.linalg.norm(r) / np.linalg.norm(b[free]))
    return np.asarray(rels)


@pytest.mark.parametrize("call", list(BRANCH_CALLS))
def test_ported_branches_match_tpufem(tpufem_branches, call):
    kw = BRANCH_CALLS[call]
    args = {"pressure": 5e3, "tol": 1e-6, "maxiter": 2000}
    out = WingStencilT(BRANCH_RES, device="cpu").solve(BRANCH_P4, **args, **kw)
    ref = tpufem_branches.solve(BRANCH_P4, chunk_iters=500, **args, **kw)
    u, ur = out.u.numpy(), np.asarray(ref.u)
    err = np.abs(u - ur).max() / np.abs(ur).max()
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(ref.converged))
    if call != "outer_f64=False":  # the f64 u the TRUE residual certifies
        assert u.dtype == ur.dtype == np.float64 and err <= 1e-7, err
        np.testing.assert_allclose(out.rel_residual.numpy(), np.asarray(ref.rel_residual),
                                   rtol=0.5)
        if kw.get("outer_f64"):
            assert bool(out.converged.all())
            rel = numpy_true_rel(tpufem_branches, BRANCH_P4, u)
            assert rel.max() <= args["tol"], rel
    else:  # the f32 CG on its recurred residual
        assert u.dtype == ur.dtype == np.float32 and err <= 5e-5, err
        assert bool(out.converged.all()) and float(out.rel_residual.max()) <= 1e-6


def test_solve_defaults_equal_tpufem():
    from tpufem.fem.stencil_mg import WingStencilT as JWingStencilT

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    port, ref = defaults(WingStencilT.solve), defaults(JWingStencilT.solve)
    assert {k: port[k] for k in ref} == ref
    assert ref["outer_f64"] is False


def test_wing_solve_config_takes_tpufem_fields():
    from tpufem.fem.driver import WingSolveConfig as TpufemConfig

    names = [f.name for f in dataclasses.fields(WingSolveConfig)]
    assert [f.name for f in dataclasses.fields(TpufemConfig)] == names
    assert WingSolveConfig(chunk_iters=200).chunk_iters == 200
    assert WingSolveConfig().chunk_iters == TpufemConfig().chunk_iters == 0


def test_generate_fem_dataset_takes_chunk_iters():
    args = generate_fem_dataset.build_parser().parse_args(["--chunk_iters", "200", "--batched"])
    assert args.chunk_iters == 200 and args.batched
