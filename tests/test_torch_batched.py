"""The port's second batched engine against tpufem's on the same inputs, on
the CPU: WingBatchT (the line + RBM two-level PCG, and mg_levels=None, the
multigrid V-cycle) and solve_wing_batch (the per-case gather-path PCG), with
tpufem's bars (tests/test_batched.py, tests/test_multigrid.py):

- WingBatchT two-level, f64, COARSE, three wings, tol 1e-10: u within 1e-8
  (relative 2-norm per case), vm within 1e-7 of its largest value;
- WingBatchT(mg_levels=None), f64, 16x16x4 (LE, TE floor), two wings, tol
  1e-10: u within 1e-8 of tpufem's (max norm), and fewer iterations than the
  two-level on the same batch;
- solve_wing_batch, f64, COARSE, tol 1e-10: u within 1e-8;
- the blunt-TE 16x8x3 resolution solves in both packages (converged,
  finite vm, downward tip) with u within 1e-7;
- each engine in f32 at tol 1e-5: converged in both packages, u within 2e-5
  of tpufem's f32 u (max norm; f32 CG rounding differs with the summation
  order: measured 1.2e-6 to 1.8e-6);
- WingBatchT's, solve's and solve_wing_batch's keyword defaults are
  tpufem's (the fast layout's own parity: tests/test_torch_fast_layout.py);
- generate_fem_dataset --batched --engine twolevel on a two-case COARSE
  dataset reports success with tpufem's report fields.
"""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem import batched as jb
from tpufem.fem.batched_t import WingBatchT as JWingBatchT
from tpufem.mesher import WingMeshResolution as JRes
from tpufem_torch.fem import batched as tb
from tpufem_torch.fem.batched_t import WingBatchT
from tpufem_torch.mesher import COARSE, WingMeshResolution
from tpufem_torch.scripts import (
    generate_fem_dataset,
    generate_geometry_dataset,
    generate_mesh_dataset,
)

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.6, 0.42, 25.0, 0.07], [1.0, 0.20, 0.0, 0.15]])
JCOARSE = JRes(12, 8, 2, 0.0, "cosine")
RES = WingMeshResolution(16, 16, 4, te_floor_frac=0.006, spacing="le")
JRES = JRes(16, 16, 4, te_floor_frac=0.006, spacing="le")
F32 = {"tol": 1e-5, "u": 2e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(p4):
    return [dict(span_m=r[0], chord_m=r[1], sweep_deg=r[2], thickness_ratio=r[3]) for r in p4]


def _maxrel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_two_level_f64_matches_tpufem():
    out = WingBatchT(COARSE, dtype=torch.float64, device="cpu").solve(
        P4, pressure=5000.0, tol=1e-10, maxiter=20000)
    ref = JWingBatchT(JCOARSE, dtype=jnp.float64).solve(P4, pressure=5000.0, tol=1e-10,
                                                         maxiter=20000, chunk_iters=3000)
    assert bool(out.converged.all()) and bool(np.all(np.asarray(ref.converged)))
    assert out.u.dtype == torch.float64
    u, vm = out.u.numpy(), out.vm.numpy()
    for k in range(len(P4)):
        ur, vr = np.asarray(ref.u[:, :, k]), np.asarray(ref.vm[:, k])
        assert np.linalg.norm(u[:, :, k] - ur) / np.linalg.norm(ur) < 1e-8, k
        assert np.abs(vm[:, k] - vr).max() / vr.max() < 1e-7, k


def test_multigrid_f64_matches_tpufem_and_beats_two_level():
    mg = WingBatchT(RES, dtype="float64", mg_levels=None, device="cpu")
    out = mg.solve(P4[:2], tol=1e-10, maxiter=1000)
    two = WingBatchT(RES, dtype=torch.float64, device="cpu").solve(P4[:2], tol=1e-10,
                                                                   maxiter=5000)
    ref = JWingBatchT(JRES, dtype=jnp.float64, mg_levels=None).solve(
        P4[:2], tol=1e-10, maxiter=1000, chunk_iters=1000)
    assert bool(out.converged.all()) and bool(two.converged.all())
    assert _maxrel(out.u, ref.u) < 1e-8
    assert _maxrel(out.u, two.u) < 1e-8
    assert out.iters < two.iters  # multigrid must beat the two-level
    assert len(mg.mg.levels) == 3


def test_solve_wing_batch_f64_matches_tpufem():
    out, ctx = tb.solve_wing_batch(_params(P4), COARSE, pressure=5000.0, tol=1e-10,
                                   maxiter=20000, dtype=torch.float64, device="cpu")
    ref, _ = jb.solve_wing_batch(_params(P4), JCOARSE, pressure=5000.0, tol=1e-10,
                                 maxiter=20000, dtype=jnp.float64)
    assert bool(out.converged.all()) and out.iters.shape == (len(P4),)
    assert isinstance(ctx, tb.WingBatchContext)
    for k in range(len(P4)):
        ur = np.asarray(ref.u[k])
        assert np.linalg.norm(out.u[k].numpy() - ur) / np.linalg.norm(ur) < 1e-8, k
    assert _maxrel(out.nodes, ref.nodes) < 1e-14


def test_blunt_te_resolution_solves():
    res = WingMeshResolution(16, 8, 3, te_floor_frac=0.006, spacing="le")
    out = WingBatchT(res, dtype=torch.float64, device="cpu").solve(
        P4[:2], pressure=5000.0, tol=1e-9, maxiter=20000)
    ref = JWingBatchT(JRes(16, 8, 3, te_floor_frac=0.006, spacing="le"), dtype=jnp.float64).solve(
        P4[:2], pressure=5000.0, tol=1e-9, maxiter=20000, chunk_iters=4000)
    for o in (out, ref):
        assert bool(np.all(np.asarray(o.converged)))
        assert np.isfinite(np.asarray(o.vm)).all()
        assert (np.asarray(o.u)[:, 2, :].mean(axis=0) < 0).all()
    assert _maxrel(out.u, ref.u) < 1e-7


@pytest.mark.parametrize("engine", ["two-level", "multigrid", "solve_wing_batch"])
def test_f32_engines_match_tpufem(engine):
    kw = dict(pressure=5000.0, tol=F32["tol"], maxiter=20000)
    if engine == "solve_wing_batch":
        out, _ = tb.solve_wing_batch(_params(P4), COARSE, device="cpu", **kw)
        ref, _ = jb.solve_wing_batch(_params(P4), JCOARSE, **kw)
        u, ur = out.u.numpy(), np.asarray(ref.u)
    else:
        levels = 0 if engine == "two-level" else None
        out = WingBatchT(COARSE, mg_levels=levels, device="cpu").solve(P4, **kw)
        ref = JWingBatchT(JCOARSE, mg_levels=levels).solve(P4, chunk_iters=20000, **kw)
        u, ur = out.u.numpy(), np.asarray(ref.u)
    assert out.u.dtype == torch.float32 and ur.dtype == np.float32
    assert bool(out.converged.all()) and bool(np.all(np.asarray(ref.converged)))
    assert _maxrel(u, ur) < F32["u"], _maxrel(u, ur)


def test_defaults_equal_tpufem():
    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    def same(port, ref):
        d_port, d_ref = defaults(port), defaults(ref)
        for key, value in d_ref.items():
            mine = d_port[key]
            if key == "dtype":
                assert mine == torch.float32 and value == jnp.float32
            else:  # a Material of each package: equal fields
                assert mine == value or repr(mine) == repr(value), (key, mine, value)

    same(WingBatchT.__init__, JWingBatchT.__init__)
    same(WingBatchT.solve, JWingBatchT.solve)
    same(tb.solve_wing_batch, jb.solve_wing_batch)
    same(tb.WingBatchContext.__init__, jb.WingBatchContext.__init__)
    same(tb.WingBatchContext.solve, jb.WingBatchContext.solve)


def test_generate_fem_dataset_twolevel(tmp_path, capsys):
    root = str(tmp_path)
    assert generate_geometry_dataset.main(["--count", "2", "--seed", "7",
                                           "--data_root", root]) == 0
    assert generate_mesh_dataset.main(["--n_chord", "12", "--n_span", "8", "--n_thick", "2",
                                       "--data_root", root]) == 0
    argv = ["--batched", "--engine", "twolevel", "--no_glb", "--device", "cpu",
            "--data_root", root]
    assert generate_fem_dataset.main(argv) == 0
    assert "done: 2/2 success" in capsys.readouterr().out
    for cid in ("001", "002"):
        case = tmp_path / "data" / "raw" / "fem" / cid
        rep = json.loads((case / "fem_report.json").read_text())
        assert rep["status"] == "success"
        assert rep["extra"]["engine"] == "twolevel" and rep["extra"]["batched"] is True
        assert rep["extra"]["solver"]["converged"] and rep["extra"]["solver"]["iters"] > 0
        assert np.isfinite(np.load(case / "surface_results.npz")["stress_vm"]).all()
