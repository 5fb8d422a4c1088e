"""The port's whole slice against tpufem, at 12x10x3 (te_floor 0.006), B=2,
tol 1e-8: batched f64-outer solve -> stress recovery -> surface_results ->
build_graph -> GraphSAGE forward.

- the solve converges, and its TRUE residual, recomputed with tpufem's f64
  strain_apply and load vector, is <= tol;
- u matches tpufem.fem.refsolve.direct_solve (scipy) to 1e-7 of max|u|;
- s6/vm match tpufem's WingBatchT._recover on the same u: 1e-12 of the
  largest entry in f64, 1e-6 for the f32 outputs of the solve;
- surface payload and graph are identical, and the full-width surrogate
  forward with converted weights matches flax to 2e-4 (f32).
Also: importing the port never imports jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.driver as jdrv
import tpufem.fem.stencil as jst
import tpufem.mesher as jmesher
import tpufem.models.graph as jgraph
from tpufem.fem.batched_t import WingBatchT as JWingBatchT
from tpufem.fem.refsolve import direct_solve
from tpufem.fem.stencil_mg import WingStencilT as JWingStencilT
from tpufem.models.sage import GraphSAGE as FlaxSAGE
from tpufem.models.sage import SAGEConfig as FlaxConfig
import tpufem_torch.fem.driver as tdrv
import tpufem_torch.mesh_types as tmt
import tpufem_torch.models.graph as tgraph
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.models.metrics import compute_metrics
from tpufem_torch.models.sage import GraphSAGE, flax_to_state_dict

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])
NAMES = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
TOL = 1e-8
PRESSURE = 5e3
LAM, MU = lame_params(Material())
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def solved():
    res = WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le")
    solver = WingStencilT(res, device="cpu")
    out = solver.solve(P4, pressure=PRESSURE, tol=TOL, maxiter=2000, outer_f64=True)
    res_j = jmesher.WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le")
    return solver, out, res_j, JWingStencilT(res_j, dtype=jnp.float32)


def test_solve_converges_with_true_residual(solved):
    _, out, res_j, jsolver = solved
    assert out.u.dtype == torch.float64 and out.u.shape[1:] == (3, 2)
    assert bool(out.converged.all()), out.rel_residual
    assert out.iters > 0
    # independent TRUE residual: tpufem's f64 geometry, loads and operator
    X64 = jst.nodes_grid(res_j, jnp.asarray(P4), jnp.float64)
    geo64, bg64 = jsolver._jit_finish64(X64, jnp.float64(PRESSURE))
    xg = jst.to_grid(res_j, jnp.asarray(out.u.numpy()))
    _, rel = jsolver._jit_resid64(geo64, bg64, jnp.float64(LAM), jnp.float64(MU), xg)
    assert float(jnp.max(rel)) <= TOL, np.asarray(rel)
    # the two evaluations differ only by f64 cancellation noise (~3e-10 here)
    np.testing.assert_allclose(out.rel_residual.numpy(), np.asarray(rel), rtol=0, atol=0.1 * TOL)


def test_solution_matches_direct_solve(solved):
    _, out, res_j, jsolver = solved
    for k, p in enumerate(P4):
        mesh = jmesher.structured_wing_mesh(*p, res=res_j)
        u_ref, _, _ = direct_solve(mesh, jsolver.bt.sets, pressure=PRESSURE)
        u = out.u[:, :, k].numpy()
        assert np.abs(u - u_ref).max() <= 1e-7 * np.abs(u_ref).max()


def test_stress_recovery_matches(solved):
    solver, out, res_j, _ = solved
    jbt = JWingBatchT(res_j, dtype=jnp.float64)
    grads, vols = jbt._grads_vols(jbt._nodes(jnp.asarray(P4)))
    _, s6_j, vm_j = jbt._jit_recover(grads, vols, jnp.asarray(out.u.numpy()),
                                     jnp.float64(LAM), jnp.float64(MU))
    s6_j, vm_j = np.asarray(s6_j), np.asarray(vm_j)
    bt = solver.bt
    g64, v64 = bt._grads_vols(bt._nodes(torch.as_tensor(P4), torch.float64))
    _, s6, vm = bt._recover(g64, v64, out.u, LAM, MU)
    for b, a in ((s6, s6_j), (vm, vm_j)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12 * np.abs(a).max())
    for b, a in ((out.stress6, s6_j), (out.vm, vm_j)):  # the solve's f32 outputs
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6 * np.abs(a).max())


def test_surface_graph_and_surrogate_match(solved):
    solver, out, _, jsolver = solved
    bt = solver.bt
    nodes = out.nodes.numpy().astype(np.float64)
    graphs = []
    for k, p in enumerate(P4):
        params = dict(zip(NAMES, p))
        fields = dict(u=out.u[:, :, k].numpy(), stress6=out.stress6[:, :, k].numpy(),
                      vm=out.vm[:, k].numpy(), iters=out.iters,
                      rel_residual=float(out.rel_residual[k]), converged=True)
        tets = np.asarray(jsolver.bt.tets)
        mesh_j = jmesher.Mesh(nodes=nodes[:, :, k], tets=tets, surf_faces=jsolver.bt.surf_faces)
        mesh_t = tmt.Mesh(nodes=nodes[:, :, k], tets=tets, surf_faces=bt.surf_faces)
        surf_j = jdrv.surface_results(mesh_j, jsolver.bt.sets, jdrv.FemSolution(**fields), p[0])
        surf_t = tdrv.surface_results(mesh_t, bt.sets, tdrv.FemSolution(**fields), p[0])
        assert surf_t.keys() == surf_j.keys()
        for key in surf_j:
            np.testing.assert_array_equal(surf_t[key], surf_j[key], err_msg=key)
        faces = bt.surf_faces[bt.sets.surf_all_faces]
        g_j = jgraph.build_graph(surf_j, faces, params)
        g_t = tgraph.build_graph(surf_t, faces, params)
        for f in ("x", "edge_index", "y", "stress_vm", "disp", "loss_mask", "edge_mask"):
            np.testing.assert_array_equal(getattr(g_t, f), getattr(g_j, f), err_msg=f)
        graphs.append(g_t)

    # full-width surrogate (10 -> 64 -> 128, 4 x SAGEConv(128), 128 -> 64 -> 1)
    g = graphs[0]
    flax_model = FlaxSAGE(FlaxConfig())
    args = (jnp.asarray(g.x), jnp.asarray(g.edge_index), jnp.asarray(g.edge_mask))
    params = flax_model.init(jax.random.PRNGKey(0), *args)
    ref = np.asarray(jax.jit(flax_model.apply)(params, *args))
    model = GraphSAGE(device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    with torch.no_grad():
        pred = model(torch.as_tensor(g.x), torch.as_tensor(g.edge_index),
                     torch.as_tensor(g.edge_mask)).numpy()
    np.testing.assert_allclose(pred, ref, rtol=2e-4, atol=2e-4)
    m = compute_metrics(pred, g.stress_vm, g.loss_mask)
    assert set(m) == {"all_nodes", "masked_nodes"} and np.isfinite(m["all_nodes"]["mae_pa"])


def test_port_imports_without_jax():
    modules = [
        "tpufem_torch", "tpufem_torch.geometry", "tpufem_torch.mesh_types",
        "tpufem_torch.mesher", "tpufem_torch.sets", "tpufem_torch.pipeline.types",
        "tpufem_torch.fem.material", "tpufem_torch.fem.stencil", "tpufem_torch.fem.precond",
        "tpufem_torch.fem.multigrid", "tpufem_torch.fem.batched_t",
        "tpufem_torch.fem.stencil_mg", "tpufem_torch.fem.driver", "tpufem_torch.models.graph",
        "tpufem_torch.ops.kernels", "tpufem_torch.ops.gather_scatter",
        "tpufem_torch.models.sage", "tpufem_torch.models.metrics",
        "tpufem_torch.profile_solve", "tpufem_torch.utils.stl",
        "tpufem_torch.pipeline.config", "tpufem_torch.pipeline.case_id",
        "tpufem_torch.pipeline.reports", "tpufem_torch.pipeline.geometry_stage",
        "tpufem_torch.pipeline.mesh_stage", "tpufem_torch.pipeline.fem_stage",
        "tpufem_torch.models.dataset", "tpufem_torch.models.train", "tpufem_torch.scripts",
        "tpufem_torch.scripts.generate_geometry_dataset",
        "tpufem_torch.scripts.generate_mesh_dataset",
        "tpufem_torch.scripts.generate_fem_dataset", "tpufem_torch.scripts.train_gnn",
        "tpufem_torch.scripts.inference_gnn", "tpufem_torch.fem.elements",
        "tpufem_torch.fem.bc", "tpufem_torch.fem.loads", "tpufem_torch.fem.assembly",
        "tpufem_torch.fem.vonmises", "tpufem_torch.fem.solver",
        "tpufem_torch.ops.csr_segment_sum", "tpufem_torch.msh2", "tpufem_torch.utils.profiling",
        "tpufem_torch.viz", "tpufem_torch.viz.glb", "tpufem_torch.viz.colormaps",
        "tpufem_torch.viz.results", "tpufem_torch.viz.arrows", "tpufem_torch.pipeline.verify",
        "tpufem_torch.profile_gather", "tpufem_torch.profile_operator", "tpufem_torch.device",
        "tpufem_torch.fem.modal", "tpufem_torch.fem.buckling", "tpufem_torch.app_core",
        "tpufem_torch.app", "tpufem_torch.pipeline.validate", "tpufem_torch.profile_geometric",
        "tpufem_torch.scripts.modal_analysis", "tpufem_torch.scripts.buckling_analysis",
        "tpufem_torch.scripts.prestress_sweep", "tpufem_torch.scripts.validate_dataset",
        "tpufem_torch.scripts.repair_geometry_glb", "tpufem_torch.fem.nonlinear",
        "tpufem_torch.fem.adjoint", "tpufem_torch.scripts.nonlinear_solve",
        "tpufem_torch.scripts.optimize_wing", "tpufem_torch.profile_nonlinear",
        "tpufem_torch.fem.tet10", "tpufem_torch.fem.tet10_stencil", "tpufem_torch.fem.refsolve",
        "tpufem_torch.fem.xprec", "tpufem_torch.scripts.solve_tet10_1m",
        "tpufem_torch.profile_tet10", "tpufem_torch.profile_csr", "tpufem_torch.fem.tet10_mg",
        "tpufem_torch.ops.segment", "tpufem_torch.native", "tpufem_torch.geometry",
    ]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'pydantic', 'matplotlib', 'tpufem'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("entry", ["WingStencilT", "solve_wing_case", "Trainer",
                                   "Trainer.load_checkpoint", "WingNonlinear",
                                   "DifferentiableWingFEM", "Tet10StencilT", "WingModal10",
                                   "Tet10MGSolver", "solve_tet10_case"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """The port's entry points run on the card unless the caller asks for the
    CPU: with no CUDA device, the default raises instead of falling back."""
    from tpufem_torch.fem.adjoint import DifferentiableWingFEM
    from tpufem_torch.fem.modal import WingModal10
    from tpufem_torch.fem.nonlinear import WingNonlinear
    from tpufem_torch.fem.tet10 import solve_tet10_case, tet10_from_tet4, tet10_root_nodes
    from tpufem_torch.fem.tet10_mg import Tet10MGSolver
    from tpufem_torch.fem.tet10_stencil import Tet10StencilT
    from tpufem_torch.mesher import structured_wing_mesh
    from tpufem_torch.models.train import TrainConfig, Trainer
    from tpufem_torch.sets import build_boundary_sets

    res = WingMeshResolution(4, 4, 2, te_floor_frac=0.006, spacing="le")
    mesh = structured_wing_mesh(*P4[0], res)
    calls = {
        "WingStencilT": lambda: WingStencilT(res),
        "solve_wing_case": lambda: tdrv.solve_wing_case(mesh, build_boundary_sets(mesh)),
        "Trainer": lambda: Trainer(TrainConfig()),
        "Trainer.load_checkpoint": lambda: Trainer.load_checkpoint(tmp_path / "none.pt"),
        "WingNonlinear": lambda: WingNonlinear(res, P4[0]),
        "DifferentiableWingFEM": lambda: DifferentiableWingFEM(res, P4[:1]),
        "Tet10StencilT": lambda: Tet10StencilT(res),
        "WingModal10": lambda: WingModal10(res, P4[0]),
        "Tet10MGSolver": lambda: Tet10MGSolver(res, tet10_from_tet4(mesh)),
        "solve_tet10_case": lambda: solve_tet10_case(
            tet10_from_tet4(mesh), tet10_root_nodes(tet10_from_tet4(mesh)),
            tet10_from_tet4(mesh).surf_t6[:1], 5e3),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_profile_batch_is_chip_smoke_batch():
    """profile_solve times the same seeded batch that chip_smoke.py solves."""
    import importlib.util

    from tpufem_torch.pipeline.types import PRD_RANGES
    from tpufem_torch.profile_solve import seeded_batch

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(42)
    smoke.sample_params(rng, 8, PRD_RANGES)
    np.testing.assert_array_equal(seeded_batch(8), smoke.sample_params(rng, 8, PRD_RANGES))
