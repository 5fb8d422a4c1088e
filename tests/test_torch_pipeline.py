"""The port's dataset CLIs and pipeline stages against tpufem's, on the CPU:
3 cases (--seed 7), mesh 12x8x2, batched FEM at tol 1e-8, GLBs on, each
package in its own data root.

- case ids, params.json (bytes), mesh.npz (arrays) and boundary_sets.json
  (text) are identical, and so are the GLBs every stage writes (bytes);
- surface_results.npz is exact in its integer and mask arrays; the float
  arrays agree to 1e-5 of each array's max (two converged f64-outer solves);
- tpufem's pydantic models parse the port's reports and the port's schemas
  parse tpufem's;
- the port's WingStressDataset builds the same split json and padded graphs
  as tpufem's on the same data, and cache=False writes no per-case cache;
- the sequential FEM path (the stage's B=1 stencil solve) agrees with the
  batched one, and a rerun of the batched CLI resumes;
- a case without a structured resolution takes the gather path; a forced
  failing solve goes down tpufem's ladder and records every attempt under
  tpufem's names; a user MSH2 mesh goes through the mesh and FEM stages;
  verify passes the easy spec case; inference writes its two GLBs.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufem.fem.driver import WingSolveConfig as JWingSolveConfig
from tpufem.models.dataset import WingStressDataset as JWingStressDataset
from tpufem.pipeline.config import get_paths as jget_paths
from tpufem.pipeline.fem_stage import run_fem_case as jrun_fem_case
from tpufem.pipeline.types import WingParams as JWingParams
from tpufem.pipeline.types import ParamsFile as JParamsFile
from tpufem.pipeline.types import StepReport as JStepReport
from tpufem.viz.colormaps import hot as jhot
from tpufem.viz.results import surface_results_to_glb as jsurface_results_to_glb
from tpufem_torch.fem.driver import WingSolveConfig
from tpufem_torch.mesher import COARSE, structured_wing_mesh
from tpufem_torch.models.dataset import WingStressDataset
from tpufem_torch.models.sage import SAGEConfig
from tpufem_torch.models.train import TrainConfig, Trainer
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.fem_stage import run_fem_case
from tpufem_torch.pipeline.mesh_stage import run_mesh_case
from tpufem_torch.pipeline.types import ParamsFile, StepReport, WingParams
from tpufem_torch.pipeline.verify import SPEC_CASES, verify_pipeline
from tpufem_torch.scripts import (
    generate_fem_dataset,
    generate_geometry_dataset,
    generate_mesh_dataset,
    inference_gnn,
)
from tpufem_torch.viz.glb import read_glb

REPO = Path(__file__).resolve().parents[1]
IDS = ["001", "002", "003"]
GEO = ["--count", "3", "--seed", "7"]
MESH = ["--n_chord", "12", "--n_span", "8", "--n_thick", "2"]
FEM = ["--batched", "--tol", "1e-8"]
GLBS = {"geometry": ["wing_viz.glb"], "mesh": ["surf_sets.glb"],
        "fem": ["wing_result.glb", "wing_result_arrows.glb"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    port = tmp_path_factory.mktemp("port_root")
    ref = tmp_path_factory.mktemp("tpufem_root")
    assert generate_geometry_dataset.main([*GEO, "--data_root", str(port)]) == 0
    assert generate_mesh_dataset.main([*MESH, "--data_root", str(port)]) == 0
    assert generate_fem_dataset.main([*FEM, "--device", "cpu", "--data_root", str(port)]) == 0
    for name, argv in (("generate_geometry_dataset", GEO), ("generate_mesh_dataset", MESH),
                       ("generate_fem_dataset", FEM)):
        assert _load_script(name).main([*argv, "--data_root", str(ref)]) == 0
    return port / "data" / "raw", ref / "data" / "raw"


def test_geometry_and_mesh_artifacts_identical(roots):
    port, ref = roots
    for stage in ("geometry", "mesh", "fem"):
        assert sorted(p.name for p in (port / stage).iterdir()) == IDS
    for cid in IDS:
        assert (port / "geometry" / cid / "params.json").read_bytes() == \
            (ref / "geometry" / cid / "params.json").read_bytes()
        assert (port / "geometry" / cid / "wing.stl").read_bytes() == \
            (ref / "geometry" / cid / "wing.stl").read_bytes()
        a, b = np.load(port / "mesh" / cid / "mesh.npz"), np.load(ref / "mesh" / cid / "mesh.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (port / "mesh" / cid / "boundary_sets.json").read_text() == \
            (ref / "mesh" / cid / "boundary_sets.json").read_text()


def test_cli_glbs_match(roots):
    """Geometry and mesh GLBs are byte-identical. The FEM GLBs are byte-
    identical in their JSON layout, indices and colors; their positions (and
    the arrows placed on them) come from the batched solve's f32 node
    coordinates, which the two packages' f32 tan rounds apart by an ulp on
    some nodes (as in surface_results.npz's pos)."""
    port, ref = roots
    for stage, names in GLBS.items():
        for cid in IDS:
            for name in names:
                a, b = port / stage / cid / name, ref / stage / cid / name
                if stage != "fem":
                    assert a.read_bytes() == b.read_bytes(), (stage, cid, name)
                    continue
                ga, gb = read_glb(a), read_glb(b)
                floats = set()  # the views of positions (result mesh and arrows)
                for pa, pb in zip(ga["json"]["accessors"], gb["json"]["accessors"]):
                    if pa["componentType"] == 5126:
                        floats.add(pa["bufferView"])
                        for k in ("min", "max"):
                            np.testing.assert_allclose(pa.pop(k), pb.pop(k), rtol=2.4e-7, atol=1e-7)
                assert ga["json"] == gb["json"] and len(ga["bin"]) == len(gb["bin"])
                for i, view in enumerate(ga["json"]["bufferViews"]):
                    lo, hi = view["byteOffset"], view["byteOffset"] + view["byteLength"]
                    if i in floats:
                        np.testing.assert_allclose(np.frombuffer(ga["bin"][lo:hi], np.float32),
                                                   np.frombuffer(gb["bin"][lo:hi], np.float32),
                                                   rtol=2.4e-7, atol=1e-7)  # m
                    else:
                        assert ga["bin"][lo:hi] == gb["bin"][lo:hi], (cid, name, i)
        rep = json.loads((port / stage / "001" / f"{stage}_report.json").read_text())
        for name in names:
            assert any(v.endswith(name) for v in rep["artifacts"].values()), (stage, name)


def test_surface_results_match(roots):
    port, ref = roots
    for cid in IDS:
        a = np.load(port / "fem" / cid / "surface_results.npz")
        b = np.load(ref / "fem" / cid / "surface_results.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in ("node_id", "loss_mask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("disp", "stress_vm", "pos", "normal"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 * np.abs(b[k]).max(),
                                       err_msg=k)


def test_reports_parse_both_ways(roots):
    port, ref = roots
    for cid in IDS:
        for stage in ("geometry", "mesh", "fem"):
            for root in (port, ref):
                text = (root / stage / cid / f"{stage}_report.json").read_text()
                ours, theirs = StepReport.from_json(text), JStepReport.model_validate_json(text)
                assert ours.status == theirs.status == "success"
                assert ours.as_json_dict() == theirs.model_dump()
                # the port writes what pydantic writes
                assert ours.to_json() == theirs.model_dump_json(indent=2)
        text = (port / "geometry" / cid / "params.json").read_text()
        assert ParamsFile.from_json(text).as_json_dict() == \
            JParamsFile.model_validate_json(text).model_dump()
    rep = json.loads((port / "fem" / "001" / "fem_report.json").read_text())
    assert rep["extra"]["solver"]["converged"] and rep["extra"]["solver"]["rel_residual"] <= 1e-8


def _copy_root(raw: Path, dst: Path) -> Path:
    shutil.copytree(raw.parent.parent, dst)
    return dst


def test_dataset_matches_tpufem(roots, tmp_path):
    port, _ = roots
    a = _copy_root(port, tmp_path / "a")
    b = _copy_root(port, tmp_path / "b")
    ds = WingStressDataset(get_paths(a), seed=42)
    jds = JWingStressDataset(jget_paths(b), seed=42)
    assert ds.case_ids == jds.case_ids == IDS
    assert (a / "data" / "processed" / "split_info_s42.json").read_text() == \
        (b / "data" / "processed" / "split_info_s42.json").read_text()
    for split in ("train", "val", "test"):
        got, want = ds.graphs(split), jds.graphs(split)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.x.shape[0] % 128 == 0 and g.edge_index.shape[1] % 128 == 0
            for f in ("x", "edge_index", "edge_mask", "y", "stress_vm", "disp", "loss_mask",
                      "node_mask", "num_nodes", "num_edges"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


def test_dataset_without_cache_writes_no_graph_cache(roots, tmp_path):
    port, _ = roots
    root = _copy_root(port, tmp_path / "c")
    ds = WingStressDataset(get_paths(root), seed=42, cache=False)
    assert len(ds.graphs("train")) == 2
    raw_cache = root / "data" / "processed" / "raw"
    assert not raw_cache.exists() or not any(raw_cache.iterdir())
    assert not list((root / "data" / "processed").glob("*.npz"))


def test_sequential_fem_matches_batched_and_resumes(roots, tmp_path, capsys):
    port, _ = roots
    root = _copy_root(port, tmp_path / "s")
    raw = root / "data" / "raw"
    assert generate_fem_dataset.main([*FEM, "--device", "cpu", "--data_root", str(root)]) == 0
    assert "resume: 3 cases already solved, 0 remaining" in capsys.readouterr().out
    argv = ["--tol", "1e-8", "--no_glb", "--force", "--device", "cpu", "--data_root", str(root)]
    assert generate_fem_dataset.main(argv) == 0
    for cid in IDS:
        rep = json.loads((raw / "fem" / cid / "fem_report.json").read_text())
        assert rep["status"] == "success" and "batched" not in rep["extra"]
        assert rep["extra"]["solver"]["rel_residual"] <= 1e-8
        a = np.load(raw / "fem" / cid / "surface_results.npz")
        b = np.load(port / "fem" / cid / "surface_results.npz")
        np.testing.assert_array_equal(a["node_id"], b["node_id"])
        for k in ("disp", "stress_vm"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 * np.abs(b[k]).max())


def _params(root: Path, cid: str) -> WingParams:
    pf = json.loads((root / "data" / "raw" / "geometry" / cid / "params.json").read_text())
    return WingParams(**pf["params"])


def test_fem_stage_without_resolution_takes_gather_path(roots, tmp_path):
    """A mesh without a recorded structured resolution skips the stencil
    engine: the gather path ("primary": kernels D and E on the card) solves
    it, with the thickness-line preconditioner from mesh.npz."""
    port, _ = roots
    root = _copy_root(port, tmp_path / "g")
    raw = root / "data" / "raw"
    mrep = json.loads((raw / "mesh" / "001" / "mesh_report.json").read_text())
    del mrep["extra"]["resolution"]
    (raw / "mesh" / "001" / "mesh_report.json").write_text(json.dumps(mrep))
    cfg = WingSolveConfig(tol=1e-8, dtype=torch.float64)
    rep = run_fem_case(_params(root, "001"), "001", get_paths(root), solve_config=cfg,
                       force=True, device="cpu")
    assert rep.status == "success", rep.failure_reason
    assert "solve_ladder" not in rep.extra and set(rep.extra["spans"]) == {"solve_primary_ms"}
    assert rep.extra["solver"]["converged"] and rep.extra["solver"]["rel_residual"] <= 1e-8
    a = np.load(raw / "fem" / "001" / "surface_results.npz")
    b = np.load(port / "fem" / "001" / "surface_results.npz")
    for k in ("disp", "stress_vm"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 * np.abs(b[k]).max())
    assert set(rep.artifacts) == {"surface_results", "wing_result_glb", "wing_result_arrows_glb"}


def test_ladder_records_failed_rungs_like_tpufem(roots, tmp_path):
    """maxiter=1 fails every rung: the stage goes stencil -> primary ->
    refined -> float64, as tpufem's does, records each attempt, and fails
    with the reason."""
    port, ref = roots
    root = _copy_root(port, tmp_path / "l")
    params = _params(root, "002")
    rep = run_fem_case(params, "002", get_paths(root), force=True, device="cpu",
                       solve_config=WingSolveConfig(tol=1e-8, maxiter=1))
    jref = _copy_root(ref, tmp_path / "jl")
    jrep = jrun_fem_case(JWingParams(**params.as_dict()), "002", jget_paths(jref), force=True,
                         solve_config=JWingSolveConfig(tol=1e-8, maxiter=1))
    assert rep.status == jrep.status == "failed"
    assert "not converged" in rep.failure_reason and "4 ladder attempts" in rep.failure_reason
    names = [(a["attempt"], a["dtype"], a["ok"]) for a in rep.extra["solve_ladder"]]
    assert names == [(a["attempt"], a["dtype"], a["ok"]) for a in jrep.extra["solve_ladder"]]
    assert names == [("stencil", "float32", False), ("primary", "float32", False),
                     ("refined", "float32", False), ("float64", "float64", False)]
    on_disk = StepReport.from_json((root / "data" / "raw" / "fem" / "002" / "fem_report.json")
                                   .read_text())
    assert on_disk.failure_reason == rep.failure_reason
    # gather only, f64: one rung, nothing to fall back to
    rep = run_fem_case(params, "002", get_paths(root), force=True, device="cpu",
                       solve_config=WingSolveConfig(maxiter=1, engine="gather",
                                                    dtype=torch.float64))
    assert rep.status == "failed" and "solve_ladder" not in rep.extra


def _write_msh2(path, mesh):
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.num_nodes)]
    for i, p in enumerate(mesh.nodes, 1):
        lines.append(f"{i} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
    lines += ["$EndNodes", "$Elements", str(mesh.num_tets)]
    for i, t in enumerate(mesh.tets + 1, 1):
        lines.append(f"{i} 4 2 0 1 {t[0]} {t[1]} {t[2]} {t[3]}")
    lines += ["$EndElements", ""]
    path.write_text("\n".join(lines))


def test_external_msh_end_to_end(tmp_path):
    """A user's MSH2 file -> mesh.npz, boundary sets, surf_sets.glb -> the
    gather path's Jacobi PCG (no thickness-line metadata) -> artifacts."""
    params = WingParams(span_m=1.2, chord_m=0.35, sweep_deg=10.0, thickness_ratio=0.10)
    src = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, COARSE)
    msh = tmp_path / "user_wing.msh"
    _write_msh2(msh, src)
    paths = get_paths(tmp_path / "data")
    m = run_mesh_case(params, "ext1", paths, user_msh=msh)
    assert m.status == "success", m.failure_reason
    assert m.extra["mesh_source"].startswith("user_msh:")
    assert m.extra["num_nodes"] == src.num_nodes and "surf_sets_glb" in m.artifacts
    cfg = WingSolveConfig(pressure=100.0, tol=1e-8, dtype=torch.float64, two_level=False)
    f = run_fem_case(params, "ext1", paths, pressure=100.0, solve_config=cfg, device="cpu")
    assert f.status == "success", f.failure_reason
    # the node count matches the recorded resolution, but a user mesh is
    # never handed to the stencil engine (it would solve the parametric wing)
    assert set(f.extra["spans"]) == {"solve_primary_ms"}
    z = np.load(paths.fem_case("ext1") / "surface_results.npz")
    assert np.isfinite(z["stress_vm"]).all()
    assert z["disp"][:, 2].mean() < 0  # downward under upper pressure


def test_geometry_stage_ingests_user_stl(tmp_path):
    """A user's STL replaces the loft: the same wing.stl, params.json and
    wing_viz.glb bytes as tpufem's stage writes."""
    from tpufem.pipeline.geometry_stage import run_geometry_case as jrun_geometry_case
    from tpufem_torch.geometry import generate_wing_surface
    from tpufem_torch.pipeline.geometry_stage import run_geometry_case
    from tpufem_torch.utils.stl import write_stl

    s = generate_wing_surface(1.3, 0.3, 12.0, 0.09, n_chord=16, n_span=4)
    stl = tmp_path / "user.stl"
    write_stl(stl, s.vertices, s.faces, header="user")
    params = WingParams(span_m=1.3, chord_m=0.3, sweep_deg=12.0, thickness_ratio=0.09)
    rep = run_geometry_case(params, get_paths(tmp_path / "a"), case_id="u", user_stl=stl)
    jrep = jrun_geometry_case(JWingParams(**params.as_dict()), jget_paths(tmp_path / "b"),
                              case_id="u", user_stl=stl)
    assert rep.status == jrep.status == "success"
    assert set(rep.artifacts) == set(jrep.artifacts) == {"wing_stl", "params_json",
                                                         "wing_viz_glb"}
    for k in rep.artifacts:
        assert Path(rep.artifacts[k]).read_bytes() == Path(jrep.artifacts[k]).read_bytes(), k
    assert json.loads(Path(rep.artifacts["params_json"]).read_text())["source"] == "user_stl"


def test_verify_easy_case(tmp_path, capsys):
    results = verify_pipeline(tmp_path, pressure=100.0, resolution=COARSE,
                              cases=SPEC_CASES[:1], device="cpu")
    assert results[0].passed, results[0].details
    assert "[PASS] easy" in capsys.readouterr().out


def test_inference_writes_glbs(roots, tmp_path):
    """inference_gnn with GLBs on: wing_pred.glb and wing_error.glb, byte for
    byte what tpufem's writers make of the same predictions."""
    port, _ = roots
    root = _copy_root(port, tmp_path / "i")
    ckpt = tmp_path / "model.pt"  # a seeded small model: 3 cases leave no validation split
    cfg = TrainConfig(model=SAGEConfig(hidden=16, num_layers=2))
    trainer = Trainer(cfg)
    trainer.save_checkpoint(ckpt, trainer.init()[0], epoch=0, val_loss=0.0)
    assert inference_gnn.main(["--split", "all", "--checkpoint", str(ckpt),
                               "--data_root", str(root), "--device", "cpu"]) == 0
    raw = root / "data" / "raw"
    for cid in IDS:
        fem = raw / "fem" / cid
        surf = dict(np.load(fem / "surface_results.npz"))
        pred = np.load(fem / "pred_results.npz")["pred_pa"]
        mesh = np.load(raw / "mesh" / cid / "mesh.npz")
        sets = json.loads((raw / "mesh" / cid / "boundary_sets.json").read_text())
        faces = mesh["surf_faces"][np.asarray(sets["surf_all_faces"], dtype=np.int64)]
        masked = surf["stress_vm"][surf["loss_mask"]]  # the FEM's [min, p98] colorbar
        jsurface_results_to_glb(tmp_path / "pred.glb", surf, faces, values=pred,
                                vmin=float(masked.min()), vmax=float(np.percentile(masked, 98)))
        assert (fem / "wing_pred.glb").read_bytes() == (tmp_path / "pred.glb").read_bytes()
        # the error map is colored from the f64 predictions, which the npz
        # keeps only in f32: hold its layout, not its bytes
        err = np.abs(pred.astype(np.float64) - surf["stress_vm"].astype(np.float64))
        jsurface_results_to_glb(tmp_path / "err.glb", surf, faces, values=err.astype(np.float32),
                                vmin=0.0, vmax=float(err.max() or 1.0), colormap=jhot)
        got, want = read_glb(fem / "wing_error.glb"), read_glb(tmp_path / "err.glb")
        assert len(got["bin"]) == len(want["bin"])
        assert got["json"]["accessors"][:2] == want["json"]["accessors"][:2]
