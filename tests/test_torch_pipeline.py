"""The port's dataset CLIs against tpufem's, on the CPU: 3 cases (--seed 7),
mesh 12x8x2, batched FEM at tol 1e-8, each package in its own data root.

- case ids, params.json (bytes), mesh.npz (arrays) and boundary_sets.json
  (text) are identical;
- surface_results.npz is exact in its integer and mask arrays; the float
  arrays agree to 1e-5 of each array's max (two converged f64-outer solves);
- tpufem's pydantic models parse the port's reports and the port's schemas
  parse tpufem's;
- the port's WingStressDataset builds the same split json and padded graphs
  as tpufem's on the same data, and cache=False writes no per-case cache;
- the sequential FEM path (the stage's B=1 stencil solve) agrees with the
  batched one, a rerun of the batched CLI resumes, and a case that needs a
  non-stencil rung of the solve ladder fails with a reason;
- without --no_glb the port's CLIs stop with an error (GLB is not ported).
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from tpufem.models.dataset import WingStressDataset as JWingStressDataset
from tpufem.pipeline.config import get_paths as jget_paths
from tpufem.pipeline.types import ParamsFile as JParamsFile
from tpufem.pipeline.types import StepReport as JStepReport
from tpufem_torch.fem.driver import WingSolveConfig
from tpufem_torch.models.dataset import WingStressDataset
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.fem_stage import run_fem_case
from tpufem_torch.pipeline.types import ParamsFile, StepReport, WingParams
from tpufem_torch.scripts import (
    generate_fem_dataset,
    generate_geometry_dataset,
    generate_mesh_dataset,
    inference_gnn,
)

REPO = Path(__file__).resolve().parents[1]
IDS = ["001", "002", "003"]
GEO = ["--count", "3", "--seed", "7", "--no_glb"]
MESH = ["--n_chord", "12", "--n_span", "8", "--n_thick", "2"]
FEM = ["--batched", "--tol", "1e-8", "--no_glb"]


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


def test_fem_stage_reports_unported_ladder_rungs(roots, tmp_path):
    """A mesh without a recorded structured resolution needs the gather
    driver, which is not ported: the case fails and says so."""
    port, _ = roots
    root = _copy_root(port, tmp_path / "g")
    raw = root / "data" / "raw"
    mrep = json.loads((raw / "mesh" / "001" / "mesh_report.json").read_text())
    del mrep["extra"]["resolution"]
    (raw / "mesh" / "001" / "mesh_report.json").write_text(json.dumps(mrep))
    pf = json.loads((raw / "geometry" / "001" / "params.json").read_text())
    rep = run_fem_case(WingParams(**pf["params"]), "001", get_paths(root),
                       solve_config=WingSolveConfig(tol=1e-8), force=True, device="cpu")
    assert rep.status == "failed" and "not ported" in rep.failure_reason
    on_disk = StepReport.from_json(
        (root / "data" / "raw" / "fem" / "001" / "fem_report.json").read_text())
    assert on_disk.failure_reason == rep.failure_reason


@pytest.mark.parametrize("mod,argv", [
    (generate_geometry_dataset, ["--count", "1"]),
    (generate_fem_dataset, ["--batched", "--device", "cpu"]),
    (inference_gnn, ["--device", "cpu"]),
])
def test_glb_output_is_refused(mod, argv, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        mod.main([*argv, "--data_root", str(tmp_path)])
    assert e.value.code != 0
    assert "not ported" in capsys.readouterr().err
    assert not (tmp_path / "data").exists()  # stopped before writing anything
