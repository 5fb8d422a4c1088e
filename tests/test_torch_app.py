"""The port's pipeline leftovers and dynamics CLIs against tpufem's, on the
CPU: a 3-case dataset (12x8x2, --seed 7) written by the port's dataset CLIs,
and the dynamics CLIs on tpufem's test grid 8x10x2.

- validate_case / run_validation give tpufem's results on the same data root
  (the environment probe aside: torch and the cards instead of JAX), and the
  validate_dataset / repair_geometry_glb CLIs behave as tpufem's
  (tests/test_cli.py);
- the app_core functions give tpufem's outputs on the same artifacts
  (ai_status names the port's inference CLI), the histogram is drawn, and a
  missing matplotlib raises a clear ImportError; dynamics_entries reads the
  port's dynamics reports as tpufem's does; the static dashboard is written;
- each dynamics CLI runs with --device cpu and writes tpufem's report keys
  (read from tpufem's scripts), --element tet10 exits "not ported", and the
  default device raises without a card.
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpufem.app_core as japp
from tpufem.pipeline.config import get_paths as jget_paths
from tpufem.pipeline.validate import ValidationThresholds as JThresholds
from tpufem.pipeline.validate import run_validation as jrun_validation
from tpufem.pipeline.validate import validate_case as jvalidate_case
from tpufem_torch import app as tapp
from tpufem_torch import app_core as tapp_core
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.reports import append_csv
from tpufem_torch.pipeline.validate import ValidationThresholds, run_validation, validate_case
from tpufem_torch.scripts import (
    buckling_analysis,
    generate_fem_dataset,
    generate_geometry_dataset,
    generate_mesh_dataset,
    modal_analysis,
    prestress_sweep,
    repair_geometry_glb,
    validate_dataset,
)
from tpufem_torch.viz.glb import is_binary_glb

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--n_chord", "8", "--n_span", "10", "--n_thick", "2", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("app_root"))
    assert generate_geometry_dataset.main(["--count", "3", "--seed", "7", "--data_root", r]) == 0
    assert generate_mesh_dataset.main(["--n_chord", "12", "--n_span", "8", "--n_thick", "2",
                                       "--data_root", r]) == 0
    assert generate_fem_dataset.main(["--batched", "--tol", "1e-8", "--device", "cpu",
                                      "--data_root", r]) == 0
    return r


@pytest.fixture(scope="module")
def dynamics(tmp_path_factory):
    """A results directory written by the port's three dynamics CLIs."""
    d = tmp_path_factory.mktemp("results")
    assert modal_analysis.main([*SMALL, "--n_modes", "4", "--frf", "--gust", "--psd", "--glb",
                                "--out", str(d / "modal_demo")]) == 0
    assert buckling_analysis.main([*SMALL, "--n_modes", "2", "--glb",
                                   "--out", str(d / "buckling_demo")]) == 0
    assert prestress_sweep.main([*SMALL, "--n_modes", "2", "--load_factors", "0", "2000",
                                 "--out", str(d / "prestress")]) == 0
    return d


def _without_environment(report):
    return {k: v for k, v in report.items() if k != "environment"}


def test_validation_matches_tpufem(root):
    paths, jpaths = get_paths(root), jget_paths(root)
    for cid in ("001", "002", "003"):
        assert validate_case(cid, paths, ValidationThresholds()) == jvalidate_case(
            cid, jpaths, JThresholds())
    mine = run_validation(paths, ValidationThresholds(min_solved_cases=1))
    ref = jrun_validation(jpaths, JThresholds(min_solved_cases=1))
    assert _without_environment(mine) == _without_environment(ref)
    assert mine["num_cases"] == 3 and mine["all_passed"]
    env = mine["environment"]
    assert env["torch"] == torch.__version__ and isinstance(env["devices"], list)
    assert "jax" not in env


def test_cli_validator_and_glb_repair(root):
    assert validate_dataset.main(["--min_solved", "3", "--data_root", root]) == 0
    assert validate_dataset.main(["--min_solved", "4", "--data_root", root]) == 1
    glb = Path(root) / "data" / "raw" / "geometry" / "001" / "wing_viz.glb"
    glb.write_text("not a glb")
    assert repair_geometry_glb.main(["--data_root", root]) == 0
    assert is_binary_glb(glb)


def test_app_core_matches_tpufem(root, tmp_path):
    paths, jpaths = get_paths(root), jget_paths(root)
    append_csv(paths.data / "params.csv", {"case_id": "001", "status": "success"})
    assert tapp_core.list_cases(paths) == japp.list_cases(jpaths)
    assert "001" in tapp_core.list_cases(paths)
    for view in tapp_core.VIEW_MODES:
        assert tapp_core.case_glbs(paths, "001", view) == japp.case_glbs(jpaths, "001", view)
    assert tapp_core.case_glbs(paths, "001", "FEM Only")["left"].exists()
    rep = tapp_core.engineering_report(paths, "001")
    assert rep == japp.engineering_report(jpaths, "001")
    assert "Safety factor" in rep and "AL6061" in rep
    for mpa in (100.0, 200.0, 300.0):
        assert tapp_core.safety_factor_band(mpa) == japp.safety_factor_band(mpa)
    assert tapp_core.model_summary(paths) == japp.model_summary(jpaths)
    assert "tpufem_torch.scripts.inference_gnn" in tapp_core.ai_status(paths, "001")
    png = tapp_core.stress_histogram_png(paths, "001", tmp_path / "hist.png")
    assert png is not None and png.read_bytes()[:4] == b"\x89PNG"


def test_histogram_without_matplotlib_raises_clearly(root, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib, which is not installed"):
        tapp_core.stress_histogram_png(get_paths(root), "001", tmp_path / "h.png")


def test_static_dashboard(root, tmp_path):
    assert tapp.main(["--data_root", root, "--static_out", str(tmp_path / "site")]) == 0
    index = (tmp_path / "site" / "index.html").read_text()
    assert "001.html" in index
    assert (tmp_path / "site" / "001.html").exists()


def _tpufem_report_keys(script: str) -> dict:
    """{json file name: the keys tpufem's script writes there}, read from the
    dict literals of its source (the `record` dict or json.dumps({...}))."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    record, out = None, {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "record"):
            record = [k.value for k in node.value.keys]
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "write_text":
            name = node.func.value.right.value
            x = node.args[0].args[0]  # json.dumps(x, ...)
            out[name] = record if isinstance(x, ast.Name) else [k.value for k in x.keys]
    return out


@pytest.mark.parametrize("script,subdir", [("modal_analysis.py", "modal_demo"),
                                           ("buckling_analysis.py", "buckling_demo"),
                                           ("prestress_sweep.py", "prestress")])
def test_dynamics_cli_reports_have_tpufem_keys(dynamics, script, subdir):
    keys = _tpufem_report_keys(script)
    assert keys
    for name, want in keys.items():
        got = json.loads((dynamics / subdir / name).read_text())
        assert list(got) == want, name


def test_dynamics_cli_outputs(dynamics):
    modal = json.loads((dynamics / "modal_demo" / "modal_report.json").read_text())
    assert modal["converged"] and modal["n_dof"] == 825 and len(modal["freqs_hz"]) == 4
    assert len(list((dynamics / "modal_demo").glob("mode_*.glb"))) == 4
    buck = json.loads((dynamics / "buckling_demo" / "buckling_report.json").read_text())
    assert buck["converged"] and buck["load_factor"] > 10.0
    assert len(list((dynamics / "buckling_demo").glob("buckling_mode_*.glb"))) == 2
    sweep = json.loads((dynamics / "prestress" / "prestress_sweep.json").read_text())
    f0, f1 = np.array(sweep["freqs_hz"])
    np.testing.assert_allclose(f0, modal["freqs_hz"][:2], rtol=1e-6)
    assert f1[0] < f0[0] and sweep["lambda_cr"] is None


def test_dynamics_entries_match_tpufem(dynamics):
    mine = tapp_core.dynamics_entries(dynamics)
    assert mine == japp.dynamics_entries(dynamics)
    assert [e["label"] for e in mine] == ["buckling_demo", "modal_demo", "prestress"]
    assert len(mine[1]["glbs"]) == 4 and "Modal" in mine[1]["summary"]


def test_modal_cli_refuses_tet10_and_defaults_to_the_card(monkeypatch, capsys):
    assert modal_analysis.main(["--element", "tet10", "--device", "cpu"]) == 2
    assert "not ported: tet10" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (modal_analysis, buckling_analysis, prestress_sweep):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--n_chord", "8", "--n_span", "10", "--n_thick", "2"])
