"""Port parity: tpufem_torch.fem.nonlinear.WingNonlinear and the
nonlinear_solve CLI against tpufem, on the CPU.

- WingNonlinear at tpufem's small-load configuration (8x10x2, pressure 1 Pa,
  one load step, newton_tol 1e-8): both packages' solves in a module
  fixture; the nonlinear and the linear u within 1e-6 relative;
- the CLI with --device cpu at a tiny size writes tpufem's report keys
  (those of results/nonlinear_demo/nonlinear_report.json) and both
  deformed-wing GLBs.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tpufem.fem.nonlinear as jnl
from tpufem.mesher import WingMeshResolution as JRes
from tpufem_torch.fem.nonlinear import WingNonlinear
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.scripts import nonlinear_solve
from tpufem_torch.viz.glb import read_glb

REPO = Path(__file__).resolve().parents[1]
PARAMS = (1.2, 0.35, 10.0, 0.10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_load():
    """(port result, tpufem result) at tpufem's small-load test configuration."""
    kw = {"pressure": 1.0, "inner_tol": 1e-10, "inner_maxiter": 800}
    port = WingNonlinear(WingMeshResolution(8, 10, 2, 0.006, "le"), PARAMS, device="cpu",
                         **kw).solve(n_steps=1, newton_tol=1e-8)
    ref = jnl.WingNonlinear(JRes(8, 10, 2, 0.006, "le"), PARAMS, **kw).solve(
        n_steps=1, newton_tol=1e-8)
    return port, ref


def test_small_load_solve_matches_tpufem(small_load):
    port, ref = small_load
    assert port.converged and ref.converged
    for got, want in ((port.u, ref.u), (port.u_linear, ref.u_linear)):
        assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    # at a light load the nonlinear solve lands on the linear one (tpufem's bar)
    assert np.linalg.norm(port.u - port.u_linear) < 1e-3 * np.linalg.norm(port.u_linear)
    assert port.history[0]["rel_residual"] <= 1e-8


def test_cli_writes_tpufem_report_keys(tmp_path):
    out = tmp_path / "nl"
    rc = nonlinear_solve.main(["--n_chord", "4", "--n_span", "6", "--n_thick", "2",
                               "--n_steps", "1", "--pressure", "1e3", "--inner_tol", "1e-9",
                               "--glb", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    rep = json.loads((out / "nonlinear_report.json").read_text())
    ref = json.loads((REPO / "results/nonlinear_demo/nonlinear_report.json").read_text())
    assert set(rep) == set(ref)
    assert set(rep["tip_deflection_m"]) == set(ref["tip_deflection_m"])
    assert rep["converged"] and rep["resolution"] == [4, 6, 2]
    assert 0 < rep["tip_deflection_m"]["nonlinear"] and np.isfinite(
        rep["max_von_mises_pa"]["nonlinear_cauchy"])
    for name in ("nonlinear", "linear"):
        assert len(read_glb(out / f"wing_{name}_deformed.glb")["json"]["meshes"]) == 1
