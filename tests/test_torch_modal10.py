"""The tet10 slice's user-facing pieces on the CPU: WingModal10 against an
independent scipy shift-invert, and the two CLIs.

- WingModal10 (the doubled-grid p-MG block solver) at tpufem's test grid
  8x10x2: 4 frequencies equal scipy.sparse.linalg.eigsh (shift-invert at 0)
  of the port's assemble_K10 with the HRZ mass lumped_mass10 to 1e-7, its
  eigen-residuals below 1e-4 (tpufem's own test of WingModal10), and the
  first mode spanwise bending;
- modal_analysis --element tet10 --device cpu writes tpufem's report keys
  for the quadratic mesh and its mode GLBs (the T6 faces' corner
  triangles);
- solve_tet10_1m on the CPU, its resolution cut to a 6x4x2 wing, --no_xprec:
  converged on the TRUE f64 residual, tpufem's JSON keys; with xprec, the
  80-bit residual within the tolerance; --engine gather exits nonzero with
  "not ported"; the default device raises without a card.
"""

import json

import numpy as np
import pytest
import scipy.sparse as ssp
import scipy.sparse.linalg as spla
import torch

from tpufem_torch.fem.material import Material
from tpufem_torch.fem.modal import WingModal10
from tpufem_torch.fem.refsolve import assemble_K10
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.scripts import modal_analysis, solve_tet10_1m
from tpufem_torch.viz.glb import read_glb

PARAMS = (1.2, 0.35, 10.0, 0.10)
RES = WingMeshResolution(8, 10, 2, 0.006, "le")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_modal10_matches_scipy_eigsh():
    mat = Material()
    wm = WingModal10(RES, PARAMS, material=mat, device="cpu")
    K = assemble_K10(wm.nodes10, wm.t10.tet10, mat)
    free = np.repeat(wm.free_rows, 3)
    w, _ = spla.eigsh(K[free][:, free], k=4, M=ssp.diags(np.repeat(wm.mass, 3)[free]),
                      sigma=0, which="LM")
    f_ref = np.sqrt(np.sort(w)) / (2 * np.pi)
    out = wm.solve(n_modes=4)
    assert out.converged, out.sweeps
    np.testing.assert_allclose(out.freqs_hz, f_ref, rtol=1e-7)
    assert np.all(out.eig_residual[:3] < 1e-4), out.eig_residual
    # the first mode bends the wing spanwise: its tip moves most, along z
    phi = out.modes[:, :, 0]
    y = wm.nodes10[:, 1]
    tip = y > 0.95 * y.max()
    assert np.abs(phi[tip, 2]).mean() > 5 * np.abs(phi[tip, :2]).mean()


def test_modal_cli_tet10_on_cpu(tmp_path):
    out = tmp_path / "modal10"
    rc = modal_analysis.main(["--element", "tet10", "--device", "cpu", "--n_chord", "6",
                              "--n_span", "4", "--n_thick", "2", "--n_modes", "2",
                              "--max_sweeps", "6", "--tol", "1e-4", "--glb", "--frf",
                              "--out", str(out)])
    assert rc == 0
    rep = json.loads((out / "modal_report.json").read_text())
    assert rep["element"] == "tet10" and len(rep["freqs_hz"]) == 2
    assert rep["n_dof"] == 3 * rep["num_nodes"] and rep["freqs_hz"][0] > 0
    assert set(rep) == {"params", "resolution", "element", "num_nodes", "n_dof", "freqs_hz",
                        "eig_residual", "sweeps", "converged", "wall_s"}
    frf = json.loads((out / "frf.json").read_text())
    assert max(frf["tip_uz_amplitude_m"]) > 0
    glbs = sorted(out.glob("mode_*.glb"))
    assert len(glbs) == 2 and read_glb(glbs[0])["json"]["meshes"]


@pytest.fixture
def tiny_flagship(monkeypatch):
    monkeypatch.setattr(solve_tet10_1m, "RESOLUTION", WingMeshResolution(6, 4, 2, 0.006, "le"))


def test_solve_tet10_cli_on_cpu(tiny_flagship, capsys):
    assert solve_tet10_1m.main(["--device", "cpu", "--refine", "8", "--tol", "1e-6"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = rec["detail"]
    assert rec["metric"] == "fem_tet10_1mdof_mg_pcg_single_chip" and rec["unit"] == "s"
    assert d["converged"] and d["rel_residual"] <= 1e-6 and d["mode"] == "refine x8"
    assert d["residual_metric"] == "true f64 residual" and d["device"] == "cpu"
    assert d["xprec_rel_residual"] <= 1e-6 and d["max_vm_mpa"] > 0
    for k in ("dof", "num_tet10", "iters", "tol", "engine", "first_run_incl_compile_s"):
        assert k in d
    assert solve_tet10_1m.main(["--device", "cpu", "--no_xprec", "--refine", "0",
                                "--tol", "1e-6"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
    assert d["converged"] and d["mode"] == "f64 outer" and d["xprec_rel_residual"] is None


def test_solve_tet10_cli_gather_engine_and_defaults_to_the_card(tiny_flagship, monkeypatch,
                                                               capsys):
    assert solve_tet10_1m.main(["--engine", "gather", "--device", "cpu", "--refine", "8",
                                "--tol", "1e-6"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
    assert d["engine"] == "gather" and d["converged"] and d["rel_residual"] <= 1e-6
    assert d["xprec_rel_residual"] <= 1e-6 and d["max_vm_mpa"] > 0 and "solve_s" in d["timing_s"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_tet10_1m.main(["--no_xprec"])
