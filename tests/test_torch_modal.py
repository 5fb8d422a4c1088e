"""Port parity: tpufem_torch.fem.modal against tpufem.fem.modal and a dense
reference, on the CPU at tpufem's test grid 8x10x2 (LE spacing, TE floor).

- lumped_mass and the four numpy response functions on the same seeded
  inputs as tpufem's: 1e-12 (the same numpy code);
- WingModal.solve(n_modes=4) frequencies against a dense scipy.linalg.eigh of
  the (K, lumped M) pencil assembled by tpufem's refsolve: rtol 1e-6 (the
  subspace iteration stops at an eigenvalue change of 1e-9, the inner CG at
  1e-8); the eigen-residuals it reports below 1e-5; the modes M-orthonormal;
  the first mode spanwise bending;
- the solvers run on the card unless asked for the CPU, and the tet10
  family raises "not ported".
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import tpufem.fem.modal as jmodal
from tpufem.fem.material import Material as JMaterial
from tpufem.fem.refsolve import assemble_K
from tpufem.mesher import WingMeshResolution as JRes
from tpufem.mesher import structured_wing_mesh as jmesh
from tpufem.sets import build_boundary_sets as jsets
from tpufem_torch.fem import modal as tmodal
from tpufem_torch.fem.buckling import WingBuckling, WingPrestressedModal
from tpufem_torch.fem.stencil_mg import StencilMG
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh

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


@pytest.fixture(scope="module")
def dense_reference():
    """(mesh, free dofs, mass, omega^2 ascending, eigenvectors) of the dense
    generalized eigenproblem on the free dofs."""
    mat = JMaterial()
    mesh = jmesh(*PARAMS, JRes(8, 10, 2, 0.006, "le"))
    sets = jsets(mesh)
    K = assemble_K(mesh.nodes.astype(np.float64), mesh.tets, mat).toarray()
    m = jmodal.lumped_mass(mesh.nodes.astype(np.float64), mesh.tets, mat.rho)
    free = np.ones(len(mesh.nodes) * 3, bool)
    free[(3 * sets.nroot_nodes[:, None] + np.arange(3)).reshape(-1)] = False
    w, V = sla.eigh(K[np.ix_(free, free)], np.diag(np.repeat(m, 3)[free]))
    return mesh, free, m, w, V


@pytest.fixture(scope="module")
def modal_cpu():
    wm = tmodal.WingModal(RES, PARAMS, device="cpu")
    return wm, wm.solve(n_modes=4)


def test_lumped_mass_matches_tpufem():
    mesh = structured_wing_mesh(*PARAMS, RES)
    a = tmodal.lumped_mass(mesh.nodes.astype(np.float64), mesh.tets, 2700.0)
    b = jmodal.lumped_mass(mesh.nodes.astype(np.float64), mesh.tets, 2700.0)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def _fake_results(rng, N=40, k=5):
    """The same seeded ModalResult for both packages."""
    lam = np.sort(rng.uniform(50.0, 5e4, k)) ** 2
    modes = rng.standard_normal((N, 3, k))
    kw = dict(freqs_hz=np.sqrt(lam) / (2 * np.pi), lam=lam, modes=modes, sweeps=3,
              eig_residual=np.zeros(k), converged=True)
    return tmodal.ModalResult(**kw), jmodal.ModalResult(**kw)


@pytest.mark.parametrize("fn", ["harmonic_response", "transient_response", "random_response"])
def test_response_functions_match_tpufem(fn):
    rng = np.random.default_rng(5)
    rt, rj = _fake_results(rng)
    mass = rng.uniform(0.1, 1.0, 40)
    force = rng.standard_normal((40, 3))
    f = np.linspace(1.0, 60.0, 300)
    if fn == "harmonic_response":
        a = tmodal.harmonic_response(rt, mass, force, f, zeta=0.03)
        b = jmodal.harmonic_response(rj, mass, force, f, zeta=0.03)
    elif fn == "transient_response":
        t = np.linspace(0.0, 0.5, 400)
        g = np.where(t < 0.1, 0.5 * (1 - np.cos(2 * np.pi * t / 0.1)), 0.0)
        a = tmodal.transient_response(rt, force, g, t, zeta=0.02)
        b = jmodal.transient_response(rj, force, g, t, zeta=0.02)
    else:
        s = tmodal.von_karman_psd(f, 2.0, 50.0, 30.0)
        a = np.concatenate([x.reshape(-1) for x in
                            tmodal.random_response(rt, mass, force, f, s, chunk=64)])
        b = np.concatenate([x.reshape(-1) for x in
                            jmodal.random_response(rj, mass, force, f, s, chunk=64)])
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


def test_von_karman_psd_matches_tpufem():
    f = np.geomspace(1e-3, 200.0, 500)
    a = tmodal.von_karman_psd(f, 2.0, 50.0, 30.0)
    b = jmodal.von_karman_psd(f, 2.0, 50.0, 30.0)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def test_modal_matches_dense_eigh(modal_cpu, dense_reference):
    _, free, m, w, V = dense_reference
    wm, out = modal_cpu
    assert out.converged, out.sweeps
    np.testing.assert_allclose(out.freqs_hz, np.sqrt(w[:4]) / (2 * np.pi), rtol=1e-6)
    assert np.all(out.eig_residual < 1e-5), out.eig_residual
    # M-orthonormal modes, root rows zero, aligned with the dense eigenvectors
    mf = np.repeat(m, 3)[free]
    phi = out.modes.reshape(-1, 4)[free]
    np.testing.assert_allclose(phi.T @ (mf[:, None] * phi), np.eye(4), atol=1e-6)
    assert np.abs(out.modes[~wm.free_rows]).max() == 0.0
    for i in range(3):  # the lowest three are well separated
        assert abs(phi[:, i] @ (mf * V[:, i])) > 0.999999


def test_first_mode_is_spanwise_bending(modal_cpu):
    """The logic of tests/test_modal.py::test_first_mode_is_spanwise_bending."""
    wm, out = modal_cpu
    phi = out.modes[:, :, 0]
    comp = (phi**2).sum(axis=0)
    assert comp[2] > 5 * max(comp[0], comp[1])
    y = wm.mesh.nodes[:, 1]
    span = y.max() - y.min()
    amp = np.abs(phi[:, 2])
    tip = amp[y > y.min() + 0.8 * span].mean()
    mid = amp[(y > y.min() + 0.4 * span) & (y < y.min() + 0.6 * span)].mean()
    root = amp[y < y.min() + 0.2 * span].mean()
    assert tip > mid > root
    assert out.freqs_hz[0] > 0 and out.freqs_hz[1] / out.freqs_hz[0] > 1.5


def test_block_solve_keeps_per_q_state(modal_cpu):
    """_prepare is cached per q, and a block solve reaches inner_tol."""
    wm, _ = modal_cpu
    state = wm._mstate
    wm._prepare(wm._block)
    assert wm._mstate is state
    rng = np.random.default_rng(1)
    B = rng.standard_normal((wm.num_nodes, 3, wm._block))
    B[~wm.free_rows] = 0.0
    Y, iters = wm._block_solve(B, tol=1e-10)
    r = wm._apply_K(Y) - B
    assert 0 < iters <= wm.inner_maxiter
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(B)


@pytest.mark.parametrize("entry", ["StencilMG", "WingModal", "WingBuckling",
                                   "WingPrestressedModal"])
def test_dynamics_entry_points_default_to_the_card(monkeypatch, entry):
    """With no CUDA device the default raises instead of falling back."""
    calls = {"StencilMG": lambda: StencilMG(RES),
             "WingModal": lambda: tmodal.WingModal(RES, PARAMS),
             "WingBuckling": lambda: WingBuckling(RES, PARAMS),
             "WingPrestressedModal": lambda: WingPrestressedModal(RES, PARAMS)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_tet10_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported: tet10"):
        tmodal.WingModal10(RES, PARAMS)
