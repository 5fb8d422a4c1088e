"""Port parity: tpufem_torch.fem.buckling against tpufem.fem.buckling and the
dense references of tests/test_buckling.py, on the CPU at tpufem's test
grid 8x10x2 (LE spacing, TE floor) and its sharp-TE variant.

- element_stress and geom_apply (the plain versions kernels F and G are
  held to on the card) on the same seeded inputs as tpufem's: 1e-12 of the
  largest entry (the same arithmetic), geom_apply also on a non-symmetric
  sigma; geom_apply against the scattered numpy assembly of K_G: 1e-12;
- WingBuckling factors (n_modes 2) against the dense (-K_G, K) pencil with
  sigma0 from scipy's static solve: rtol 1e-5 (tpufem's bar);
- WingPrestressedModal at p = 0 equals WingModal (the extra term adds
  0 * K_G x: the same bits), and at p = 0.5 lambda_cr its frequencies match
  the dense (K + p K_G, M) pencil: rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import tpufem.fem.buckling as jbk
import tpufem.fem.stencil as jst
from tpufem.fem.material import Material as JMaterial
from tpufem.fem.material import lame_params as jlame
from tpufem.fem.refsolve import assemble_K, direct_solve, tet4_setup_np
from tpufem.mesher import WingMeshResolution as JRes
from tpufem.mesher import structured_wing_mesh as jmesh
from tpufem.sets import build_boundary_sets as jsets
from tpufem_torch.fem import buckling as tbk
from tpufem_torch.fem import stencil as tst
from tpufem_torch.fem.modal import WingModal, lumped_mass
from tpufem_torch.mesher import WingMeshResolution

PARAMS = (1.2, 0.35, 10.0, 0.10)
RES = WingMeshResolution(8, 10, 2, 0.006, "le")
PRESSURE = 5e3
LAM, MU = jlame(JMaterial())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kg_coefs(mesh, u):
    """(T,4,4) scalar coefficients V * g_a^T sigma g_b of K_G from a host
    displacement field (tests/test_buckling.py's numpy reference)."""
    grads, vols = tet4_setup_np(mesh.nodes.astype(np.float64), mesh.tets)
    H = np.einsum("tad,tae->tde", grads, u[mesh.tets])
    eps = 0.5 * (H + np.swapaxes(H, 1, 2))
    tr = np.trace(eps, axis1=1, axis2=2)
    sig = 2 * MU * eps + LAM * tr[:, None, None] * np.eye(3)
    sg = np.einsum("tde,tbe->tbd", sig, grads)
    return np.einsum("tad,tbd->tab", grads, sg) * np.abs(vols)[:, None, None]


def _grid_inputs(te, q=2, seed=0):
    """The same seeded grid inputs for both packages: geometry of q wings,
    a pre-stress displacement u0 and a block x, as numpy."""
    ra = JRes(8, 10, 2, te, "le")
    rb = WingMeshResolution(8, 10, 2, te, "le")
    p4 = np.array([PARAMS, (1.8, 0.25, 25.0, 0.07)][:q])
    rng = np.random.default_rng(seed)
    N = jst.grid_meta(ra)["num_nodes"]
    u0 = 1e-3 * rng.standard_normal((N, 3, q))
    x = rng.standard_normal((N, 3, q))
    return ra, rb, p4, u0, x


@pytest.mark.parametrize("te", [0.006, 0.0], ids=["te_floor", "sharp_te"])
def test_element_stress_and_geom_apply_match_tpufem(te):
    ra, rb, p4, u0, x = _grid_inputs(te)
    geo_a = jst.cell_geometry(ra, jst.nodes_grid(ra, jnp.asarray(p4), jnp.float64))
    geo_b = tst.cell_geometry(rb, tst.nodes_grid(rb, torch.as_tensor(p4), torch.float64))
    free_a = np.ones((1, 1, 1, 1, rb.n_span + 1))
    free_a[..., 0] = 0.0
    sig_a = jbk.element_stress(ra, geo_a, jst.to_grid(ra, jnp.asarray(u0)), LAM, MU)
    sig_b = tbk.element_stress(rb, geo_b, tst.to_grid(rb, torch.as_tensor(u0)), LAM, MU)
    sig_a = np.asarray(sig_a)
    np.testing.assert_allclose(sig_b.numpy(), sig_a, rtol=0, atol=1e-12 * np.abs(sig_a).max())
    assert torch.equal(sig_b, sig_b.transpose(1, 2))  # symmetric in the component axes
    y_a = np.asarray(jbk.geom_apply(ra, geo_a, jnp.asarray(sig_a), jst.to_grid(ra, jnp.asarray(x)),
                                    jnp.asarray(free_a)))
    y_b = tbk.geom_apply(rb, geo_b, sig_b, tst.to_grid(rb, torch.as_tensor(x)),
                         torch.as_tensor(free_a)).numpy()
    np.testing.assert_allclose(y_b, y_a, rtol=0, atol=1e-12 * np.abs(y_a).max())
    assert np.abs(y_b[..., 0]).max() == 0.0  # no Dirichlet identity: root rows are zero


@pytest.mark.parametrize("te", [0.006, 0.0], ids=["weld_te_off", "weld_te_on"])
def test_geom_apply_nonsymmetric_sigma_matches_tpufem(te):
    """On a seeded non-symmetric sigma, geom_apply_plain (kernel G's
    reference) computes tpufem's V * sum_b (g_a^T sigma g_b) u_b, not the
    transposed form, which agrees only on a symmetric sigma."""
    ra, rb, p4, _, x = _grid_inputs(te)
    geo_a = jst.cell_geometry(ra, jst.nodes_grid(ra, jnp.asarray(p4), jnp.float64))
    geo_b = tst.cell_geometry(rb, tst.nodes_grid(rb, torch.as_tensor(p4), torch.float64))
    free = np.ones((1, 1, 1, 1, rb.n_span + 1))
    free[..., 0] = 0.0
    sig = np.random.default_rng(1).standard_normal(tst.grid_shapes(rb, len(p4))["sig"])
    assert np.abs(sig - np.swapaxes(sig, 1, 2)).max() > 1.0
    y_a = np.asarray(jbk.geom_apply(ra, geo_a, jnp.asarray(sig), jst.to_grid(ra, jnp.asarray(x)),
                                    jnp.asarray(free)))
    y_b = tbk.geom_apply_plain(rb, geo_b, torch.as_tensor(sig), tst.to_grid(rb, torch.as_tensor(x)),
                               torch.as_tensor(free)).numpy()
    assert np.abs(y_b - y_a).max() <= 1e-12 * np.abs(y_a).max()
    # the transposed form is a different operator here
    y_t = tbk.geom_apply_plain(rb, geo_b, torch.as_tensor(np.swapaxes(sig, 1, 2).copy()),
                               tst.to_grid(rb, torch.as_tensor(x)), torch.as_tensor(free)).numpy()
    assert np.abs(y_t - y_a).max() > 1e-3 * np.abs(y_a).max()


def test_geom_apply_matches_numpy_assembly():
    """The port's grid K_G apply == the scattered numpy assembly (the test of
    tests/test_buckling.py::test_geom_apply_matches_numpy_assembly)."""
    mesh = jmesh(*PARAMS, JRes(8, 10, 2, 0.006, "le"))
    sets = jsets(mesh)
    N = len(mesh.nodes)
    free_rows = np.ones(N, bool)
    free_rows[sets.nroot_nodes] = False
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal((N, 3, 1))
    u0[~free_rows] = 0.0
    x = rng.standard_normal((N, 3, 1))
    x[~free_rows] = 0.0

    coef = _kg_coefs(mesh, u0[:, :, 0])
    ye = np.einsum("tab,tbi->tai", coef, x[mesh.tets, :, 0])
    y_np = np.zeros((N, 3))
    np.add.at(y_np, mesh.tets.reshape(-1), ye.reshape(-1, 3))
    y_np[~free_rows] = 0.0

    X = tst.nodes_grid(RES, torch.as_tensor(np.array([PARAMS])), torch.float64)
    geo = tst.cell_geometry(RES, X)
    free = torch.ones((1, 1, 1, 1, RES.n_span + 1), dtype=torch.float64)
    free[..., 0] = 0.0
    sig = tbk.element_stress(RES, geo, tst.to_grid(RES, torch.as_tensor(u0)), LAM, MU)
    yg = tbk.geom_apply(RES, geo, sig, tst.to_grid(RES, torch.as_tensor(x)), free)
    y = tst.from_grid(RES, yg)[:, :, 0].numpy()
    assert np.abs(y - y_np).max() / np.abs(y_np).max() < 1e-12


@pytest.mark.parametrize("bad", ["none", "sig_shape", "vol_dtype", "g_strided", "u_grad"])
@pytest.mark.parametrize("kernel", ["F", "G"])
def test_kernel_f_g_operand_check(kernel, bad):
    """What kernels F and G take is checked before any launch, by the check
    kernel B's wrapper uses (fem.stencil.check_grid_operands) over the
    operands each wrapper passes it. It holds on CPU tensors too, so it is
    tested here; the CUDA wrappers raise on the same inputs
    (tests/test_torch_kernels.py)."""
    _, rb, p4, u0, x = _grid_inputs(0.006)
    g, vol = tst.cell_geometry(rb, tst.nodes_grid(rb, torch.as_tensor(p4), torch.float64))
    u = tst.to_grid(rb, torch.as_tensor(x))
    sig = tbk.element_stress(rb, (g, vol), tst.to_grid(rb, torch.as_tensor(u0)), LAM, MU)
    free = torch.ones((1, 1, 1, 1, rb.n_span + 1), dtype=torch.float64)
    if bad == "sig_shape":
        sig = sig[:, :, :, :1].contiguous()
    elif bad == "vol_dtype":
        vol = vol.float()
    elif bad == "g_strided":
        g = g.transpose(4, 6).contiguous().transpose(4, 6)
    elif bad == "u_grad":
        u = u.requires_grad_()
    want = tst.grid_shapes(rb, u.shape[1])
    ops = {"g": (g, want["g"])} if kernel == "F" else {
        k: (t, want[k]) for k, t in (("g", g), ("vol", vol), ("sig", sig), ("free", free))}
    check = lambda: tst.check_grid_operands(kernel, rb, u, ops)  # noqa: E731
    if bad == "none" or (kernel == "F" and bad in ("sig_shape", "vol_dtype")):
        check()  # F reads neither sig nor vol
    else:
        with pytest.raises((ValueError, TypeError)):
            check()


@pytest.fixture(scope="module")
def dense_pencil():
    """(K, K_G, M diagonal, free dofs) of the 8x10x2 wing, sigma0 from an
    independent scipy static solve."""
    mesh = jmesh(*PARAMS, JRes(8, 10, 2, 0.006, "le"))
    sets = jsets(mesh)
    mat = JMaterial()
    N = len(mesh.nodes)
    u_ref, _, _ = direct_solve(mesh, sets, pressure=PRESSURE, mat=mat)
    coef = _kg_coefs(mesh, u_ref)
    KG = np.zeros((3 * N, 3 * N))
    dof = 3 * mesh.tets  # (T,4)
    for i in range(3):
        np.add.at(
            KG,
            (np.repeat(dof + i, 4, axis=1).reshape(-1), np.tile(dof + i, (1, 4)).reshape(-1)),
            coef.reshape(-1),
        )
    K = assemble_K(mesh.nodes.astype(np.float64), mesh.tets, mat).toarray()
    free = np.ones(3 * N, bool)
    free[(3 * sets.nroot_nodes[:, None] + np.arange(3)).reshape(-1)] = False
    m = np.repeat(lumped_mass(mesh.nodes.astype(np.float64), mesh.tets, mat.rho), 3)
    ix = np.ix_(free, free)
    return K[ix], KG[ix], m[free]


@pytest.fixture(scope="module")
def buckling_cpu():
    wb = tbk.WingBuckling(RES, PARAMS, pressure=PRESSURE, device="cpu")
    return wb.solve(n_modes=2, tol=1e-7)


def test_buckling_factors_match_dense_pencil(buckling_cpu, dense_pencil):
    K, KG, _ = dense_pencil
    nu = sla.eigh(-KG, K, eigvals_only=True)
    lam_ref = np.sort(1.0 / nu[nu > 0])[:2]
    out = buckling_cpu
    assert out.converged, out.sweeps
    # one history entry per sweep; only a sweep at the full inner tolerance stops
    assert len(out.history) == out.sweeps and out.history[-1][0] == 1e-8
    assert out.history[-1][2] < 1e-7
    np.testing.assert_allclose(out.factors, lam_ref, rtol=1e-5)
    assert out.load_factor > 10.0  # the solid-section wing is far from buckling
    assert out.modes.shape[1:] == (3, 2)


def test_prestressed_modal_matches_free_vibration_and_dense_pencil(buckling_cpu, dense_pencil):
    K, KG, m = dense_pencil
    wpm = tbk.WingPrestressedModal(RES, PARAMS, pressure=PRESSURE, device="cpu")
    free_vib = WingModal(RES, PARAMS, device="cpu").solve(n_modes=4)
    p = 0.5 * buckling_cpu.load_factor
    at0, out = wpm.frequency_sweep([0.0, p], n_modes=4)  # the second warm-starts
    np.testing.assert_array_equal(at0.freqs_hz, free_vib.freqs_hz)
    assert out.converged, out.sweeps
    w = sla.eigh(K + p * KG, np.diag(m), eigvals_only=True)[:4]
    np.testing.assert_allclose(out.freqs_hz, np.sqrt(w) / (2 * np.pi), rtol=1e-6)
    assert out.freqs_hz[0] < at0.freqs_hz[0]  # the pre-stress softens the first mode
