"""Port parity: the tet10 elements of tpufem_torch.fem.tet10, refsolve and
xprec against tpufem's, on the CPU in f64.

- DNDXI and the promoted mesh (tet10_from_tet4: connectivity, midpoint
  endpoints, T6 faces, doubled-grid stations and slots) equal tpufem's on a
  6x4x2 sharp-TE and an 8x6x2 floored wing;
- tet10_setup, tet10_force, pressure_loads_t6 (one wing and a batch of 3)
  and tet10_stress_nodal against tpufem's to 1e-12 of the largest entry;
- assemble_K10 and lumped_mass10 (scipy / numpy) equal tpufem's, and the
  80-bit residual tet10_residual_xprec agrees with tpufem's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.refsolve as jref
import tpufem.fem.tet10 as jt10
import tpufem.fem.xprec as jxp
import tpufem.mesher as jmesher
import tpufem.sets as jsets
import tpufem_torch.fem.refsolve as tref
import tpufem_torch.fem.tet10 as tt10
import tpufem_torch.fem.xprec as txp
import tpufem_torch.mesher as tmesher
from tpufem.fem.material import Material as JMaterial
from tpufem_torch.fem.material import Material, lame_params

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07], [1.5, 0.3, 5.0, 0.12]])
LAM, MU = lame_params(Material())
GRIDS = {"6x4x2 sharp TE": (6, 4, 2, 0.0), "8x6x2 floored": (8, 6, 2, 0.006)}


def _close(b, a, rtol):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=rtol * np.abs(a).max())


@pytest.fixture(scope="module", params=list(GRIDS))
def meshes(request):
    """(tpufem's Tet10Mesh, the port's, tpufem's boundary sets) of wing 0."""
    nc, ns, nt, te = GRIDS[request.param]
    ma = jmesher.structured_wing_mesh(*P4[0], jmesher.WingMeshResolution(nc, ns, nt, te, "le"))
    mb = tmesher.structured_wing_mesh(*P4[0], tmesher.WingMeshResolution(nc, ns, nt, te, "le"))
    return jt10.tet10_from_tet4(ma), tt10.tet10_from_tet4(mb), jsets.build_boundary_sets(ma)


def _operands(t10a, t10b):
    """tpufem's and the port's (nodes10, conn, Jinv, vols), f64."""
    na = jnp.asarray(t10a.nodes10(t10a.mesh4.nodes), jnp.float64)
    nb = torch.as_tensor(t10b.nodes10(t10b.mesh4.nodes), dtype=torch.float64)
    ca, cb = jnp.asarray(t10a.tet10), torch.as_tensor(t10b.tet10)
    return (na, ca, *jt10.tet10_setup(na, ca)), (nb, cb, *tt10.tet10_setup(nb, cb))


def test_dndxi_matches():
    np.testing.assert_array_equal(tt10.DNDXI, jt10.DNDXI)
    np.testing.assert_array_equal(tt10.GAUSS_POINTS, jt10.GAUSS_POINTS)
    assert tt10.GAUSS_WEIGHT == jt10.GAUSS_WEIGHT


def test_tet10_from_tet4_matches(meshes):
    a, b, _ = meshes
    for k in ("tet10", "edge_endpoints", "surf_t6", "station_id", "slot"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    assert (b.num_nodes, b.num_stations, b.slots_per_station) == (
        a.num_nodes, a.num_stations, a.slots_per_station)
    np.testing.assert_array_equal(b.nodes10(b.mesh4.nodes), a.nodes10(a.mesh4.nodes))
    np.testing.assert_array_equal(tt10.tet10_root_nodes(b), jt10.tet10_root_nodes(a))


def test_setup_and_force_match(meshes):
    a, b, _ = meshes
    (na, ca, Ja, va), (nb, cb, Jb, vb) = _operands(a, b)
    _close(Jb, Ja, 1e-12)
    _close(vb, va, 1e-12)
    u = np.random.default_rng(0).normal(size=(b.num_nodes, 3)) * 1e-3
    ya = jt10.tet10_force(Ja, va, ca, jnp.asarray(u), LAM, MU, a.num_nodes)
    yb = tt10.tet10_force(Jb, vb, cb, torch.as_tensor(u), LAM, MU, b.num_nodes)
    _close(yb, ya, 1e-12)
    free = np.ones(3 * b.num_nodes)
    free[(3 * tt10.tet10_root_nodes(b)[:, None] + np.arange(3)).reshape(-1)] = 0.0
    Aa = jt10.tet10_operator(Ja, va, ca, LAM, MU, a.num_nodes, jnp.asarray(free))
    Ab = tt10.tet10_operator(Jb, vb, cb, LAM, MU, b.num_nodes, torch.as_tensor(free))
    _close(Ab(torch.as_tensor(u.reshape(-1))), Aa(jnp.asarray(u.reshape(-1))), 1e-12)


def test_loads_and_stress_match(meshes):
    a, b, bs = meshes
    (na, ca, Ja, va), (nb, cb, Jb, vb) = _operands(a, b)
    ut6 = jt10.tet10_upper_t6(a, bs.surf_upper_faces)
    np.testing.assert_array_equal(tt10.tet10_upper_t6(b, bs.surf_upper_faces), ut6)
    fa = jt10.pressure_loads_t6(na, jnp.asarray(ut6), 5e3, a.num_nodes)
    fb = tt10.pressure_loads_t6(nb, ut6, 5e3, b.num_nodes)
    _close(fb, fa, 1e-12)
    # a batch of 3 wings (N,3,B) in one segment sum, as the stencil solver's loads
    res = tmesher.WingMeshResolution(*b.mesh4.meta["resolution"])
    nodes = np.stack([b.nodes10(tmesher.structured_wing_mesh(*p, res).nodes) for p in P4], 2)
    fbb = tt10.pressure_loads_t6(torch.as_tensor(nodes), ut6, 5e3, b.num_nodes)
    for k in range(len(P4)):
        fk = jt10.pressure_loads_t6(jnp.asarray(nodes[:, :, k]), jnp.asarray(ut6), 5e3,
                                    a.num_nodes)
        _close(fbb[:, :, k], fk, 1e-12)
    u = np.random.default_rng(1).normal(size=(b.num_nodes, 3)) * 1e-3
    sa = jt10.tet10_stress_nodal(Ja, va, ca, jnp.asarray(u), LAM, MU, a.num_nodes)
    sb = tt10.tet10_stress_nodal(Jb, vb, cb, torch.as_tensor(u), LAM, MU, b.num_nodes)
    _close(sb, sa, 1e-12)


def test_refsolve_and_xprec_match(meshes):
    a, b, bs = meshes
    (na, ca, Ja, va), (nb, cb, Jb, vb) = _operands(a, b)
    n10 = b.nodes10(b.mesh4.nodes)
    Ka = jref.assemble_K10(n10, a.tet10, JMaterial())
    Kb = tref.assemble_K10(n10, b.tet10, Material())
    assert abs(Kb - Ka).max() <= 1e-12 * abs(Ka).max()
    np.testing.assert_array_equal(tref.lumped_mass10(n10, b.tet10, 2700.0),
                                  jref.lumped_mass10(n10, a.tet10, 2700.0))
    free = np.ones((b.num_nodes, 3))
    free[tt10.tet10_root_nodes(b)] = 0.0
    ut6 = jt10.tet10_upper_t6(a, bs.surf_upper_faces)
    f = np.asarray(jt10.pressure_loads_t6(na, jnp.asarray(ut6), 5e3, a.num_nodes)) * free
    x = np.random.default_rng(2).normal(size=(b.num_nodes, 3)) * 1e-6
    ra = jxp.tet10_residual_xprec(np.asarray(Ja), np.asarray(va), a.tet10, f, x, free, LAM, MU)
    rb = txp.tet10_residual_xprec(Jb.numpy(), vb.numpy(), b.tet10, f, x, free, LAM, MU,
                                  elem_chunk=64)
    np.testing.assert_allclose(rb, ra, rtol=1e-12)
