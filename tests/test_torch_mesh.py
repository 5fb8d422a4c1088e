"""Port parity: mesher, boundary sets and the grid node map of tpufem_torch
against tpufem on the same resolutions and parameters.

Tolerances: integer topology and sets must be identical; coordinates agree to
1e-15 relative (the same numpy arithmetic on the host, and f64 torch vs f64
XLA for the batched grid map)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.stencil as jst
import tpufem.mesher as jmesher
import tpufem.sets as jsets
import tpufem_torch.fem.stencil as tst
import tpufem_torch.mesher as tmesher
import tpufem_torch.sets as tsets

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [2.0, 0.2, 30.0, 0.05], [1.5, 0.5, 0.0, 0.15]])
CASES = [(8, 6, 3, 0.006), (8, 6, 3, 0.0), (12, 10, 3, 0.006), (12, 10, 3, 0.0)]


def _res(mod, nc, ns, nt, te):
    return mod.WingMeshResolution(nc, ns, nt, te_floor_frac=te, spacing="le")


@pytest.mark.parametrize("nc,ns,nt,te", CASES)
def test_wing_topology_identical(nc, ns, nt, te):
    a = jmesher.wing_topology(_res(jmesher, nc, ns, nt, te))
    b = tmesher.wing_topology(_res(tmesher, nc, ns, nt, te))
    for f in ("tets", "surf_faces", "station_id", "slot"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    np.testing.assert_array_equal(b.node_basis, a.node_basis)
    assert (b.num_nodes, b.num_stations, b.slots_per_station, b.te_floor) == (
        a.num_nodes, a.num_stations, a.slots_per_station, a.te_floor)


@pytest.mark.parametrize("nc,ns,nt,te", CASES)
def test_mesh_and_boundary_sets_identical(nc, ns, nt, te):
    for p in P4:
        ma = jmesher.structured_wing_mesh(*p, res=_res(jmesher, nc, ns, nt, te))
        mb = tmesher.structured_wing_mesh(*p, res=_res(tmesher, nc, ns, nt, te))
        scale = np.abs(ma.nodes).max()
        np.testing.assert_allclose(mb.nodes, ma.nodes, rtol=0, atol=1e-15 * scale)
        np.testing.assert_array_equal(mb.tets, ma.tets)
        sa, sb = jsets.build_boundary_sets(ma), tsets.build_boundary_sets(mb)
        for f in ("nroot_nodes", "surf_all_faces", "surf_upper_faces"):
            np.testing.assert_array_equal(getattr(sb, f), getattr(sa, f), err_msg=f)
        assert sb.nz_min_used == sa.nz_min_used
        assert sb.upper_area_ratio == pytest.approx(sa.upper_area_ratio, rel=1e-15)


@pytest.mark.parametrize("nc,ns,nt,te", CASES)
def test_nodes_grid_and_grid_maps(nc, ns, nt, te):
    ra, rb = _res(jmesher, nc, ns, nt, te), _res(tmesher, nc, ns, nt, te)
    Xa = np.asarray(jst.nodes_grid(ra, jnp.asarray(P4), jnp.float64))
    Xb = tst.nodes_grid(rb, torch.as_tensor(P4), torch.float64).numpy()
    np.testing.assert_allclose(Xb, Xa, rtol=0, atol=1e-15 * np.abs(Xa).max())
    ma, mb = jst.grid_meta(ra), tst.grid_meta(rb)
    for k in ("NI", "NJ", "NK", "num_nodes", "weld_te"):
        assert mb[k] == ma[k]
    for k in ("gi", "gj", "gk"):
        np.testing.assert_array_equal(mb[k], ma[k])
    # grid gather/scatter maps round-trip and agree with tpufem's
    rng = np.random.default_rng(0)
    v = rng.normal(size=(ma["num_nodes"], 3, len(P4)))
    ga = np.asarray(jst.to_grid(ra, jnp.asarray(v)))
    gb = tst.to_grid(rb, torch.as_tensor(v))
    np.testing.assert_array_equal(gb.numpy(), ga)
    np.testing.assert_array_equal(tst.from_grid(rb, gb).numpy(), v)


SURFACES = [(1.2, 0.35, 0.0, 0.10), (1.5, 0.30, 20.0, 0.08), (2.0, 0.25, 30.0, 0.05)]


@pytest.mark.parametrize("span,chord,sweep,t", SURFACES)
def test_surface_predicates_identical(span, chord, sweep, t):
    """geometry.surface_signed_volume and surface_is_consistently_oriented
    against tpufem's on the lofts tests/test_geometry.py checks, and on the
    same surface with every face flipped (negative volume) or one face
    flipped (incoherent winding)."""
    import tpufem.geometry as jgeo
    import tpufem_torch.geometry as tgeo

    s = tgeo.generate_wing_surface(span, chord, sweep, t)
    js = jgeo.generate_wing_surface(span, chord, sweep, t)
    np.testing.assert_array_equal(s.faces, js.faces)
    flipped = tgeo.WingSurface(s.vertices, s.faces[:, [0, 2, 1]])
    one = s.faces.copy()
    one[0] = one[0, [0, 2, 1]]
    incoherent = tgeo.WingSurface(s.vertices, one)
    for surf in (s, flipped, incoherent):
        jsurf = jgeo.WingSurface(surf.vertices, surf.faces)
        assert tgeo.surface_signed_volume(surf) == jgeo.surface_signed_volume(jsurf)
        assert (tgeo.surface_is_consistently_oriented(surf)
                == jgeo.surface_is_consistently_oriented(jsurf))
    assert tgeo.surface_signed_volume(s) > 0 and tgeo.surface_is_consistently_oriented(s)
    assert tgeo.surface_signed_volume(flipped) == -tgeo.surface_signed_volume(s)
    assert tgeo.surface_is_consistently_oriented(flipped)
    assert not tgeo.surface_is_consistently_oriented(incoherent)
