"""Port parity: cell geometry, the strain-first operator and the line-offset
stencil assembly of tpufem_torch.fem.stencil against tpufem.fem.stencil, at the
setup of tests/test_stencil.py::test_stencil_apply_matches_gather_operator
(8x6x3, te_floor 0.006 and 0.0, two PRD wings, f64). Tolerance: 1e-12 of the
largest magnitude (f64; the two frameworks sum in different orders).

The CUDA kernel behind strain_apply is checked against the plain version in
the gpu-marked tests of tests/test_torch_kernels.py and in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.stencil as jst
import tpufem.mesher as jmesher
import tpufem_torch.fem.stencil as tst
import tpufem_torch.mesher as tmesher
from tpufem_torch.fem.material import Material, lame_params

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [2.0, 0.2, 30.0, 0.05]])
LAM, MU = lame_params(Material())
RTOL = 1e-12


def _close(b, a):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=RTOL * np.abs(a).max())


@pytest.fixture(params=[0.006, 0.0], ids=["te_floor", "sharp_te"])
def setup(request):
    te = request.param
    ra = jmesher.WingMeshResolution(8, 6, 3, te_floor_frac=te, spacing="le")
    rb = tmesher.WingMeshResolution(8, 6, 3, te_floor_frac=te, spacing="le")
    Xa = jst.nodes_grid(ra, jnp.asarray(P4), jnp.float64)
    Xb = tst.nodes_grid(rb, torch.as_tensor(P4), torch.float64)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(jst.grid_meta(ra)["num_nodes"], 3, len(P4)))
    ug = np.array(jst.to_grid(ra, jnp.asarray(u)))
    free = np.ones((1, 1, 1, 1, rb.n_span + 1))
    free[..., 0] = 0.0
    return ra, rb, Xa, Xb, ug, free


def test_cell_geometry_matches(setup):
    ra, rb, Xa, Xb, _, _ = setup
    ga, va = jst.cell_geometry(ra, Xa)
    gb, vb = tst.cell_geometry(rb, Xb)
    assert gb.shape == ga.shape and vb.shape == va.shape
    _close(gb, ga)
    _close(vb, va)
    # the relative degenerate-tet cut keeps the same tets on both sides
    np.testing.assert_array_equal(vb.numpy() == 0, np.asarray(va) == 0)


def test_strain_apply_matches(setup):
    ra, rb, Xa, Xb, ug, free = setup
    geo_a = jst.cell_geometry(ra, Xa)
    geo_b = tst.cell_geometry(rb, Xb)
    ya = jst.strain_apply(ra, geo_a, jnp.asarray(ug), jnp.asarray(free), LAM, MU)
    yb = tst.strain_apply(rb, geo_b, torch.as_tensor(ug), torch.as_tensor(free), LAM, MU)
    _close(yb, ya)


def test_strain_apply_cpu_takes_plain_version(setup):
    _, rb, _, Xb, ug, free = setup
    geo = tst.cell_geometry(rb, Xb)
    before = tst.strain_apply.launches
    u, f = torch.as_tensor(ug), torch.as_tensor(free)
    y = tst.strain_apply(rb, geo, u, f, LAM, MU)
    assert tst.strain_apply.launches == before  # no kernel launch on the CPU
    assert torch.equal(y, tst.strain_apply_plain(rb, geo, u, f, LAM, MU))


@pytest.mark.parametrize("bad", ["none", "free_shape", "free_dtype", "u_strided", "u_grid"])
def test_kernel_b_input_check(setup, bad):
    """What kernel B takes is checked before any launch: the root mask
    (1,1,1,1,NJ) of u's dtype, contiguous operands on res's grid. Holds on
    CPU tensors too, so it is tested here; the CUDA wrapper raises on the
    same inputs (tests/test_torch_kernels.py)."""
    _, rb, _, Xb, ug, free = setup
    geo = tst.cell_geometry(rb, Xb)
    u, f = torch.as_tensor(ug), torch.as_tensor(free)
    args = {"none": (u, f), "free_shape": (u, f.reshape(1, 1, 1, -1, 1)),
            "free_dtype": (u, f.float()), "u_strided": (u.transpose(2, 4).contiguous()
                                                        .transpose(2, 4), f),
            "u_grid": (u[:, :, :-1].contiguous(), f)}[bad]
    if bad == "none":
        tst.check_strain_apply_inputs(rb, geo, *args)
    else:
        with pytest.raises((ValueError, TypeError)):
            tst.check_strain_apply_inputs(rb, geo, *args)


def test_assemble_line_stencil_matches(setup):
    ra, rb, Xa, Xb, _, _ = setup
    offs = ((0, 0, -1), (0, 0, 0), (0, 0, 1))
    Ca = jst.assemble_stencil(ra, Xa, LAM, MU, offsets=offs)
    Cb = tst.assemble_stencil(rb, Xb, LAM, MU, offsets=offs)
    assert set(Cb) == set(Ca) == set(offs)
    for o in offs:
        _close(Cb[o], Ca[o])


def test_weld_spread_reduce_match(setup):
    ra, rb, _, _, ug, _ = setup
    rng = np.random.default_rng(1)
    y = rng.normal(size=ug.shape)
    np.testing.assert_array_equal(
        tst.weld_spread(rb, torch.as_tensor(y)).numpy(), np.asarray(jst.weld_spread(ra, jnp.asarray(y))))
    _close(tst.weld_reduce(rb, torch.as_tensor(y)), jst.weld_reduce(ra, jnp.asarray(y)))
