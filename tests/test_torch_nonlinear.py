"""Port parity: the TL-StVK grid functions of tpufem_torch.fem.nonlinear (the
plain versions kernels H, I and J are held to on the card) against
tpufem.fem.nonlinear, on the CPU at tpufem's test grid 8x10x2 (LE spacing, TE
floor) and its sharp-TE variant, on the same seeded inputs; the force, the
tangent and the energy also at the edges of kernels H's and I's tiles
(EDGE_GRIDS).

- stvk_internal_force and the tangent (tpufem's jax.jvp against the port's
  torch.func.jvp) within 1e-12 of the largest entry; the energy within 1e-13
  relative; stvk_cauchy_stress within 1e-12;
- the port's own copies of tpufem's consistency tests: the energy gradient
  is the force on free rows, the tangent is symmetric and matches central
  differences, the force reduces to strain_apply_plain at small u, the
  Cauchy stress to the linear element stress, and the tangent at u = 0 is
  strain_apply_plain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.nonlinear as jnl
import tpufem.fem.stencil as jst
from tpufem.fem.material import Material as JMaterial
from tpufem.fem.material import lame_params as jlame
from tpufem.mesher import WingMeshResolution as JRes
from tpufem_torch.fem import buckling as tbk
from tpufem_torch.fem import nonlinear as tnl
from tpufem_torch.fem import stencil as tst
from tpufem_torch.mesher import WingMeshResolution

PARAMS = (1.2, 0.35, 10.0, 0.10)
# (n_chord, n_span, n_thick, te_floor_frac): tpufem's test grid 8x10x2 and its
# sharp-TE variant; EDGE_GRIDS are the edges of kernels H's and I's tiles on
# the card (node counts that fill no tile evenly, a welded TE, nt = 2), where
# the plain versions those kernels are held to are held to tpufem here
GRIDS = {"le": (8, 10, 2, 0.006), "sharp-te": (8, 10, 2, 0.0)}
EDGE_GRIDS = {"13x37x2-sharp-te": (13, 37, 2, 0.0), "13x37x5-sharp-te": (13, 37, 5, 0.0),
              "12x10x3-le": (12, 10, 3, 0.006), "64x24x2-sharp-te": (64, 24, 2, 0.0),
              "64x80x6-sharp-te": (64, 80, 6, 0.0)}
LAM, MU = jlame(JMaterial())


@pytest.fixture(scope="module", params=list(GRIDS))
def grid(request):
    """(port res, tpufem res, port geo, tpufem geo, root mask free (1,1,1,1,NJ))."""
    nc, ns, nt, te = {**GRIDS, **EDGE_GRIDS}[request.param]
    res, jres = WingMeshResolution(nc, ns, nt, te, "le"), JRes(nc, ns, nt, te, "le")
    p4 = np.asarray(PARAMS, np.float64)[None]
    geo = tst.cell_geometry(res, tst.nodes_grid(res, torch.as_tensor(p4), torch.float64))
    jgeo = jst.cell_geometry(jres, jst.nodes_grid(jres, jnp.asarray(p4), jnp.float64))
    free = np.ones((1, 1, 1, 1, res.n_span + 1))
    free[..., 0] = 0.0
    return res, jres, geo, jgeo, free


def _field(res, free, seed, scale):
    """A seeded random grid field (3,1,NI,NK,NJ), zero on the root rows."""
    shape = (3, 1, res.n_chord + 1, res.n_thick + 1, res.n_span + 1)
    return np.random.default_rng(seed).standard_normal(shape) * scale * free


def _port(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _close(got, ref, bar):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= bar * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("grid", [*GRIDS, *EDGE_GRIDS], indirect=True)
@pytest.mark.parametrize("scale", [1e-7, 1e-3])
def test_internal_force_matches_tpufem(grid, scale):
    res, jres, geo, jgeo, free = grid
    u = _field(res, free, 1, scale)
    ref = jnl.stvk_internal_force(jres, jgeo, jnp.asarray(u), jnp.asarray(free), LAM, MU)
    got = tnl.stvk_internal_force(res, geo, *_port(u, free), LAM, MU)
    _close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("grid", [*GRIDS, *EDGE_GRIDS], indirect=True)
def test_tangent_matches_tpufem_jvp(grid):
    res, jres, geo, jgeo, free = grid
    u, x = _field(res, free, 2, 1e-3), _field(res, free, 3, 1.0)

    def fint(v):
        return jnl.stvk_internal_force(jres, jgeo, v, jnp.asarray(free), LAM, MU)

    ref = jax.jvp(fint, (jnp.asarray(u),), (jnp.asarray(x),))[1]
    got = tnl.stvk_tangent_apply(res, geo, *_port(u, x, free), LAM, MU)
    _close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("grid", [*GRIDS, *EDGE_GRIDS], indirect=True)
def test_energy_matches_tpufem(grid):
    res, jres, geo, jgeo, free = grid
    u = _field(res, free, 4, 1e-3)
    ref = float(jnl.stvk_energy(jres, jgeo, jnp.asarray(u), jnp.asarray(free), LAM, MU))
    got = tnl.stvk_energy(res, geo, *_port(u, free), LAM, MU)
    assert got.dim() == 0
    assert abs(float(got) - ref) <= 1e-13 * abs(ref)


def test_cauchy_stress_matches_tpufem(grid):
    res, jres, geo, jgeo, free = grid
    u = _field(res, free, 5, 1e-3)
    ref = jnl.stvk_cauchy_stress(jres, jgeo, jnp.asarray(u), jnp.asarray(free), LAM, MU)
    got = tnl.stvk_cauchy_stress(res, geo, *_port(u, free), LAM, MU)
    _close(got.numpy(), ref, 1e-12)


def test_internal_force_is_energy_gradient(grid):
    """f_int == grad_u W on free rows: the hyperelastic consistency that
    makes the tangent symmetric."""
    res, _, geo, _, free = grid
    u, fr = _port(_field(res, free, 6, 1e-2), free)
    u.requires_grad_()
    (gW,) = torch.autograd.grad(tnl.stvk_energy(res, geo, u, fr, LAM, MU), u)
    f = tnl.stvk_internal_force(res, geo, u.detach(), fr, LAM, MU)
    diff = ((f - gW) * fr).norm()
    assert float(diff) <= 1e-10 * max(float((f * fr).norm()), 1.0)


def test_tangent_symmetry_and_fd(grid):
    """<v, K_T w> == <w, K_T v>, and the tangent matches a central finite
    difference of the force."""
    res, _, geo, _, free = grid
    u, v, w, fr = _port(_field(res, free, 7, 1e-2), _field(res, free, 8, 1.0),
                        _field(res, free, 9, 1.0), free)
    Kv = tnl.stvk_tangent_apply(res, geo, u, v, fr, LAM, MU)
    Kw = tnl.stvk_tangent_apply(res, geo, u, w, fr, LAM, MU)
    a, b = float((w * Kv).sum()), float((v * Kw).sum())
    assert abs(a - b) <= 1e-9 * max(abs(a), 1.0)
    h = 1e-6
    fd = (tnl.stvk_internal_force(res, geo, u + h * v, fr, LAM, MU)
          - tnl.stvk_internal_force(res, geo, u - h * v, fr, LAM, MU)) / (2 * h)
    assert float((Kv - fd).norm() / fd.norm()) < 1e-6


def test_small_load_reduces_to_linear(grid):
    """f_int(u) -> K u as |u| -> 0: the relative remainder is O(|u|)."""
    res, _, geo, _, free = grid
    u, fr = _port(_field(res, free, 10, 1.0), free)
    errs = []
    for eps in (1e-6, 1e-7):
        f_nl = tnl.stvk_internal_force(res, geo, u * eps, fr, LAM, MU)
        f_lin = tst.strain_apply_plain(res, geo, u * eps, fr, LAM, MU)
        errs.append(float((f_nl - f_lin).norm() / f_lin.norm()))
    assert errs[0] < 1e-2
    assert errs[1] < 0.15 * errs[0]


def test_tangent_at_zero_is_the_linear_operator(grid):
    """K_T(0) x == strain_apply(x) to rounding: what kernel I must give at u = 0."""
    res, _, geo, _, free = grid
    x, fr = _port(_field(res, free, 11, 1.0), free)
    got = tnl.stvk_tangent_apply(res, geo, torch.zeros_like(x), x, fr, LAM, MU)
    _close(got.numpy(), tst.strain_apply_plain(res, geo, x, fr, LAM, MU).numpy(), 1e-13)


def test_cauchy_reduces_to_linear_stress(grid):
    """sigma(u) -> the linear element stress as |u| -> 0."""
    res, _, geo, _, free = grid
    u, fr = _port(_field(res, free, 12, 1e-7), free)
    sig_nl = tnl.stvk_cauchy_stress(res, geo, u, fr, LAM, MU)
    sig_lin = tbk.element_stress_plain(res, geo, u, LAM, MU)
    assert float((sig_nl - sig_lin).norm() / sig_lin.norm()) < 1e-3
