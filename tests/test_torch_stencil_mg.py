"""Port parity: the grid multigrid of tpufem_torch.fem.stencil_mg against
tpufem.fem.stencil_mg, in f64.

- line blocks before inversion: 1e-12 of the largest entry (same sums,
  different order);
- the port's inverses (Jacobi-scaled Cholesky) satisfy B Binv = I to 1e-10;
- one V-cycle on a fixed residual with tpufem's state (Binv, lmax, Kinv)
  converted and injected: 1e-10 of the largest entry. The V-cycle is linear
  in the residual once its state is fixed, so Newton-Schulz vs Cholesky does
  not enter this comparison;
- the port's own setup (lmax, coarsest inverse) against tpufem's: 1e-8, where
  the two block-inversion methods do enter;
- hierarchy_resolutions(res, n_levels) level for level, and StencilMG's
  constructor arguments as tpufem takes them (n_levels=2, smooth_degree=3,
  smooth_alpha=0.1): each package's own f32 setup and V-cycle, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.stencil as jst
import tpufem.fem.stencil_mg as jmg
import tpufem.mesher as jmesher
import tpufem_torch.fem.stencil as tst
import tpufem_torch.fem.stencil_mg as tmg
import tpufem_torch.mesher as tmesher
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import spd_block_inverse

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])
LAM, MU = lame_params(Material())
OFFS = ((0, 0, -1), (0, 0, 0), (0, 0, 1))


def _pair(nc, ns, nt, te):
    ra = jmesher.WingMeshResolution(nc, ns, nt, te_floor_frac=te, spacing="le")
    rb = tmesher.WingMeshResolution(nc, ns, nt, te_floor_frac=te, spacing="le")
    return ra, rb


def _close(b, a, rtol):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=rtol * np.abs(a).max())


@pytest.fixture(scope="module")
def mg():
    """tpufem's f64 StencilMG state at 8x12x4 (2 levels, thickness coarsened
    4 -> 2) and the port's StencilMG."""
    ra, rb = _pair(8, 12, 4, 0.006)
    ja = jmg.StencilMG(ra, dtype=jnp.float64)
    state_a = ja.setup(jnp.asarray(P4), LAM, MU)
    state_a = ja.finalize(state_a, P4, LAM, MU)
    tb = tmg.StencilMG(rb, dtype=torch.float64, device="cpu")
    return ra, rb, ja, state_a, tb


def test_hierarchy_and_chord_weights_match():
    ra, rb = _pair(64, 80, 6, 0.006)
    assert [r.key for r in tmg.hierarchy_resolutions(rb)] == [
        r.key for r in jmg.hierarchy_resolutions(ra)]
    for la, lb in zip(jmg.hierarchy_resolutions(ra)[:-1], tmg.hierarchy_resolutions(rb)[:-1]):
        for wa, wb in zip(jmg._chord_weights(la, jnp.float64),
                          tmg._chord_weights(lb, torch.float64, "cpu")):
            np.testing.assert_array_equal(wb.numpy(), np.asarray(wa))


@pytest.mark.parametrize("te", [0.006, 0.0], ids=["te_floor", "sharp_te"])
def test_line_blocks_before_inversion_match(te, monkeypatch):
    ra, rb = _pair(12, 10, 3, te)
    ja = jmg.StencilMG(ra, dtype=jnp.float64)
    tb = tmg.StencilMG(rb, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(jmg, "spd_block_inverse", lambda b: b)  # tpufem's blocks, uninverted
    Xa = jst.nodes_grid(ra, jnp.asarray(P4), jnp.float64)
    Xb = tst.nodes_grid(rb, torch.as_tensor(P4), torch.float64)
    Ba = ja._line_blocks(0, jst.assemble_stencil(ra, Xa, LAM, MU, offsets=OFFS))
    Bb = tb._line_matrices(0, tst.assemble_stencil(rb, Xb, LAM, MU, offsets=OFFS))
    _close(Bb.permute(0, 1, 3, 4, 2), Ba, 1e-12)  # port (NI,NJ,B,D,D) -> (NI,NJ,D,D,B)


@pytest.mark.parametrize("te", [0.006, 0.0], ids=["te_floor", "sharp_te"])
def test_line_block_inverses(te):
    _, rb = _pair(12, 10, 3, te)
    tb = tmg.StencilMG(rb, dtype=torch.float64, device="cpu")
    Xb = tst.nodes_grid(rb, torch.as_tensor(P4), torch.float64)
    C = tst.assemble_stencil(rb, Xb, LAM, MU, offsets=OFFS)
    Bm = tb._line_matrices(0, C)
    Binv = tb._line_blocks(0, C)
    eye = torch.eye(Bm.shape[-1], dtype=torch.float64)
    err = (Bm @ Binv - eye).abs().max().item()
    assert err <= 1e-10, err


def test_spd_block_inverse_raises_on_indefinite():
    B = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    B[1, 0, 1] = B[1, 1, 0] = 2.0  # eigenvalues 3, -1, 1
    with pytest.raises(RuntimeError, match="not positive definite"):
        spd_block_inverse(B)


def _port_state_from(state_a):
    """tpufem's per-level MG state as the port's tensors and layouts."""
    out = []
    for st in state_a:
        g, v = st["geo"]
        s = {"lam": LAM, "mu": MU,
             "geo": (torch.as_tensor(np.array(g)), torch.as_tensor(np.array(v)))}
        if "Binv" in st:
            s["Binv"] = torch.as_tensor(np.array(st["Binv"])).permute(0, 1, 4, 2, 3)
            s["lmax"] = torch.as_tensor(np.array(st["lmax"]))
        if "Kinv" in st:
            s["Kinv"] = torch.as_tensor(np.array(st["Kinv"]))
        out.append(s)
    return out


def test_vcycle_matches_with_injected_state(mg):
    ra, rb, ja, state_a, tb = mg
    assert tb.n_levels == ja.n_levels == 2
    rng = np.random.default_rng(3)
    r_nodes = rng.normal(size=(jst.grid_meta(ra)["num_nodes"], 3, len(P4)))
    rg = np.array(jst.to_grid(ra, jnp.asarray(r_nodes))) * np.asarray(ja.free_masks[0])
    za = ja.apply(state_a, jnp.asarray(rg))
    zb = tb.apply(_port_state_from(state_a), torch.as_tensor(rg))
    _close(zb, za, 1e-10)


def test_setup_matches(mg):
    _, _, ja, state_a, tb = mg
    state_b = tb.setup(P4, LAM, MU)
    for li in range(tb.n_levels - 1):
        _close(state_b[li]["lmax"], state_a[li]["lmax"], 1e-8)
    _close(state_b[-1]["Kinv"], state_a[-1]["Kinv"], 1e-12)


@pytest.mark.parametrize("n_levels", [None, 1, 2, 3])
def test_hierarchy_n_levels_matches(n_levels):
    ra, rb = _pair(16, 24, 4, 0.006)
    assert [r.key for r in tmg.hierarchy_resolutions(rb, n_levels)] == [
        r.key for r in jmg.hierarchy_resolutions(ra, n_levels)]


def test_vcycle_options_match_tpufem_in_f32():
    """StencilMG's constructor arguments as tpufem takes them: at n_levels=2,
    smooth_degree=3, smooth_alpha=0.1, each package's own f32 setup and one
    V-cycle on the same residual agree to 1e-5 of the largest entry (f32
    setups: power iterations and block inverses in another order; measured
    3.7e-7)."""
    ra, rb = _pair(16, 24, 4, 0.006)
    kw = {"n_levels": 2, "smooth_degree": 3, "smooth_alpha": 0.1}
    ja = jmg.StencilMG(ra, dtype=jnp.float32, **kw)
    tb = tmg.StencilMG(rb, dtype=torch.float32, device="cpu", **kw)
    assert (tb.n_levels, tb.smooth_degree, tb.smooth_alpha, tb.power_iters, tb.lmax_safety) == (
        2, 3, 0.1, 10, 1.2)
    p32 = P4.astype(np.float32)
    lam32, mu32 = float(np.float32(LAM)), float(np.float32(MU))
    state_a = ja.finalize(ja.setup(jnp.asarray(p32), jnp.float32(lam32), jnp.float32(mu32)),
                          p32, lam32, mu32)
    state_b = tb.setup(p32, lam32, mu32)
    rng = np.random.default_rng(4)
    r_nodes = rng.normal(size=(jst.grid_meta(ra)["num_nodes"], 3, len(P4)))
    rg = (np.array(jst.to_grid(ra, jnp.asarray(r_nodes))) * np.asarray(ja.free_masks[0])
          ).astype(np.float32)
    za = ja.apply(state_a, jnp.asarray(rg))
    zb = tb.apply(state_b, torch.as_tensor(rg))
    _close(zb, za, 1e-5)
