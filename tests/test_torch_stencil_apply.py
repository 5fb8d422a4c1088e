"""stencil.root_mask / stencil_apply (the assembled-stencil SpMV, tpufem's
cross-check of strain_apply) against tpufem's and against the port's own
operators, on the CPU in f64, at 8x6x3 with a TE floor and with a sharp
(welded) TE, two wings — tpufem's check (tests/test_stencil.py:14-52):

- root_mask equals tpufem's;
- stencil_apply on the same coefficients and u equals tpufem's to 1e-12 of
  the largest entry;
- it equals the port's strain_apply (kernel B's plain version) and the
  trailing-batch gather operator (kernel O's plain version) on the same
  system to 1e-9 of the largest entry, tpufem's bar; the grid round trip is
  the identity on active vectors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem import stencil as jst
from tpufem.mesher import WingMeshResolution as JRes
from tpufem_torch.fem import stencil as st
from tpufem_torch.fem.batched_t import WingBatchT
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import WingMeshResolution

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [2.0, 0.2, 30.0, 0.05]])
LAM, MU = lame_params(Material())


@pytest.mark.parametrize("te_floor", [0.006, 0.0])
def test_stencil_apply_matches(te_floor):
    res = WingMeshResolution(8, 6, 3, te_floor_frac=te_floor, spacing="le")
    jres = JRes(8, 6, 3, te_floor_frac=te_floor, spacing="le")
    bt = WingBatchT(res, dtype=torch.float64, device="cpu")
    p4 = torch.as_tensor(P4)
    nodes = bt._nodes(p4)
    grads, vols = bt._grads_vols(nodes)
    u = torch.as_tensor(np.random.default_rng(0).normal(size=(bt.num_nodes, 3, 2)))
    y_gather = bt._apply_A(grads, vols, u, LAM, MU)

    X = st.nodes_grid(res, p4, torch.float64)
    C = st.assemble_stencil(res, X, LAM, MU)
    free = st.root_mask(X.shape, torch.float64)
    jfree = jst.root_mask(X.shape, jnp.float64)
    np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
    ug = st.to_grid(res, u)
    yg = st.stencil_apply(res, C, ug, free)
    scale = y_gather.abs().max().item()

    # tpufem's stencil_apply on the same coefficients and u
    jC = {k: jnp.asarray(v.numpy()) for k, v in C.items()}
    jy = np.asarray(jst.stencil_apply(jres, jC, jnp.asarray(ug.numpy()), jfree))
    assert np.abs(yg.numpy() - jy).max() <= 1e-12 * np.abs(jy).max()

    y = st.from_grid(res, yg)
    assert (y - y_gather).abs().max().item() <= 1e-9 * scale
    y_strain = st.strain_apply(res, st.cell_geometry(res, X), ug, free, LAM, MU)
    assert (yg - y_strain).abs().max().item() <= 1e-9 * scale
    assert torch.equal(st.from_grid(res, ug), u)
