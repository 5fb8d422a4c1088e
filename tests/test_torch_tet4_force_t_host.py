"""Kernel O (csrc/tet4_force_t.cu, the trailing-batch tet4 operator) on the
CPU, without nvcc: the CUDA source compiled with g++ against
tests/cuda_emulation/cuda_runtime.h (each block's threads as std::threads,
the blocks in a shuffled order, shared memory NaN before each block), held
to stiffness_apply_t_plain on COARSE (sharp TE, cosine spacing) and 16x16x4
(LE spacing, TE floor) wings, B = 1, 3 and 8 lanes, f64 and f32, masked and
unmasked:

- within 1e-12 (f64) / 1e-5 (f32) of the largest entry of the plain
  version, the same bits on a second call;
- at the plan incidence_t cuts for the lanes and dtype, and at a cut of
  ODD_CUT rows a block (64 on COARSE, 256 on 16x16x4), where most tets sit
  on a block boundary: the same bits, each lane's node sums run in
  ascending t*4+a from zero however the nodes are cut;
- the Dirichlet rows are x itself; a plan whose blocks overflow a block's
  shared memory at the lane count is refused by the wrapper's check.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_tet10_force_host import emulate
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.multigrid import grads_vols_t, nodes_t
from tpufem_torch.mesher import COARSE, WingMeshResolution, wing_topology

LAM, MU = lame_params(Material())
GRIDS = {"COARSE": COARSE, "16x16x4": WingMeshResolution(16, 16, 4, 0.006, "le")}
ODD_CUT = {"COARSE": 64, "16x16x4": 256}  # rows a block: many blocks, few enough to emulate
DTYPES = {"f64": (torch.float64, 1e-12), "f32": (torch.float32, 1e-5)}
O_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
PRD = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07], [1.0, 0.20, 0.0, 0.15],
                [1.5, 0.30, 5.0, 0.12], [2.0, 0.40, 30.0, 0.06], [1.1, 0.22, 15.0, 0.09],
                [1.7, 0.33, 20.0, 0.11], [1.3, 0.28, 2.0, 0.08]])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """Kernel O's source under the emulation, as a ctypes library."""
    return emulate(tmp_path_factory.mktemp("cuda_emulation_o"), "tet4_force_t.cu",
                   "tpufem_stiffness_apply_t", O_ARGS, 1)


@pytest.fixture(scope="module")
def wings():
    """{grid: (tets int32, grads64 (T,4,3,8), vols64 (T,8), x64 (N,3,8), free64 (N,3))}."""
    torch.set_num_threads(1)
    out = {}
    for i, (name, res) in enumerate(GRIDS.items()):
        topo = wing_topology(res)
        basis = torch.as_tensor(topo.node_basis)
        tets = torch.as_tensor(topo.tets.astype(np.int32))
        nodes = nodes_t(basis, topo.te_floor, torch.as_tensor(PRD), torch.float64)
        grads, vols = grads_vols_t(nodes, tets.long())
        x = torch.as_tensor(np.random.default_rng(i).normal(size=(topo.num_nodes, 3, 8)) * 1e-3)
        free = torch.ones((topo.num_nodes, 3), dtype=torch.float64)
        free[topo.station_id % (res.n_span + 1) == 0] = 0.0
        out[name] = (tets, grads, vols, x, free)
    return out


def emulated(lib, grads, vols, tets, x, free, plan):
    """y of one emulated launch of kernel O."""
    asm.check_stiffness_apply_t_inputs(grads, vols, tets, x, plan, free)
    y = torch.full_like(x, float("nan"))
    fn = getattr(lib, "tpufem_stiffness_apply_t_" + ("f64" if x.dtype == torch.float64
                                                      else "f32"))
    assert fn(grads.data_ptr(), vols.data_ptr(), tets.data_ptr(), plan.pos.data_ptr(),
              plan.btet.data_ptr(), plan.bt_start.data_ptr(), plan.bnode.data_ptr(),
              plan.starts.data_ptr(), x.data_ptr(), None if free is None else free.data_ptr(),
              y.data_ptr(), plan.bnode.shape[0] - 1, plan.slots, x.shape[-1], LAM, MU,
              None) == 0
    return y


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_o_matches_plain(lib, wings, grid, lanes, dtype):
    td, tol = DTYPES[dtype]
    tets, g64, v64, x64, f64 = wings[grid]
    g, v = g64[..., :lanes].to(td).contiguous(), v64[:, :lanes].to(td).contiguous()
    x, fr = x64[..., :lanes].to(td).contiguous(), f64.to(td)
    N = x.shape[0]
    plans = [asm.incidence_t(tets, N, lanes, td),
             asm.build_incidence(tets, N, slots=ODD_CUT[grid], slot_limit=ODD_CUT[grid])]
    assert plans[0].slots * 3 * lanes * x.element_size() <= asm.O_SMEM
    for free in (fr, None):
        ref = asm.stiffness_apply_t_plain(g, v, tets, x, LAM, MU, plans[0], free)
        scale = ref.abs().max().item()
        outs = [emulated(lib, g, v, tets, x, free, p) for p in (plans[0], *plans)]
        assert (outs[0] - ref).abs().max().item() <= tol * scale
        for y in outs[1:]:
            assert torch.equal(y, outs[0])
        if free is not None:
            fixed = fr[:, :, None].expand_as(x) == 0
            assert torch.equal(outs[0][fixed], x[fixed])


def test_kernel_o_refuses_an_overfull_plan(wings):
    tets, g64, v64, x64, f64 = wings["COARSE"]
    plan = asm.incidence_t(tets, x64.shape[0], 1, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        asm.check_stiffness_apply_t_inputs(g64, v64, tets, x64, plan, f64)
    with pytest.raises(ValueError, match="incident tets"):
        asm.incidence_t(tets, x64.shape[0], 10**4, torch.float64)
