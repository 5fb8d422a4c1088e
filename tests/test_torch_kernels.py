"""The CUDA kernels of tpufem_torch against their plain PyTorch versions, on
the card. Every test here is marked gpu and skips without CUDA.

This file imports neither jax nor tpufem, so it also runs on a machine
without them; there run it without the JAX conftest:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tpufem_torch.fem import stencil as tst
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.ops import gather_scatter as tgs

pytestmark = pytest.mark.gpu
LAM, MU = lame_params(Material())
P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("C", [128, 1])
def test_segment_sum_kernel_matches_plain(cuda, C):
    rng = np.random.default_rng(0)
    E, N = 5000, 700
    seg = np.sort(np.concatenate([rng.integers(0, N, size=E - 40), np.full(40, N)]))
    msgs = torch.as_tensor(rng.normal(size=(E, C)).astype(np.float32), device=cuda)
    seg = torch.as_tensor(seg.astype(np.int32), device=cuda)
    before = tgs.sorted_segment_sum.launches
    out = tgs.sorted_segment_sum(msgs, seg, N)
    out2 = tgs.sorted_segment_sum(msgs, seg, N)
    torch.cuda.synchronize()
    assert tgs.sorted_segment_sum.launches == before + 2
    assert torch.equal(out, out2)  # no atomics: the same bits every run
    ref = tgs.sorted_segment_sum_plain(msgs.double(), seg, N)
    err = (out.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def test_segment_gather_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    E, N, C = 5000, 700, 128
    seg = np.sort(np.concatenate([rng.integers(0, N, size=E - 40), np.full(40, N)]))
    g = torch.as_tensor(rng.normal(size=(N, C)).astype(np.float32), device=cuda)
    seg = torch.as_tensor(seg.astype(np.int32), device=cuda)
    before = tgs.segment_gather.launches
    out = tgs.segment_gather(g, seg, N)
    out2 = tgs.segment_gather(g, seg, N)
    torch.cuda.synchronize()
    assert tgs.segment_gather.launches == before + 2
    assert torch.equal(out, out2)
    # a copy: bitwise equal to the plain version; dump rows are zero
    assert torch.equal(out, tgs.segment_gather_plain(g, seg, N))
    assert out[-40:].abs().max().item() == 0.0


def test_sorted_segment_sum_gradients_on_cuda_match_cpu(cuda):
    """The segment sum on a CUDA tensor is differentiable (kernel C), and the
    gradients of the mean aggregation equal the CPU plain path's."""
    rng = np.random.default_rng(2)
    N, E, C = 300, 2000, 32
    h = rng.normal(size=(N, C)).astype(np.float32)
    ei = rng.integers(0, N, size=(2, E)).astype(np.int32)
    em = (rng.uniform(size=E) > 0.2).astype(np.float32)
    w = rng.normal(size=(N, C)).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        ht = torch.tensor(h, device=dev, requires_grad=True)
        out = tgs.gather_mean_aggregate(ht, torch.as_tensor(ei, device=dev),
                                        torch.as_tensor(em, device=dev), N)
        assert out.grad_fn is not None
        (out * torch.as_tensor(w, device=dev)).sum().backward()
        grads.append(ht.grad.cpu())
    before = tgs.segment_gather.launches
    msgs = torch.ones((4, 2), device=cuda, requires_grad=True)
    seg = torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=cuda)
    tgs.sorted_segment_sum(msgs, seg, 2).sum().backward()
    assert tgs.segment_gather.launches == before + 1
    assert msgs.grad.cpu().tolist() == [[1, 1], [1, 1], [1, 1], [0, 0]]
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * grads[1].abs().max().item()


def test_segment_sum_kernel_rejects_bad_input(cuda):
    msgs = torch.zeros((4, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tgs.sorted_segment_sum(msgs, torch.zeros(4, dtype=torch.int32, device=cuda), 3)


@pytest.mark.parametrize("te", [0.006, 0.0])
def test_strain_apply_kernel_matches_plain(cuda, te):
    res = WingMeshResolution(12, 10, 3, te_floor_frac=te, spacing="le")
    X = tst.nodes_grid(res, torch.as_tensor(P4, device=cuda), torch.float64)
    geo = tst.cell_geometry(res, X)
    gen = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn(X.shape, generator=gen, dtype=torch.float64, device=cuda)
    free = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=torch.float64, device=cuda)
    free[..., 0] = 0.0
    before = tst.strain_apply.launches
    y = tst.strain_apply(res, geo, u, free, LAM, MU)
    ref = tst.strain_apply_plain(res, geo, u, free, LAM, MU)
    assert tst.strain_apply.launches == before + 1
    scale = ref.abs().max().item()
    assert (y - ref).abs().max().item() <= 1e-12 * scale
    assert torch.equal(y, tst.strain_apply(res, geo, u, free, LAM, MU))
    # f32: the kernel's error against the f64 result is no worse than 2x the
    # plain f32 version's
    geo32 = tuple(t.float() for t in geo)
    y32 = tst.strain_apply(res, geo32, u.float(), free.float(), LAM, MU)
    p32 = tst.strain_apply_plain(res, geo32, u.float(), free.float(), LAM, MU)
    e_k = (y32.double() - ref).abs().max().item()
    e_p = (p32.double() - ref).abs().max().item()
    assert e_k <= 2.0 * e_p, (e_k, e_p)


def test_solve_on_cuda_matches_cpu(cuda):
    res = WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le")
    out_c = WingStencilT(res, device=cuda).solve(P4, tol=1e-8, maxiter=2000)
    out_h = WingStencilT(res).solve(P4, tol=1e-8, maxiter=2000)
    assert bool(out_c.converged.all()) and bool(out_h.converged.all())
    u_c, u_h = out_c.u.cpu(), out_h.u
    assert (u_c - u_h).abs().max().item() <= 1e-7 * u_h.abs().max().item()
