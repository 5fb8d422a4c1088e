"""Matrix-free stiffness operator and Jacobi diagonal — port of
``tpufem/fem/assembly.py``.

y = K u is computed per element and summed per node over the tets' incidence
plan; no global sparse matrix is ever materialized. On the card one operator
apply is one launch of kernel D (``csrc/tet4_force.cu``, ``stiffness_apply``):
Dirichlet mask, element forces, the per-node sum in the plan's fixed order
and the Dirichlet identity, with the element forces never written to device
memory. On a CPU tensor it is the plain composition: the mask,
``tet4_element_force_plain``, ``csr_segment_sum_plain``, the identity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.ops.csr_segment_sum import (
    CsrPlan,
    csr_arrays,
    csr_segment_sum,
    csr_segment_sum_plain,
)
from tpufem_torch.ops.kernels import check, load_kernels, wants_grad


SLOTS = 1536  # incident entries per block of kernel D (36 KB of f64 forces)
SLOT_LIMIT = 2048  # what a block's 48 KB of shared memory hold in f64: the highest valence taken


class IncidencePlan(NamedTuple):
    """The per-node sum plan of the (tet*4 + corner) force rows: the CSR plan
    of tets.reshape(-1) (the first four fields are a CsrPlan's, and
    csr_segment_sum reads a plan by those names, so it takes this one too)
    and kernel D's cut of the nodes into blocks."""

    order: torch.Tensor  # (4T,) int32: stable argsort of tets.reshape(-1)
    starts: torch.Tensor  # (N+1,) int32: node n's rows are order[starts[n]:starts[n+1]]
    seg: torch.Tensor  # (4T,) int64: the node of each row of `order`
    num_segments: int
    pos: torch.Tensor  # (4T,) int32: the CSR row of entry t*4+a (the inverse of `order`)
    bnode: torch.Tensor  # (n_blocks+1,) int32: block b owns the nodes bnode[b]:bnode[b+1]
    bt_start: torch.Tensor  # (n_blocks+1,) int32: block b's tets are btet[bt_start[b]:...[b+1]]
    btet: torch.Tensor  # int32: per block, ascending, the tets with a corner in its range
    slots: int  # no block's nodes hold more rows than this
    overlap: float  # len(btet) / T: how often a tet is evaluated (1 to 4)


def build_incidence(tets, num_nodes: int, device="cpu") -> IncidencePlan:
    """The incidence plan of `tets` (T,4) over `num_nodes` nodes, built on
    the host once per topology.

    tpufem stored the same stable argsort as a dense (N, V) padded gather
    table, because XLA:TPU's scatter serialized on duplicate indices
    (assembly.py:20-25). The port keeps it as CSR, walked row by row in a
    fixed order: no padding, no atomics. For kernel D the nodes are cut
    greedily into contiguous ranges of at most SLOTS rows (a node of higher
    valence gets a block of its own, up to SLOT_LIMIT rows, what a block's
    shared memory holds; beyond that it raises), and each range lists the
    tets that touch it.
    """
    if isinstance(tets, torch.Tensor):
        tets = tets.cpu().numpy()
    tets = np.asarray(tets).reshape(-1, 4)
    order, starts, flat = csr_arrays(tets, num_nodes)
    slots = max(SLOTS, int(np.diff(starts).max(initial=0)))
    if slots > SLOT_LIMIT:
        raise ValueError(f"a node with {slots} incident tets: kernel D's blocks hold at most "
                         f"{SLOT_LIMIT}")
    pos = np.empty(len(order), np.int32)
    pos[order] = np.arange(len(order), dtype=np.int32)
    bnode = [0]
    while bnode[-1] < num_nodes:  # the last node whose rows still fit; always at least one
        bnode.append(int(np.searchsorted(starts, starts[bnode[-1]] + slots, side="right")) - 1)
    bnode = np.asarray(bnode, np.int64)
    n_blocks = len(bnode) - 1
    # every (block, tet) pair once: the distinct blocks of each tet's corners, then
    # block-major with the tets of a block ascending (a stable sort by block)
    blocks = np.sort(np.repeat(np.arange(n_blocks), np.diff(bnode))[flat].reshape(-1, 4), axis=1)
    first = np.ones(blocks.shape, bool)
    first[:, 1:] = blocks[:, 1:] != blocks[:, :-1]
    pair_tet, pair_block = np.nonzero(first)[0], blocks[first]
    by_block = np.argsort(pair_block.astype(np.uint16 if n_blocks <= 2**16 else np.int64),
                          kind="stable")  # 16-bit keys: numpy's radix sort
    bt_start = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(np.bincount(pair_block, minlength=n_blocks), out=bt_start[1:])

    def to_dev(a, dtype=np.int32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return IncidencePlan(order=to_dev(order), starts=to_dev(starts),
                         seg=to_dev(flat[order], np.int64), num_segments=int(num_nodes),
                         pos=to_dev(pos), bnode=to_dev(bnode), bt_start=to_dev(bt_start),
                         btet=to_dev(pair_tet[by_block]), slots=slots,
                         overlap=len(pair_tet) / max(len(tets), 1))


def tet4_element_force_plain(grads, vols, tets, u_nodes, lam, mu) -> torch.Tensor:
    """The per-tet half of kernel D's plain version: fe (T*4, 3) =
    vol * sigma . g_a per corner, sigma = 2 mu sym(H) + lam tr(H) I, H = sum_a g_a (x) u_a."""
    ue = u_nodes[tets]  # (T,4,3) gather
    H = (grads[:, :, :, None] * ue[:, :, None, :]).sum(dim=1)  # (T,3,3)
    eps = 0.5 * (H + H.transpose(1, 2))
    tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
    sigma = 2.0 * mu * eps
    for d in range(3):
        sigma[:, d, d] += lam * tr
    fe = vols[:, None, None] * (sigma[:, None, :, :] * grads[:, :, None, :]).sum(dim=3)
    return fe.reshape(-1, 3)


def stiffness_apply_plain(grads, vols, tets, x, lam, mu, plan: IncidencePlan, free=None):
    """Plain PyTorch version of kernel D: y (N,3) = K(x * free) * free +
    x * (1 - free), or K x where `free` is None; each node's element forces
    added in the plan's order from zero."""
    u = x if free is None else x * free
    y = csr_segment_sum_plain(tet4_element_force_plain(grads, vols, tets, u, lam, mu), plan)
    return y if free is None else y * free + x * (1.0 - free)


def check_stiffness_apply_inputs(grads, vols, tets, x, plan: IncidencePlan, free) -> None:
    """Raise unless kernel D takes these inputs as they are: grads (T,4,3),
    vols (T,), x (N,3) and free (N,3) or None of one float dtype (f32 or
    f64), tets (T,4) int32 and the plan of tets.reshape(-1) over N nodes, all
    contiguous on one device, grads, tets and the plan 16-byte aligned, 4T and 3N below
    2^31 (the kernel indexes in 32 bits), and none of them wanting a gradient
    (the kernel has no backward). The plan's values are trusted."""
    floats = [t for t in (grads, vols, x, free) if t is not None]
    if x.dtype not in (torch.float32, torch.float64) or any(t.dtype != x.dtype for t in floats):
        raise TypeError(f"kernel D takes one float dtype (f32/f64), got "
                        f"{[str(t.dtype) for t in floats]}")
    if tets.dtype != torch.int32:
        raise TypeError(f"kernel D takes int32 tets, got {tets.dtype}")
    T = tets.shape[0]
    N = x.shape[0] if x.dim() == 2 else -1
    if (grads.shape != (T, 4, 3) or vols.shape != (T,) or tets.shape != (T, 4)
            or x.shape != (N, 3) or (free is not None and free.shape != (N, 3))):
        raise ValueError(f"kernel D: bad shapes grads {tuple(grads.shape)} vols "
                         f"{tuple(vols.shape)} tets {tuple(tets.shape)} x {tuple(x.shape)} free "
                         f"{None if free is None else tuple(free.shape)}")
    if plan.num_segments != N or plan.order.shape[0] != 4 * T:
        raise ValueError(f"kernel D: a plan of {plan.order.shape[0]} rows over "
                         f"{plan.num_segments} nodes against {T} tets and {N} nodes")
    tensors = [*floats, tets, plan.pos, plan.bnode, plan.bt_start, plan.btet, plan.starts]
    if any(t.device != x.device for t in tensors):
        raise ValueError("kernel D: inputs and plan lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel D takes contiguous grads, vols, tets, x and free")
    if grads.data_ptr() % 16 or tets.data_ptr() % 16 or plan.pos.data_ptr() % 16:
        raise ValueError("kernel D loads grads, tets and pos 16 bytes at a time: not aligned")
    if 4 * T >= 2**31 or 3 * N >= 2**31:
        raise ValueError("kernel D indexes in 32 bits: the arrays are too large")
    if any(wants_grad(t) for t in floats):
        raise ValueError("kernel D has no backward: a CUDA input requires_grad (the plain "
                         "version on the CPU differentiates)")


def stiffness_apply(grads, vols, tets, x, lam, mu, plan: IncidencePlan, free=None) -> torch.Tensor:
    """The gather path's operator apply in nodal (N,3) layout:
    y = K(x * free) * free + x * (1 - free), or y = K x where `free` is None,
    over `plan` (``build_incidence(tets, N)``). A CPU tensor takes
    stiffness_apply_plain; a CUDA tensor launches kernel D, one launch for the
    whole function, or raises (check_stiffness_apply_inputs). lam and mu are
    Python floats."""
    if not x.is_cuda:
        return stiffness_apply_plain(grads, vols, tets, x, lam, mu, plan, free)
    check_stiffness_apply_inputs(grads, vols, tets, x, plan, free)
    y = torch.empty_like(x)
    lib = load_kernels()
    fn = (lib.tpufem_stiffness_apply_f64 if x.dtype == torch.float64
          else lib.tpufem_stiffness_apply_f32)
    status = fn(grads.data_ptr(), vols.data_ptr(), tets.data_ptr(), plan.pos.data_ptr(),
                plan.btet.data_ptr(), plan.bt_start.data_ptr(), plan.bnode.data_ptr(),
                plan.starts.data_ptr(), x.data_ptr(), None if free is None else free.data_ptr(),
                y.data_ptr(), plan.bnode.shape[0] - 1, plan.slots, float(lam), float(mu),
                torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "stiffness_apply")
    stiffness_apply.launches += 1
    return y


stiffness_apply.launches = 0


def elastic_force(grads, vols, tets, u_nodes, lam, mu, plan: IncidencePlan) -> torch.Tensor:
    """y = K u in nodal (N,3) layout over `plan` (``build_incidence(tets, N)``)."""
    return stiffness_apply(grads, vols, tets, u_nodes, lam, mu, plan)


def stiffness_operator(grads, vols, tets, lam, mu, plan: IncidencePlan, free_mask):
    """A(x) for the BC-reduced SPD system in flat (N*3,) layout.

    Dirichlet elimination by masking: A(x) = m*K(m*x) + (1-m)*x, which keeps
    the operator SPD with unit diagonal on constrained dofs.
    """
    free3 = free_mask.reshape(-1, 3)

    def apply(x_flat):
        return stiffness_apply(grads, vols, tets, x_flat.reshape(-1, 3), lam, mu, plan,
                               free3).reshape(-1)

    return apply


def stiffness_diagonal(grads, vols, lam, mu, plan: CsrPlan, free_mask) -> torch.Tensor:
    """diag(K) (N*3,) with unit entries on constrained dofs (Jacobi).

    Per element, K_{ai,ai} = V * (lam*g_ai^2 + mu*g_ai^2 + mu*|g_a|^2),
    summed per node by kernel E.
    """
    g2 = grads**2  # (T,4,3)
    gg = g2.sum(dim=2, keepdim=True)  # |g_a|^2
    d = vols[:, None, None] * ((lam + mu) * g2 + mu * gg)  # (T,4,3)
    diag = csr_segment_sum(d.reshape(-1, 3), plan).reshape(-1)
    one = torch.ones_like(diag)
    # padded/isolated nodes also get unit diagonal so the operator stays SPD
    diag = torch.where((free_mask > 0) & (diag > 0), diag, one)
    return torch.where(free_mask > 0, diag, one)
