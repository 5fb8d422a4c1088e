"""Kernel D (``fem.assembly.stiffness_apply``, the gather path's operator) on
one CUDA card: device time per launch and device activities per operator
apply, against the byte bound.

On the DOF100K mesh of the first wing of chip_smoke.py's seeded batch
(T = 182,880 tets, N = 36,369 nodes) and on the same mesh with its nodes
renumbered by a seeded permutation (a stand-in for a user mesh, whose
numbering has no locality), in f64 and f32, with the root Dirichlet mask and
without a mask: the kernel is first held to the plain composition (1e-12
relative in f64; in f32 no worse than twice the plain f32 version's error
against f64) and to itself bit for bit, then measured in one torch.profiler
window (utils/profiling.py::device_time) of 20 repeated applies, which find
in the L2 cache what fits there, and 20 more with the L2 overwritten before
each. The window counts every device activity, so an operator that wraps its
kernel in other launches shows them. The bound is the function's own, whatever
the design: the larger of the bytes of its operands (grads, vols, tets, x and
free read once, y written once) over the card's memory rate and its arithmetic
(FLOPS_PER_TET per tet, each evaluated once, and FLOPS_PER_ENTRY per summed
row) over the card's rate outside the tensor cores (tpufem_torch/device.py).
What the kept design adds to that is reported beside it and is no part of the
bound: the bytes of the plan it reads (pos, btet, bt_start, bnode, starts) and
how often it evaluates a tet (the plan's `overlap`).

Usage: python -m tpufem_torch.profile_gather_operator [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem.bc import dirichlet_mask
from tpufem_torch.fem.elements import tet4_setup
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import DOF100K, structured_wing_mesh
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.sets import build_boundary_sets
from tpufem_torch.utils.profiling import device_time

# per evaluated tet: the mask on 12 gathered values (12), H = sum_a g_a (x)
# u_a (36 FMA: 72), sigma (24), the 4 corners' forces, three 3-term dots
# scaled by vol each (72); per incident entry one add per component (3)
FLOPS_PER_TET = 180
FLOPS_PER_ENTRY = 3


def permuted(nodes, tets, root_nodes, seed=0):
    """The same mesh with node i renumbered to perm[i], a seeded numpy
    permutation: (nodes, tets, root_nodes) in the new numbering."""
    perm = np.random.default_rng(seed).permutation(len(nodes))
    new_nodes = np.empty_like(nodes)
    new_nodes[perm] = nodes
    return new_nodes, perm[tets].astype(tets.dtype), perm[root_nodes]


def operator_inputs(nodes, tets, root_nodes, dtype, device, seed=4):
    """(grads, vols, tets, x, free, plan) as the gather-path solver hands them
    to stiffness_apply: gradients and volumes built in f64 and cast, a seeded
    random x (N,3), the root mask (N,3), the incidence plan."""
    tets_t = torch.as_tensor(np.ascontiguousarray(tets, dtype=np.int32), device=device)
    grads, vols = tet4_setup(torch.as_tensor(nodes, dtype=torch.float64, device=device), tets_t)
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(len(nodes), 3)), device=device)
    free = dirichlet_mask(len(nodes), root_nodes, dtype=dtype, device=device).reshape(-1, 3)
    plan = asm.build_incidence(tets, len(nodes), device)
    return grads.to(dtype), vols.to(dtype), tets_t, x.to(dtype), free, plan


def apply_bound(grads, vols, tets, x, free):
    """(bound in us, "bytes" or "operations") of one apply on these operands:
    every input read once, y (of x's size) written once, every tet evaluated once."""
    read = [grads, vols, tets, x] + ([] if free is None else [free])
    nbytes = sum(t.numel() * t.element_size() for t in (*read, x))
    flops = FLOPS_PER_TET * tets.shape[0] + FLOPS_PER_ENTRY * tets.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[x.dtype]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def plan_bytes(plan) -> int:
    """The bytes of the incidence plan that one launch of kernel D reads on
    top of the function's operands: the design's overhead, not in the bound."""
    return sum(t.numel() * t.element_size()
               for t in (plan.pos, plan.btet, plan.bt_start, plan.bnode, plan.starts))


def check_apply(grads, vols, tets, x, free, plan, lam, mu, ref64):
    """Kernel D on these inputs against `ref64`, the plain composition on
    their f64 originals: (max |err|, the plain version's max |err| in this
    dtype). Raises unless f64 is within 1e-12 of the largest reference value,
    f32 within twice the plain f32 error, and two applies give the same bits."""
    y = asm.stiffness_apply(grads, vols, tets, x, lam, mu, plan, free)
    torch.cuda.synchronize()
    if not torch.equal(y, asm.stiffness_apply(grads, vols, tets, x, lam, mu, plan, free)):
        raise RuntimeError("kernel D: two applies differ")
    err = (y.double() - ref64).abs().max().item()
    plain = asm.stiffness_apply_plain(grads, vols, tets, x, lam, mu, plan, free)
    err_plain = (plain.double() - ref64).abs().max().item()
    scale = ref64.abs().max().item()
    if x.dtype == torch.float64 and err > 1e-12 * scale:
        raise RuntimeError(f"kernel D f64 disagrees: {err:.3e} vs scale {scale:.3e}")
    if x.dtype == torch.float32 and err > 2.0 * err_plain:
        raise RuntimeError(f"kernel D f32 error {err:.3e} > 2x plain f32 error {err_plain:.3e}")
    return err, err_plain


def profile_apply(grads, vols, tets, x, free, plan, lam, mu):
    """Device us per kernel-D launch (repeated, and with the L2 flushed),
    launches and device activities per apply, the function's bound and the
    share of it (by the flushed time, and by the repeated time), and the
    plan's bytes read on top."""
    r = device_time(lambda: asm.stiffness_apply(grads, vols, tets, x, lam, mu, plan, free),
                    "stiffness_apply", cold=True)
    bound, by = apply_bound(grads, vols, tets, x, free)
    return {**r, "bound_us": bound, "bound_by": by, "share": bound / r["device_us_cold"],
            "share_repeated": bound / r["device_us"], "plan_bytes": plan_bytes(plan)}


def measure(label, nodes, tets, root_nodes, device, lam, mu):
    """Check and profile kernel D on one mesh: rows for f64 / f32, masked /
    unmasked."""
    rows = []
    a64 = operator_inputs(nodes, tets, root_nodes, torch.float64, device)
    for masked in (True, False):
        g64, v64, tt, x64, f64, plan = a64
        ref = asm.stiffness_apply_plain(g64, v64, tt, x64, lam, mu, plan, f64 if masked else None)
        for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
            g, v, x, fr = g64.to(dtype), v64.to(dtype), x64.to(dtype), f64.to(dtype)
            free = fr if masked else None
            err, err_plain = check_apply(g, v, tt, x, free, plan, lam, mu, ref)
            r = profile_apply(g, v, tt, x, free, plan, lam, mu)
            r.update(case=label, dtype=name, masked=masked, T=int(tt.shape[0]), N=int(x.shape[0]),
                     max_abs_err=err, plain_max_abs_err=err_plain, overlap=plan.overlap,
                     blocks=plan.bnode.numel() - 1)
            rows.append(r)
            print(f"[{label} {name} {'masked' if masked else 'unmasked'}] kernel D "
                  f"{r['device_us']:.2f} us per launch repeated, {r['device_us_cold']:.2f} us "
                  f"with the L2 flushed; bound {r['bound_us']:.2f} us ({r['bound_by']}): "
                  f"{r['share']:.1%} of the bound (flushed), {r['share_repeated']:.1%} repeated; "
                  f"{r['launches']:.0f} launch, {r['activities']:.0f} device activity per apply; "
                  f"max|err| {err:.3e} (plain {err_plain:.3e}); on top of the bound's bytes the "
                  f"plan's {r['plan_bytes'] / 1e6:.2f} MB, {r['blocks']} blocks, each tet "
                  f"evaluated {plan.overlap:.3f} times")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gather_operator: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lam, mu = lame_params(Material())
    mesh = structured_wing_mesh(*map(float, seeded_batch(8)[0]), DOF100K)
    root = build_boundary_sets(mesh).nroot_nodes
    rows = measure("DOF100K", mesh.nodes, mesh.tets, root, dev, lam, mu)
    rows += measure("DOF100K permuted", *permuted(mesh.nodes, mesh.tets, root), dev, lam, mu)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
