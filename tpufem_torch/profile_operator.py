"""Kernel B (``fem.stencil.strain_apply``) on one CUDA card: device time per
launch and device activities per operator apply, against the byte bound.

At every V-cycle level of DOF100K that applies the operator (64x80x6,
32x40x3, 16x20x3, 8x10x3) and at MEDIUM (32x24x4, sharp TE), in f64 and f32,
on chip_smoke.py's seeded batch of 8: each measurement is a short
torch.profiler window of 20 applies after a warm-up
(utils/profiling.py::device_time). It reads the kernel's own device time (the
rows whose name holds "strain_apply") and counts every device activity in the
window, so an operator that wraps its kernel in other launches shows them.
The bound is the larger of the bytes each apply must move (g, vol, u and free
read once, y written once) over the card's memory rate and its arithmetic
(FLOPS_PER_TET per Kuhn tet) over the card's rate outside the tensor cores
(the rates are in tpufem_torch/device.py). The window goes on with 20 more
applies, the L2 flushed before each (``device_us_cold``).

--compare LABEL=DIR ...: kernel B as built from another csrc/ (the parent
commit's, unpacked with `git archive <rev> tpufem_torch/csrc | tar -x -C
build/parent`) is timed the same way at every case, before and after the
port's own, into a library of its own (ops/kernels.py::compare_libraries),
and its result is held to the port's bit for bit.

Usage: python -m tpufem_torch.profile_operator [--out PATH] [--compare LABEL=DIR ...]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tpufem_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from tpufem_torch.fem import stencil as st
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
from tpufem_torch.mesher import DOF100K, MEDIUM
from tpufem_torch.ops.kernels import check, compare_libraries
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.utils.profiling import device_time

BATCH = 8  # the seeded batch chip_smoke.py and profile_solve solve
# per tet: H = sum_a g_a (x) u_a (36 FMA), sigma * vol (~36), 4 corner forces
# sigma . g_a (60)
FLOPS_PER_TET = 170


def operator_inputs(res, p4, dtype, device, seed=0):
    """(geo, u, free) as the solver hands them to strain_apply: cell geometry
    of the batch p4 (B,4) built in f64 and cast, a seeded random u, the root
    mask."""
    X = st.nodes_grid(res, torch.as_tensor(p4, device=device), torch.float64)
    geo = tuple(t.to(dtype) for t in st.cell_geometry(res, X))
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(X.shape, generator=gen, dtype=torch.float64, device=device).to(dtype)
    free = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=dtype, device=device)
    free[..., 0] = 0.0
    return geo, u, free


def apply_bound(geo, u, free):
    """(bound in us, "bytes" or "operations") of one apply on these inputs."""
    g, vol = geo
    # inputs g, vol, u, free read once; y (u's shape) written once
    nbytes = sum(t.numel() * t.element_size() for t in (g, vol, u, free, u))
    flops = FLOPS_PER_TET * vol.numel()  # vol holds one entry per (tet, case, cell)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[u.dtype]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def profile_apply(res, geo, u, free, lam, mu, fn=None):
    """Device us per kernel-B launch (repeated, and with the L2 flushed) and
    device activities per apply, from one torch.profiler window of 20 + 20
    applies (after one warm-up). fn: the apply to time (default the port's
    strain_apply on these operands)."""
    fn = fn or (lambda: st.strain_apply(res, geo, u, free, lam, mu))
    r = device_time(fn, "strain_apply", cold=True)
    bound, by = apply_bound(geo, u, free)
    return {"device_us": r["device_us"], "device_us_cold": r["device_us_cold"],
            "launches": r["launches"], "activities_per_apply": r["activities"],
            "wrapper_device_us": r["all_device_us"], "bound_us": bound, "bound_by": by,
            "share": bound / r["device_us"], "share_cold": bound / r["device_us_cold"]}


def library_strain_apply(lib, res, geo, u, free, lam, mu):
    """strain_apply through another build of the kernels (--compare): the
    wrapper's launch without its operand checks and launch counter."""
    g, vol = geo
    _, B, NI, NK, NJ = u.shape
    y = torch.empty_like(u)
    fn = lib.tpufem_strain_apply_f64 if u.dtype == torch.float64 else lib.tpufem_strain_apply_f32
    args = (g.data_ptr(), vol.data_ptr(), u.data_ptr(), free.data_ptr(), y.data_ptr(), B, NI, NK,
            NJ, int(res.te_floor_frac == 0.0), float(lam), float(mu))

    def call():
        check(fn(*args, torch.cuda.current_stream(u.device).cuda_stream), "strain_apply")
        return y

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time kernel B as built from each csrc/ DIR, in turns with the "
                         "port's own")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_operator: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = compare_libraries(args.compare)
    lam, mu = lame_params(Material())
    p4 = seeded_batch(BATCH)
    cases = [(f"DOF100K level {i}", r) for i, r in enumerate(hierarchy_resolutions(DOF100K)[:-1])]
    cases.append(("MEDIUM", MEDIUM))
    rows = []
    for label, res in cases:
        for dtype in (torch.float64, torch.float32):
            geo, u, free = operator_inputs(res, p4, dtype, dev)
            y_port = st.strain_apply(res, geo, u, free, lam, mu).clone()
            # in turns: the compared builds, the port's kernel, the compared builds again
            order = [*libs, None, *reversed(libs)]
            for n, lab in enumerate(order):
                fn = None if lab is None else library_strain_apply(libs[lab], res, geo, u, free,
                                                                   lam, mu)
                r = profile_apply(res, geo, u, free, lam, mu, fn)
                r.update(case=label, grid=res.key, batch=BATCH, dtype=str(dtype),
                         library=lab or "port", turn=int(n > len(libs)))
                same = "" if fn is None else f"; the port's bits: {torch.equal(fn(), y_port)}"
                rows.append(r)
                print(f"[{label} {res.key} B={BATCH} {dtype}] kernel B ({r['library']}) "
                      f"{r['device_us']:.2f} us per launch repeated, {r['device_us_cold']:.2f} "
                      f"us L2 flushed, bound {r['bound_us']:.2f} us ({r['bound_by']}): "
                      f"{r['share']:.1%} / {r['share_cold']:.1%} of the bound; "
                      f"{r['activities_per_apply']:.0f} device activities per apply, "
                      f"{r['wrapper_device_us']:.2f} us of device time{same}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
