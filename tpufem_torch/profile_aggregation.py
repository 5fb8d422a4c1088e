"""The segment-sum kernels of ``csrc/segment_sum.cu`` on one CUDA card, at the
shapes GraphSAGE gives them: each entry against its plain version, and its
times against its bound and the one PyTorch call for the same function.

For merged batches of 1, 4 and 8 padded DOF100K surface graphs (seeded wings,
as ``profile_train`` builds them; 11,520 nodes and 68,992 directed edges a
graph) and width 128 it measures the row-pointer kernel, kernel A entry (a)
(``sorted_segment_sum``, also at C=1, the degree sum), entry (b)
(``gather_row_sum``: the fused neighbour mean forward, its backward's form
over the transposed plan, and the unit-weight form over the plan's
permutation that is ``RowGather``'s backward) and kernel C
(``segment_gather``). Per entry:
max |err| against the plain f64 version (bitwise for the copies and pointers),
two runs bitwise equal, the median CUDA-event ms of one call (with launch
latency), the device us per launch from a torch.profiler window of repeated
calls (which find in the 50 MB L2 what fits there) and from a window that
overwrites the L2 before every call, the plain
version's event ms, the library call's event ms and device us, and the byte
bound (each tensor the timed launch reads counted once, each output written
once, over the card's memory rate). The share of the bound is by the flushed
device time: the repeated calls' time is beside it, and passes the bound
where the operands stay in the L2 between calls. Entry (b)'s second bound
counts the gathered rows, E x C x 4 bytes, as if every one missed the cache.
Then the full-width GraphSAGE forward under both ``aggregate_impl`` values,
and the row-pointer launches of a forward and of a training step's forward
and backward under each.

--compare LABEL=DIR ...: entry (b) as built from another csrc/ (the parent
commit's, unpacked with `git archive <rev> tpufem_torch/csrc | tar -x -C
build/parent`, or an edited copy of the port's), each a library of its own
(ops/kernels.py::compare_libraries), at its three forms and every batch,
over the same row pointers, timed the same way in turns (the compared
builds, the port's, the compared builds again), each held to the port's
bits; each build's ptxas registers of the segment-sum kernels.

Usage: python -m tpufem_torch.profile_aggregation [--out PATH] [--compare LABEL=DIR ...]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tpufem_torch.device import HBM_BYTES_PER_S
from tpufem_torch.ops import gather_scatter as gs
from tpufem_torch.ops.kernels import (
    build_info,
    check,
    compare_libraries,
    load_kernels,
    parse_compare_specs,
    ptxas_report,
)
from tpufem_torch.utils.profiling import device_time, median_event_ms

WIDTH = 128


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound_us(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e6


def _entry(fn, kernel, plain, library, n_bytes, **extra) -> dict:
    """Times of one entry: fn launches it, `plain` is its plain version and
    `library` the one PyTorch call for the same function (or None)."""
    dt = device_time(fn, kernel, cold=True)
    cold_us = dt["device_us_cold"]
    bound = _bound_us(n_bytes)
    return {"ms": median_event_ms(fn), "device_us": dt["device_us"], "device_us_cold": cold_us,
            "launches_per_call": dt["launches"], "activities_per_call": dt["activities"],
            "plain_ms": median_event_ms(plain),
            "library_ms": None if library is None else median_event_ms(library),
            "library_device_us": (None if library is None
                                  else device_time(library, "")["all_device_us"]),
            "bytes": n_bytes, "bound_us": bound, "bound_by": "bytes",
            "share": bound / cold_us, "share_repeated": bound / dt["device_us"], **extra}


def _rel_err(out, ref) -> tuple[float, float]:
    return (out.double() - ref).abs().max().item(), ref.abs().max().item()


def measure_entries(edge_index, edge_mask, num_nodes: int, seed: int = 1, tol: float = 1e-5,
                    libs=None):
    """Every entry on one graph (edge_index (2,E) int32, edge_mask (E,) on the
    card): checked against its plain version (raises on a disagreement above
    `tol` relative, or on two runs that differ), then timed. Returns
    {entry: numbers}; with `libs` ({label: library}, compare_libraries),
    entry (b)'s forms of those builds too ("b forward [label]", ...;
    compare_b)."""
    dev = edge_mask.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, E = num_nodes, edge_mask.shape[0]
    plan = gs.aggregation_plan(edge_index, edge_mask, N)
    t = plan.transposed()
    out = {}

    def require(cond, msg):
        if not cond:
            raise RuntimeError(msg)

    # the row pointers
    ref = gs.segment_rowptr_plain(plan.seg, N)
    require(torch.equal(plan.rowptr, ref) and torch.equal(
        t.rowptr, gs.segment_rowptr_plain(torch.where(t.dst < N, plan.src[t.perm.long()], N), N)),
        "segment_rowptr differs from its plain version")
    ids = torch.arange(N + 1, dtype=torch.int32, device=dev)
    out["rowptr"] = _entry(lambda: gs.segment_rowptr(plan.seg, N), "segment_rowptr_kernel",
                           lambda: gs.segment_rowptr_plain(plan.seg, N),
                           lambda: torch.searchsorted(plan.seg, ids),
                           _nbytes(plan.seg, plan.rowptr), max_abs_err=0.0)

    # entry (a): the rows of msgs themselves
    for C in (WIDTH, 1):
        msgs = torch.randn((E, C), generator=gen, device=dev)
        y = gs.sorted_segment_sum(msgs, plan.seg, N)
        err, scale = _rel_err(y, gs.sorted_segment_sum_plain(msgs.double(), plan.seg, N))
        require(err <= tol * scale, f"entry (a) C={C}: {err:.3e} vs scale {scale:.3e}")
        require(torch.equal(y, gs.sorted_segment_sum(msgs, plan.seg, N, plan.rowptr)),
                f"entry (a) C={C}: two runs differ")
        acc, seg_l = torch.zeros((N + 1, C), device=dev), plan.seg.long()
        out[f"a C={C}"] = _entry(
            lambda: gs.sorted_segment_sum(msgs, plan.seg, N, plan.rowptr), "row_sum_kernel",
            lambda: gs.sorted_segment_sum_plain(msgs, plan.seg, N),
            lambda: acc.index_add_(0, seg_l, msgs), _nbytes(msgs, plan.rowptr, y),
            max_abs_err=err, scale=scale,
            ms_with_rowptr_kernel=median_event_ms(
                lambda: gs.sorted_segment_sum(msgs, plan.seg, N)))

    # entry (b): rows gathered from the node features, forward and backward form
    h = torch.randn((N, WIDTH), generator=gen, device=dev)
    kept = int(plan.rowptr[-1])
    mean, deg = gs.gather_row_sum(h, plan.src, plan.w, plan.rowptr, normalize=True)
    ref, ref_deg = gs.gather_row_sum_plain(h.double(), plan.src, plan.w.double(), plan.rowptr,
                                           normalize=True)
    err, scale = _rel_err(mean, ref)
    require(err <= tol * scale and _rel_err(deg, ref_deg)[0] <= tol * ref_deg.abs().max().item(),
            f"entry (b): {err:.3e} vs scale {scale:.3e}")
    again = gs.gather_row_sum(h, plan.src, plan.w, plan.rowptr, normalize=True)
    require(torch.equal(mean, again[0]) and torch.equal(deg, again[1]), "entry (b): runs differ")
    # the one library call for the same function: a CSR product with the mean's weights
    vals = plan.w[:kept] / deg.clamp(min=1.0)[plan.seg[:kept].long()]
    csr = torch.sparse_csr_tensor(plan.rowptr, plan.src[:kept], vals, size=(N, N))
    out["b forward"] = _entry(
        lambda: gs.gather_row_sum(h, plan.src, plan.w, plan.rowptr, normalize=True),
        "row_sum_kernel",
        lambda: gs.gather_row_sum_plain(h, plan.src, plan.w, plan.rowptr, normalize=True),
        lambda: torch.sparse.mm(csr, h),
        _nbytes(h, plan.src, plan.w, plan.rowptr, mean, deg), max_abs_err=err, scale=scale,
        gathered_bytes=kept * WIDTH * 4, gathered_bound_us=_bound_us(kept * WIDTH * 4))

    g = torch.randn((N, WIDTH), generator=gen, device=dev)
    grad, _ = gs.gather_row_sum(g, t.dst, t.w, t.rowptr, rowdiv=deg)
    ref, _ = gs.gather_row_sum_plain(g.double(), t.dst, t.w.double(), t.rowptr,
                                     rowdiv=deg.double())
    err, scale = _rel_err(grad, ref)
    require(err <= tol * scale, f"entry (b) backward: {err:.3e} vs scale {scale:.3e}")
    require(torch.equal(grad, gs.gather_row_sum(g, t.dst, t.w, t.rowptr, rowdiv=deg)[0]),
            "entry (b) backward: runs differ")
    # the library call: the transposed CSR, each edge's weight over its destination's degree
    dst_kept = t.dst[:kept]
    csr_t = torch.sparse_csr_tensor(t.rowptr, dst_kept, t.w[:kept] / deg.clamp(min=1.0)[
        dst_kept.long()], size=(N, N))
    out["b backward"] = _entry(
        lambda: gs.gather_row_sum(g, t.dst, t.w, t.rowptr, rowdiv=deg), "row_sum_kernel",
        lambda: gs.gather_row_sum_plain(g, t.dst, t.w, t.rowptr, rowdiv=deg),
        lambda: torch.sparse.mm(csr_t, g),
        _nbytes(g, t.dst, t.w, t.rowptr, deg, grad, deg), max_abs_err=err, scale=scale,
        gathered_bytes=kept * WIDTH * 4, gathered_bound_us=_bound_us(kept * WIDTH * 4))

    # entry (b) with unit weights through the plan's permutation: RowGather's backward
    ge = torch.randn((E, WIDTH), generator=gen, device=dev)
    grad, deg_u = gs.gather_row_sum(ge, t.perm, None, t.rowptr)
    ref, _ = gs.gather_row_sum_plain(ge.double(), t.perm, None, t.rowptr)
    err, scale = _rel_err(grad, ref)
    require(err <= tol * scale, f"entry (b) unit weights: {err:.3e} vs scale {scale:.3e}")
    require(torch.equal(grad, gs.gather_row_sum(ge, t.perm, None, t.rowptr)[0]),
            "entry (b) unit weights: runs differ")
    csr_p = torch.sparse_csr_tensor(t.rowptr, t.perm[:kept], torch.ones(kept, device=dev),
                                    size=(N, E))
    out["b unit weights"] = _entry(
        lambda: gs.gather_row_sum(ge, t.perm, None, t.rowptr), "row_sum_kernel",
        lambda: gs.gather_row_sum_plain(ge, t.perm, None, t.rowptr),
        lambda: torch.sparse.mm(csr_p, ge),
        _nbytes(ge[:kept], t.perm[:kept], t.rowptr, grad, deg_u), max_abs_err=err, scale=scale)
    if libs:
        forms = {"b forward": (h, plan.src, plan.w, plan.rowptr, None, True),
                 "b backward": (g, t.dst, t.w, t.rowptr, deg, False),
                 "b unit weights": (ge, t.perm, None, t.rowptr, None, False)}
        out.update(compare_b(forms, out, libs))

    # kernel C: the cotangent's rows by sorted id
    rows = gs.segment_gather(g, plan.seg, N)
    require(torch.equal(rows, gs.segment_gather_plain(g, plan.seg, N)),
            "kernel C differs from its plain version (a copy: bitwise)")
    require(torch.equal(rows, gs.segment_gather(g, plan.seg, N)), "kernel C: runs differ")
    g_pad = torch.cat([g, torch.zeros((1, WIDTH), device=dev)])
    idx = plan.seg.long().clamp(0, N)
    out["c"] = _entry(lambda: gs.segment_gather(g, plan.seg, N), "segment_gather_kernel",
                      lambda: gs.segment_gather_plain(g, plan.seg, N),
                      lambda: torch.index_select(g_pad, 0, idx), _nbytes(g, plan.seg, rows),
                      max_abs_err=0.0)
    for v in out.values():
        v.update(N=N, E=E, kept_edges=kept)
    return out


def library_b(lib, form):
    """Entry (b) of another build on one form (gather_row_sum's arguments x,
    idx, w, rowptr, rowdiv, normalize). Returns the call, which returns (sums,
    deg)."""
    x, idx, w, rowptr, rowdiv, normalize = form
    N = rowptr.shape[0] - 1
    out = torch.empty((N, x.shape[1]), dtype=x.dtype, device=x.device)
    deg = torch.empty(N, dtype=x.dtype, device=x.device)
    args = (*(None if t is None else t.data_ptr() for t in (x, idx, w, rowdiv, rowptr)),
            out.data_ptr(), deg.data_ptr(), x.shape[0], x.shape[1], N, int(normalize))

    def call():
        check(lib.tpufem_gather_row_sum_f32(*args, torch.cuda.current_stream().cuda_stream),
              "gather_row_sum")
        return out, deg

    return call


def _timed(call) -> dict:
    dt = device_time(call, "row_sum_kernel", cold=True)
    return {"ms": median_event_ms(call), "device_us": dt["device_us"],
            "device_us_cold": dt["device_us_cold"]}


def compare_b(forms: dict, port: dict, libs: dict) -> dict:
    """Entry (b)'s forms ({name: arguments}) from each build of `libs`, timed
    in turns: the others, the port's, the others in reverse (the port's first
    reading is `port`'s, measure_entries'). Each is held to the port's bits.
    Returns {"<form> [<label>]": record}, its times lists in turn order."""
    res = {}
    for name, form in forms.items():
        want = [t.clone() for t in gs.gather_row_sum(*form)]
        others = [(label, library_b(lib, form)) for label, lib in libs.items()]
        for turn, order in ((0, others), (1, others[::-1])):
            if turn:
                res[f"{name} [port again]"] = {
                    **_timed(lambda form=form: gs.gather_row_sum(*form)),
                    "bytes": port[name]["bytes"], "bound_us": port[name]["bound_us"]}
            for who, call in order:
                got = call()
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                rec = res.setdefault(f"{name} [{who}]", {
                    "equals_port": same, "bytes": port[name]["bytes"],
                    "bound_us": port[name]["bound_us"], "ms": [], "device_us": [],
                    "device_us_cold": []})
                rec["equals_port"] &= same
                for k, v in _timed(call).items():
                    rec[k].append(v)
    return res


def compare_line(label: str, name: str, v: dict) -> str:
    if "equals_port" not in v:  # the port's second turn
        return (f"[{label}] {name}: device {v['device_us']:.2f} us repeated, "
                f"{v['device_us_cold']:.2f} us flushed ({v['bound_us'] / v['device_us_cold']:.1%} "
                f"of the bound); event {v['ms']:.4f} ms")
    times = lambda k, f: " / ".join(f"{t:{f}}" for t in v[k])  # noqa: E731
    return (f"[{label}] {name}: the port's bits {v['equals_port']}; device "
            f"{times('device_us', '.2f')} us repeated, {times('device_us_cold', '.2f')} us "
            f"flushed ({v['bound_us'] / min(v['device_us_cold']):.1%} of the bound at best); "
            f"event {times('ms', '.4f')} ms (turns 0 / 1)")


def rowptr_launches(model, b) -> dict:
    """segment_rowptr's launches in a forward without grad (inference) and
    in a training step's forward and backward, on merged batch `b`."""
    out = {}
    for what in ("inference", "training step"):
        gs.segment_rowptr.launches = 0
        with torch.set_grad_enabled(what != "inference"):
            y = model(b.x, b.edge_index, b.edge_mask)
            if what != "inference":
                y.square().mean().backward()
        torch.cuda.synchronize()
        out[what] = gs.segment_rowptr.launches
    return out


def entry_line(label: str, name: str, v: dict) -> str:
    lib = ("none" if v["library_ms"] is None
           else f"{v['library_ms']:.4f} ms ({v['library_device_us']:.2f} us of device time)")
    extra = (f"; gathered rows {v['gathered_bytes'] / 1e6:.1f} MB = "
             f"{v['gathered_bound_us']:.2f} us" if "gathered_bytes" in v else "")
    return (f"[{label}] {name}: max|err| {v['max_abs_err']:.3e}; event {v['ms']:.4f} ms, device "
            f"{v['device_us']:.2f} us per launch ({v['device_us_cold']:.2f} us with the L2 "
            f"flushed before it), plain {v['plain_ms']:.4f} ms, library {lib}; bound "
            f"{v['bytes'] / 1e6:.1f} MB = {v['bound_us']:.2f} us: {v['share']:.1%} of the bound "
            f"flushed ({v['share_repeated']:.1%} repeated){extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the results as JSON lines")
    ap.add_argument("--compare", nargs="*", default=[], metavar="LABEL=DIR",
                    help="also time entry (b) as built from each csrc/ DIR, in turns with the "
                         "port's")
    args = ap.parse_args(argv)
    parse_compare_specs(args.compare)  # a malformed spec raises before anything is built
    if not torch.cuda.is_available():
        print("profile_aggregation: no CUDA device", file=sys.stderr)
        return 2
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
    from tpufem_torch.models.train import GraphSet
    from tpufem_torch.profile_train import seeded_graphs

    dev = torch.device("cuda")
    load_kernels()
    libs = compare_libraries(args.compare)
    for lab, log in (("port", build_info.get("log", "")),
                     *((lab, lib.build_info.get("log", "")) for lab, lib in libs.items())):
        rep = {k: v for k, v in ptxas_report(log).items() if "segment" in k or "row_sum" in k}
        print(f"[ptxas {lab}] " + "; ".join(f"{k}: {r} registers, {ss} / {sl} B spilled"
                                            for k, (r, ss, sl) in sorted(rep.items())))
    gset = GraphSet(seeded_graphs(8), dev)
    rows = []
    for n in (1, 4, 8):
        b = gset.batch(range(n))
        label = f"{n} graph{'s' if n > 1 else ''}"
        for name, v in measure_entries(b.edge_index, b.edge_mask, b.x.shape[0],
                                       libs=libs).items():
            print(entry_line(label, name, v) if "[" not in name else compare_line(label, name, v))
            rows.append({"graphs": n, "entry": name, **v})
        for impl in ("segment", "pallas"):
            model = GraphSAGE(SAGEConfig(aggregate_impl=impl),
                              generator=torch.Generator().manual_seed(0), device=dev).eval()
            with torch.no_grad():
                ms = median_event_ms(lambda: model(b.x, b.edge_index, b.edge_mask))
            rowptrs = rowptr_launches(model, b)
            print(f"[{label}] GraphSAGE forward, aggregate_impl={impl}: {ms:.4f} ms; "
                  f"segment_rowptr launches: {rowptrs}")
            rows.append({"graphs": n, "entry": f"forward {impl}", "ms": ms,
                         "rowptr_launches": rowptrs})
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
