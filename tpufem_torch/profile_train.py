"""Where the time of one GraphSAGE training step goes, on one CUDA card.

Builds 4 DOF100K surface graphs (seeded PRD wings, structured mesh; the
stress target is seeded noise, which costs the same as a solved field),
merges them into one training batch as Trainer does (N=46,080 padded nodes,
E=275,968 padded edges) and runs full-width training steps (SAGEConfig():
dropout on, clip 1.0, AdamW): five unprofiled steps for the step seconds, then
five under torch.profiler. Prints the device's busy share of the profiled
steps, the device activities per step, the launches and device time per step
of each segment-sum entry (csrc/segment_sum.cu) and device time by op; the
full table goes to --out. --aggregate_impl picks the aggregation route.

Usage: python -m tpufem_torch.profile_train [--aggregate_impl segment|pallas] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpufem_torch.fem.driver import FemSolution, surface_results
from tpufem_torch.mesher import DOF100K, structured_wing_mesh
from tpufem_torch.models.graph import build_graph, pad_graph
from tpufem_torch.models.sage import SAGEConfig
from tpufem_torch.models.train import GraphSet, TrainConfig, Trainer
from tpufem_torch.pipeline.types import PRD_RANGES
from tpufem_torch.sets import build_boundary_sets

_NAMES = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")
STEPS = 5  # timed, and then profiled


def segment_entry(kernel_name: str) -> str | None:
    """Which entry of csrc/segment_sum.cu a device kernel's name (mangled or
    not) belongs to, or None."""
    if "row_sum_kernel" in kernel_name:
        fused = "Lb1" in kernel_name or "true" in kernel_name
        return "A(b) gather_row_sum" if fused else "A(a) sorted_segment_sum"
    for key, entry in (("segment_gather_kernel", "C segment_gather"),
                       ("segment_rowptr_kernel", "segment_rowptr")):
        if key in kernel_name:
            return entry
    return None


def seeded_graphs(n: int, seed: int = 0):
    """n DOF100K surface graphs padded to multiples of 128, as the dataset pads."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n):
        p = {k: float(rng.uniform(*PRD_RANGES[k])) for k in _NAMES}
        mesh = structured_wing_mesh(*(p[k] for k in _NAMES), DOF100K)
        sets = build_boundary_sets(mesh)
        vm = rng.uniform(1e5, 1e7, size=len(mesh.nodes))
        sol = FemSolution(u=np.zeros_like(mesh.nodes), stress6=np.zeros((len(vm), 6)), vm=vm,
                          iters=0, rel_residual=0.0, converged=True)
        faces = mesh.surf_faces[sets.surf_all_faces]
        raw.append(build_graph(surface_results(mesh, sets, sol, p["span_m"]), faces, p))
    n_max = -(-max(g.num_nodes for g in raw) // 128) * 128
    e_max = -(-max(g.num_edges for g in raw) // 128) * 128
    return [pad_graph(g, n_max, e_max) for g in raw]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--aggregate_impl", default="segment", choices=["segment", "pallas"])
    ap.add_argument("--out", default=None, help="file for the full by-op table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    trainer = Trainer(TrainConfig(clip_norm=1.0, model=SAGEConfig(aggregate_impl=args.aggregate_impl)),
                      device=dev)
    model, opt = trainer.init()
    batch = GraphSet(seeded_graphs(4), dev).batch(range(4))
    gen = torch.Generator(device=dev).manual_seed(0)

    def steps(k):
        for _ in range(k):
            trainer._train_step(model, opt, None, batch, gen)
        torch.cuda.synchronize()

    steps(2)  # warm-up: cuBLAS handles, the kernel library
    t0 = time.perf_counter()
    steps(STEPS)
    wall = (time.perf_counter() - t0) / STEPS
    print(f"[unprofiled] aggregate_impl={args.aggregate_impl}, batch N={batch.x.shape[0]} "
          f"E={batch.edge_index.shape[1]}: {wall * 1e3:.3f} ms per step (mean of {STEPS})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(STEPS)
        pwall = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev_events) / 1e6
    print(f"[profiled] {STEPS} steps in {pwall:.3f} s; device busy {busy_s:.4f} s "
          f"({busy_s / STEPS * 1e3:.3f} ms per step) in {len(dev_events)} device activities "
          f"({len(dev_events) / STEPS:.0f} per step); {busy_s / pwall:.1%} of the profiled "
          f"wall, {busy_s / (STEPS * wall):.1%} of the unprofiled wall")
    by_entry: dict[str, list[float]] = {}
    for e in dev_events:
        entry = segment_entry(e.name)
        if entry:
            by_entry.setdefault(entry, []).append(e.time_range.elapsed_us())
    for entry, us in sorted(by_entry.items()):
        print(f"[profiled] {entry}: {len(us) / STEPS:.0f} launches per step, "
              f"{sum(us) / len(us):.2f} us each, {sum(us) / STEPS:.1f} us per step "
              f"({sum(us) / (busy_s * 1e6):.1%} of device time)")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
    print("\n".join(table.splitlines()[:25]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
