"""Run a function on `world` ranks: ``run_ranks``.

tpufem's multi-device code ran as one JAX program over a device mesh (8
virtual CPU devices in its tests). The port runs one process per rank:
run_ranks spawns them (the ``spawn`` start method: a child imports the
package afresh, no JAX and no test module), they meet through a
``FileStore`` in a temporary directory (no TCP port, so concurrent test
workers never collide), each runs ``target(group, *args)`` and writes its
result, and the parent joins them against one deadline. When a rank fails
or the deadline passes every child is killed and run_ranks raises with the
failing rank's traceback, so a fault never leaves a rank waiting in a
collective for ever.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from tpufem_torch.parallel.meshes import check_backend, default_backend, make_mesh


def run_all(group, calls) -> list:
    """Run several targets in one group, in order: calls is a list of
    (function, args) or (function, args, kwargs), each function called as
    function(group, *args, **kwargs). A target for run_ranks that spares a
    spawn per case."""
    return [fn(group, *args, **(rest[0] if rest else {})) for fn, args, *rest in calls]


def kernel_counters() -> dict:
    """The launch counter of every hand-written kernel's wrapper, by the
    wrapper's name (each adds one to its `launches` where it launches)."""
    from tpufem_torch.fem import assembly, stencil, tet10, tet10_stencil
    from tpufem_torch.ops import csr_segment_sum, gather_scatter

    fns = (stencil.strain_apply, assembly.stiffness_apply, csr_segment_sum.csr_segment_sum,
           tet10_stencil.strain_apply10, tet10_stencil.prolong_p, tet10_stencil.restrict_p,
           tet10.tet10_force, gather_scatter.segment_rowptr, gather_scatter.gather_row_sum,
           gather_scatter.sorted_segment_sum, gather_scatter.segment_gather)
    return {f.__name__: f for f in fns}


def counted(group, target, *args):
    """{"out": target(group, *args), "launches": {wrapper: launches}}: the
    kernels this rank launched while `target` ran (every counter set to 0
    just before it)."""
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    out = target(group, *args)
    return {"out": out, "launches": {k: f.launches for k, f in counters.items()}}


class RankError(RuntimeError):
    """A rank of run_ranks failed or the deadline passed."""


def _child(target, rank: int, world: int, backend: str, device: str, args: tuple,
           timeout_s: float, tmp: str) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        store.set_timeout(timedelta(seconds=timeout_s))
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        group = make_mesh(world, backend, device)
        out = target(group, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".part", path)
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 -- the process boundary: the parent raises it
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)  # no exit handlers: a peer may be gone mid-collective


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    t_end = time.monotonic() + 5.0
    for p in procs:
        p.join(max(0.0, t_end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(target, world: int, backend: str | None = None, device="cuda", args=(),
              timeout_s: float = 300.0) -> list:
    """[target(group, *args) of rank 0, ..., of rank world - 1]: `target` (a
    function of the package, picklable by name) run in `world` spawned
    processes, each with its DeviceGroup (meshes.make_mesh) on `device`
    under `backend` (default: NCCL on the card, gloo on the CPU; NCCL with
    more ranks than cards raises before anything starts). A CPU child runs
    torch on one thread. Every collective times out after `timeout_s`, and
    the whole run must end within it: otherwise every child is killed and
    RankError names the rank that failed, with its traceback."""
    device = str(device)
    backend = backend or default_backend(device)
    check_backend(backend, world, device)
    tmp = tempfile.mkdtemp(prefix="tpufem_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(target, r, world, backend, device, tuple(args),
                                              timeout_s, tmp), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        if failed is not None or not all(p.exitcode == 0 for p in procs):
            _stop(procs)
            errs = {r: open(os.path.join(tmp, f"rank{r}.err")).read()
                    for r in range(world) if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
            if failed is None:
                raise RankError(f"run_ranks: {world} ranks did not finish within {timeout_s} s"
                                + "".join(f"\n--- rank {r}:\n{e}" for r, e in errs.items()))
            first = failed if failed in errs else (min(errs) if errs else failed)
            raise RankError(f"run_ranks: rank {first} of {world} failed (exit code "
                            f"{procs[first].exitcode}):\n{errs.get(first, '(no traceback)')}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
